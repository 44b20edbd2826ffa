"""Counter-based random bits of the JAX engine's sampler, in torch.

Stands for the parts of ``jax.random`` that
``bigdl_tpu/serving/engine.py::_device_sample_rows`` and
``bigdl_tpu/generation.py`` use with the default threefry PRNG
(``jax_threefry_partitionable`` on, as in JAX 0.9): ``PRNGKey(seed)``,
``fold_in(key, pos)``, ``split(key)``, ``gumbel(key, (n,), f32)`` and
``categorical(key, logits)``. The bits are the same; the two logs of the
gumbel transform may differ from XLA's by one f32 ulp, so a draw whose
two best perturbed logits lie within that ulp may pick the other token.

Words are int64 tensors holding 32-bit values (torch has no full uint32
arithmetic on CUDA): every sum is masked back to 32 bits. A key is a pair
``(k0, k1)`` of such tensors (or ints), broadcast against the counters,
so one call serves a batch of keys.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

Word = Union[int, torch.Tensor]
Key = Tuple[Word, Word]

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(key: Key, x0: Word, x1: Word
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 with 20 rounds (Salmon et al.; the block function of
    ``jax.random``'s default PRNG) of the counter pair (x0, x1) under
    `key`. All operands broadcast; returns two int64 tensors of 32-bit
    words."""
    k0, k1 = (torch.as_tensor(k, dtype=torch.int64) & _M32 for k in key)
    # counters given as tensors keep their device (a host key drawing a
    # device-sized block); otherwise the key's device
    dev = next((x.device for x in (x0, x1) if isinstance(x, torch.Tensor)),
               k0.device)
    k0, k1 = k0.to(dev), k1.to(dev)
    x0 = torch.as_tensor(x0, dtype=torch.int64, device=dev)
    x1 = torch.as_tensor(x1, dtype=torch.int64, device=dev)
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seed: Word) -> Key:
    """``jax.random.PRNGKey(seed)`` for a seed in [0, 2**32): (0, seed)."""
    s = torch.as_tensor(seed, dtype=torch.int64) & _M32
    return torch.zeros_like(s), s


def fold_in(key: Key, data: Word) -> Key:
    """``jax.random.fold_in``: the threefry block of the counter
    (0, data) under `key` is the new key."""
    d = torch.as_tensor(data, dtype=torch.int64) & _M32
    return threefry2x32(key, torch.zeros_like(d), d)


def split(key: Key, num: int = 2):
    """``jax.random.split(key, num)`` (partitionable): key i is the
    threefry block of the counter (0, i). Returns `num` keys of Python
    ints: a key's chain is followed on the host."""
    i = torch.arange(num, dtype=torch.int64)
    b1, b2 = threefry2x32(tuple(int(w) for w in key), torch.zeros_like(i), i)
    return [(int(b1[j]), int(b2[j])) for j in range(num)]


def uniform_bits(key: Key, n: int, device=None) -> torch.Tensor:
    """``n`` 32-bit words per key, as ``jax.random.bits`` draws them
    partitionably: counters (0, i) for i < n (n < 2**32), output word 1
    xor word 2. Keys of shape [B, 1] give [B, n]; a key of Python ints
    draws on `device`. An [R, C] draw is the first R * C words in row
    order: the counters are the flattened index."""
    k0 = torch.as_tensor(key[0], dtype=torch.int64)
    i = torch.arange(n, dtype=torch.int64, device=device or k0.device)
    b1, b2 = threefry2x32(key, torch.zeros_like(i), i)
    return b1 ^ b2


def uniform(key: Key, n: int, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, (n,), float32, minval=tiny, maxval=1)``:
    the top 23 bits as a mantissa in [1, 2), minus 1, scaled into
    [tiny, 1) in f32."""
    bits = uniform_bits(key, n, device)
    f = (((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32)
         - 1.0)
    tiny = torch.finfo(torch.float32).tiny
    # maxval - minval = 1 - tiny rounds to 1.0 in f32: the scale is f + tiny
    return torch.clamp(f + tiny, min=tiny)


def gumbel(key: Key, n: int, device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,), float32)``: -log(-log(u))."""
    return -torch.log(-torch.log(uniform(key, n, device)))


def categorical(key: Key, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(key, logits, axis=-1)`` over [B, V] f32
    logits: argmax of logits plus the gumbel noise of shape [B, V] (one
    draw of B * V words, not B draws of V). Returns int64 [B]."""
    b, v = logits.shape
    g = gumbel(key, b * v, logits.device).reshape(b, v)
    return torch.argmax(g + logits, dim=-1)
