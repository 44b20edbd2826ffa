"""Static-shape slab KV cache, bf16 storage (counterpart of
``bigdl_tpu/ops/kvcache.py``: ``KVCache``, ``init_cache``,
``update_layer``, ``read_layer``).

Layout [num_layers, batch, max_seq, kv_heads, head_dim]. Unlike the JAX
package, ``update_layer`` writes into the cache tensors in place (the
buffers are preallocated once and never copied); it returns them for
symmetry with the reference.

A write offset past ``max_seq - S_new`` is clamped to it, exactly as
``lax.dynamic_update_slice`` clamps: the engine decodes every slot each
step, so an idle slot's position keeps growing and its writes must land
inside the cache (at the end) instead of faulting.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor     # [L, B, S_max, H_kv, D] bf16
    v: torch.Tensor
    pos: torch.Tensor   # int32 scalar, or [B] per-slot positions

    @property
    def max_seq(self) -> int:
        return self.k.shape[2]

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]


def init_cache(num_layers: int, batch: int, max_seq: int, kv_heads: int,
               head_dim: int, dtype=torch.bfloat16, per_slot_pos=False,
               device="cuda") -> KVCache:
    """Allocate an empty cache (zeros). per_slot_pos=True gives every
    batch row its own position counter (continuous batching)."""
    if dtype != torch.bfloat16:
        raise NotImplementedError("the port's KV cache stores bf16 only; "
                                  "fp8/int8/int4 storage is not ported yet")
    shape = (num_layers, batch, max_seq, kv_heads, head_dim)
    pos = (torch.zeros((batch,), dtype=torch.int32, device=device)
           if per_slot_pos else torch.zeros((), dtype=torch.int32,
                                            device=device))
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device), pos)


def _write_rows(pos: torch.Tensor, s_new: int, s_max: int) -> torch.Tensor:
    """Row indices a write of s_new rows at `pos` covers, with the start
    clamped to [0, s_max - s_new] (scalar pos -> [S_new], [B] -> [B, S_new])."""
    start = torch.clamp(pos.to(torch.int64), 0, s_max - s_new)
    return start[..., None] + torch.arange(s_new, device=pos.device)


def update_layer(cache_k: torch.Tensor, cache_v: torch.Tensor, layer: int,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write k_new/v_new [B, S_new, H_kv, D] into layer `layer` at sequence
    offset `pos` (scalar, or [B] per-slot offsets), in place."""
    s_new, s_max = k_new.shape[1], cache_k.shape[2]
    if s_new > s_max:
        raise ValueError(f"write of {s_new} rows exceeds max_seq {s_max}")
    pos = torch.as_tensor(pos, device=cache_k.device)
    rows = _write_rows(pos, s_new, s_max)
    ck, cv = cache_k[layer], cache_v[layer]            # [B, S, H, D] views
    if pos.dim() == 1:
        bidx = torch.arange(ck.shape[0], device=ck.device)[:, None]
        ck[bidx, rows] = k_new.to(ck.dtype)
        cv[bidx, rows] = v_new.to(cv.dtype)
    else:
        ck.index_copy_(1, rows, k_new.to(ck.dtype))
        cv.index_copy_(1, rows, v_new.to(cv.dtype))
    return cache_k, cache_v


def read_layer(cache_k: torch.Tensor, cache_v: torch.Tensor, layer: int,
               compute_dtype=torch.bfloat16
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-length K/V [B, S_max, H_kv, D] of one layer (views when the
    storage is already compute_dtype)."""
    return (cache_k[layer].to(compute_dtype),
            cache_v[layer].to(compute_dtype))
