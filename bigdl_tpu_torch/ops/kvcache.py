"""Static-shape slab KV cache with low-bit storage (counterpart of
``bigdl_tpu/ops/kvcache.py``: ``KVCache``, ``init_cache``,
``quantize_kv``, ``update_layer``, ``read_layer``, byte counts).

Layout [num_layers, batch, max_seq, kv_heads, head_dim]. Storage kinds
(``kv_cache_dtype``), as in the JAX package:

==========  =============================================================
bf16        plain bfloat16 (default)
fp8_e5m2    scale-free ``torch.float8_e5m2``; the attention kernels upcast
            the codes in-register (e5m2 -> bf16 is exact)
int8        symmetric int8 codes + per-(token, head) f32 scales
int4        symmetric 4-bit codes + scales, **packed** two to a byte:
            uint8 [.., head_dim / 2], byte i holds dim 2i in its low
            nibble and dim 2i + 1 in its high nibble (two's complement),
            so the storage bytes equal the JAX package's count
==========  =============================================================

int8/int4 quantize on append: each written [head_dim] vector gets one
absmax scale (``quantize_kv``), so appends at unaligned positions never
re-quantize neighbours. The scales live in separate f32 planes
``k_scale``/``v_scale`` [L, B, S, Hkv] (None for the scale-free kinds).

Unlike the JAX package, ``update_layer`` writes into the cache tensors in
place (the buffers are preallocated once and never copied); it returns
them for symmetry with the reference. A write offset past ``max_seq -
S_new`` is clamped to it, exactly as ``lax.dynamic_update_slice`` clamps:
the engine decodes every slot each step, so an idle slot's position keeps
growing and its writes must land inside the cache (at the end) instead of
faulting.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional, Tuple

import torch

# canonical kv_cache_dtype names -> storage dtypes (int4: packed bytes)
KV_CACHE_DTYPES = {
    "bf16": torch.bfloat16,
    "fp8_e5m2": torch.float8_e5m2,
    "int8": torch.int8,
    "int4": torch.uint8,
}
# kinds that carry per-(token, head) scale planes
SCALED_KV_DTYPES = ("int8", "int4")
_KV_QMAX = {"int8": 127.0, "int4": 7.0}
_DTYPE_ALIASES = {"bfloat16": "bf16", "fp8": "fp8_e5m2",
                  "float8_e5m2": "fp8_e5m2", "e5m2": "fp8_e5m2"}

_warned_quantized_alias = False


def resolve_kv_cache_dtype(spec, default: str = "bf16") -> str:
    """Normalize a kv-cache dtype spec to a canonical name: the canonical
    strings and their aliases, None (-> default), and the deprecated
    boolean alias (True -> "fp8_e5m2", warned once per process; False ->
    default)."""
    global _warned_quantized_alias
    if spec is None:
        return default
    if isinstance(spec, bool):
        if spec:
            if not _warned_quantized_alias:
                _warned_quantized_alias = True
                warnings.warn(
                    "quantize_kv_cache/kv_quantized=True is deprecated; "
                    "use kv_cache_dtype='fp8_e5m2' (or 'int8'/'int4' for "
                    "block-scaled storage)", DeprecationWarning,
                    stacklevel=3)
            return "fp8_e5m2"
        return default
    s = str(spec).strip().lower()
    s = _DTYPE_ALIASES.get(s, s)
    if s not in KV_CACHE_DTYPES:
        raise ValueError(f"unknown kv_cache_dtype {spec!r}; choose from "
                         f"{sorted(KV_CACHE_DTYPES)}")
    return s


def reject_scaled_kv(spec, family: str) -> None:
    """Guard for model families whose forward does not thread the
    int8/int4 scale planes."""
    if resolve_kv_cache_dtype(spec) in SCALED_KV_DTYPES:
        raise NotImplementedError(
            f"kv_cache_dtype int8/int4 is not supported by the {family} "
            f"family (its forward does not carry the scale planes); use "
            f"'bf16' or 'fp8_e5m2'")


def kv_dtype_name(storage_dtype: torch.dtype) -> str:
    """Canonical name of a cache storage dtype (uint8 is packed int4)."""
    for name, d in KV_CACHE_DTYPES.items():
        if d == storage_dtype:
            return name
    raise ValueError(f"{storage_dtype} is not a KV cache storage dtype")


@dataclasses.dataclass
class KVCache:
    k: torch.Tensor     # [L, B, S_max, H_kv, D] storage (int4: D / 2 bytes)
    v: torch.Tensor
    pos: torch.Tensor   # int32 scalar, or [B] per-slot positions
    # per-(token, head) f32 scales of int8/int4 codes, else None
    k_scale: Optional[torch.Tensor] = None   # [L, B, S_max, H_kv]
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_seq(self) -> int:
        return self.k.shape[2]

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def kv_dtype(self) -> str:
        return kv_dtype_name(self.k.dtype)

    def reset_pos(self, pos) -> "KVCache":
        """Same buffers, new validity pointer."""
        return KVCache(self.k, self.v, pos, self.k_scale, self.v_scale)


def _storage(name: str, shape, device):
    """Zeroed code planes (int4 packs the last dim) and, for the scaled
    kinds, zeroed f32 scale planes of ``shape[:-1]``."""
    cshape = tuple(shape)
    if name == "int4":
        if shape[-1] % 2:
            raise ValueError(f"int4 KV storage needs an even head_dim, got "
                             f"{shape[-1]}")
        cshape = cshape[:-1] + (shape[-1] // 2,)
    dt = KV_CACHE_DTYPES[name]
    k = torch.zeros(cshape, dtype=dt, device=device)
    v = torch.zeros(cshape, dtype=dt, device=device)
    if name not in SCALED_KV_DTYPES:
        return k, v, None, None
    return (k, v, torch.zeros(shape[:-1], dtype=torch.float32, device=device),
            torch.zeros(shape[:-1], dtype=torch.float32, device=device))


def init_cache(num_layers: int, batch: int, max_seq: int, kv_heads: int,
               head_dim: int, dtype=torch.bfloat16, per_slot_pos=False,
               device="cuda", kv_cache_dtype: Optional[str] = None
               ) -> KVCache:
    """Allocate an empty cache (zeros). `kv_cache_dtype` picks the
    storage ("bf16" | "fp8_e5m2" | "int8" | "int4"); `dtype` is the
    compute dtype, bf16 only. per_slot_pos=True gives every batch row its
    own position counter (continuous batching)."""
    if dtype != torch.bfloat16:
        raise NotImplementedError("the port computes attention in bf16; "
                                  "pick the storage with kv_cache_dtype")
    name = resolve_kv_cache_dtype(kv_cache_dtype)
    k, v, ks, vs = _storage(name, (num_layers, batch, max_seq, kv_heads,
                                   head_dim), device)
    pos = (torch.zeros((batch,), dtype=torch.int32, device=device)
           if per_slot_pos else torch.zeros((), dtype=torch.int32,
                                            device=device))
    return KVCache(k, v, pos, ks, vs)


def pack_int4(codes: torch.Tensor) -> torch.Tensor:
    """int codes in [-8, 7], [.., D] (D even) -> uint8 [.., D / 2]: dim 2i
    in the low nibble of byte i, dim 2i + 1 in its high nibble."""
    c = codes.to(torch.int16) & 0xF
    return (c[..., 0::2] | (c[..., 1::2] << 4)).to(torch.uint8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """uint8 [.., D / 2] -> int8 codes [.., D] (inverse of pack_int4)."""
    p = packed.to(torch.int16)
    lo, hi = p & 0xF, (p >> 4) & 0xF
    codes = torch.stack([lo, hi], dim=-1).flatten(-2)
    return (codes - ((codes & 8) << 1)).to(torch.int8)


def quantize_kv(x: torch.Tensor, name: str
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric absmax quantization of the trailing [D] vectors to
    "int8" or "int4" (packed): (codes, f32 scales of x.shape[:-1]). Zero
    vectors get scale 0 and zero codes. The arithmetic is the JAX
    package's step by step (f32; round half to even), so codes and scales
    are its bits."""
    qmax = _KV_QMAX[name]
    xf = x.to(torch.float32)
    scale = xf.abs().amax(dim=-1) / qmax
    inv = torch.where(scale > 0, 1.0 / torch.clamp(scale, min=1e-30),
                      torch.zeros_like(scale))
    codes = torch.clamp(torch.round(xf * inv[..., None]), -qmax, qmax)
    codes = codes.to(torch.int8)
    return (pack_int4(codes) if name == "int4" else codes), scale


def dequantize_kv(codes: torch.Tensor, scale: Optional[torch.Tensor],
                  compute_dtype=torch.bfloat16) -> torch.Tensor:
    """Codes [.., D] (int4 packed; times scale [..] for int8/int4, in
    f32) -> compute_dtype; scale-free storage is upcast."""
    if scale is None:
        return codes.to(compute_dtype)
    if codes.dtype == torch.uint8:
        codes = unpack_int4(codes)
    return (codes.to(torch.float32)
            * scale[..., None].to(torch.float32)).to(compute_dtype)


def _write_rows(pos: torch.Tensor, s_new: int, s_max: int) -> torch.Tensor:
    """Row indices a write of s_new rows at `pos` covers, with the start
    clamped to [0, s_max - s_new] (scalar pos -> [S_new], [B] ->
    [B, S_new])."""
    start = torch.clamp(pos.to(torch.int64), 0, s_max - s_new)
    return start[..., None] + torch.arange(s_new, device=pos.device)


def to_storage(k_new: torch.Tensor, v_new: torch.Tensor,
               storage: torch.dtype, scaled: bool):
    """New K/V rows -> (k codes, v codes, k scales, v scales): quantized
    for the scaled kinds (scales None otherwise), else cast."""
    if scaled:
        name = kv_dtype_name(storage)
        kc, ks = quantize_kv(k_new, name)
        vc, vs = quantize_kv(v_new, name)
        return kc, vc, ks, vs
    return k_new.to(storage), v_new.to(storage), None, None


def raw_view(t: torch.Tensor) -> torch.Tensor:
    """fp8 planes as their bytes (CPU torch indexes no float8 plane in
    place); other planes as they are."""
    return t.view(torch.uint8) if t.dtype == torch.float8_e5m2 else t


def update_layer(cache_k: torch.Tensor, cache_v: torch.Tensor, layer: int,
                 k_new: torch.Tensor, v_new: torch.Tensor,
                 pos: torch.Tensor, cache_ks: Optional[torch.Tensor] = None,
                 cache_vs: Optional[torch.Tensor] = None):
    """Write k_new/v_new [B, S_new, H_kv, D] into layer `layer` at sequence
    offset `pos` (scalar, or [B] per-slot offsets), in place. With scale
    planes (int8/int4) the rows are quantized on append and the 4-tuple
    (ck, cv, cks, cvs) is returned, else (ck, cv)."""
    s_new, s_max = k_new.shape[1], cache_k.shape[2]
    if s_new > s_max:
        raise ValueError(f"write of {s_new} rows exceeds max_seq {s_max}")
    scaled = cache_ks is not None
    kc, vc, ks, vs = to_storage(k_new, v_new, cache_k.dtype, scaled)
    pos = torch.as_tensor(pos, device=cache_k.device)
    rows = _write_rows(pos, s_new, s_max)
    planes = [(cache_k, kc), (cache_v, vc)]
    if scaled:
        planes += [(cache_ks, ks), (cache_vs, vs)]
    for plane, new in planes:
        pl, new = raw_view(plane)[layer], raw_view(new)   # [B, S, ...]
        if pos.dim() == 1:
            bidx = torch.arange(pl.shape[0], device=pl.device)[:, None]
            pl[bidx, rows] = new
        else:
            pl.index_copy_(1, rows, new)
    if scaled:
        return cache_k, cache_v, cache_ks, cache_vs
    return cache_k, cache_v


def read_layer(cache_k: torch.Tensor, cache_v: torch.Tensor, layer: int,
               compute_dtype=torch.bfloat16,
               cache_ks: Optional[torch.Tensor] = None,
               cache_vs: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-length K/V [B, S_max, H_kv, D] of one layer in compute_dtype:
    dequantized when scale planes are given, else upcast (views when the
    storage is already compute_dtype)."""
    ks = None if cache_ks is None else cache_ks[layer]
    vs = None if cache_vs is None else cache_vs[layer]
    return (dequantize_kv(cache_k[layer], ks, compute_dtype),
            dequantize_kv(cache_v[layer], vs, compute_dtype))


def read_layer_quantized(cache_k: torch.Tensor, cache_v: torch.Tensor,
                         cache_ks: torch.Tensor, cache_vs: torch.Tensor,
                         layer: int):
    """One layer's raw codes and scales (views, no dequantization): the
    operands of ``sdp_attention(.., k_scale=, v_scale=)``."""
    return cache_k[layer], cache_v[layer], cache_ks[layer], cache_vs[layer]


def kv_cache_nbytes(num_layers: int, batch: int, max_seq: int,
                    kv_heads: int, head_dim: int,
                    kv_cache_dtype: Optional[str] = None) -> Dict[str, int]:
    """Storage of a would-be cache without allocating it; equal to
    ``kv_cache_bytes(init_cache(...))`` and to the JAX package's count
    (int4 at two codes a byte)."""
    name = resolve_kv_cache_dtype(kv_cache_dtype)
    n = num_layers * batch * max_seq * kv_heads * head_dim
    if name == "int4":
        codes = 2 * (-(-n // 2))
    else:
        codes = 2 * n * KV_CACHE_DTYPES[name].itemsize
    scales = 0
    if name in SCALED_KV_DTYPES:
        scales = 2 * num_layers * batch * max_seq * kv_heads * 4
    return {"codes": codes, "scales": scales, "total": codes + scales}


def _planes_bytes(cache) -> Dict[str, int]:
    def nb(t):
        return 0 if t is None else t.numel() * t.element_size()

    codes = nb(cache.k) + nb(cache.v)
    scales = nb(cache.k_scale) + nb(cache.v_scale)
    return {"codes": codes, "scales": scales, "total": codes + scales}


def kv_cache_bytes(cache: KVCache) -> Dict[str, int]:
    """Storage of a live cache: codes planes, scale planes, total."""
    return _planes_bytes(cache)
