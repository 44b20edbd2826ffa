"""Paged KV cache: one page arena per layer + per-sequence block tables
(counterpart of ``bigdl_tpu/ops/paged.py``).

The slab cache (``ops/kvcache.py``) reserves ``[L, max_batch, max_seq,
Hkv, hd]`` up front. Here the per-slot axis becomes a pooled one: one
``[L, num_pages, page_size, Hkv, hd]`` arena per K/V plane and an int32
**block table** per sequence mapping logical page -> physical page. Pages
are refcounted and shared copy-on-write by the radix tree in
``serving/pagepool.py``.

- The arena never reallocates; appends scatter through the block table,
  in place (the JAX package returns new arrays; the buffers here are
  written where they lie, like the port's ``update_layer``).
- Block tables are dense ``[B, NP]`` with ``NP = max_seq // page_size``;
  unallocated logical pages map to **page 0**, the reserved null page.
  Out-of-range or padded writes land there and out-of-range reads gather
  it; both only touch positions attention masks out (key j > pos).
- The dense gather ``arena[block_tables]`` is exactly the ``[B, max_seq,
  Hkv, hd]`` view the slab reads, which makes paged decode byte-identical
  to slab decode.

Storage kinds are the slab's (``kv_cache_dtype``: bf16, fp8_e5m2, int8,
int4 packed two codes a byte). int8/int4 arenas carry f32 scale planes
``[L, P, page_size, Hkv]`` that move wherever their codes move; appends
make the slab's ``quantize_kv`` call, so codes and scales equal the
slab's bit for bit. The metrics publisher is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

from bigdl_tpu_torch.ops.kvcache import (_planes_bytes, _storage,
                                         dequantize_kv, kv_cache_nbytes,
                                         kv_dtype_name, raw_view,
                                         resolve_kv_cache_dtype, to_storage)

#: physical page 0 is never handed out: it is the write sink for padded /
#: out-of-range positions and the gather source for unallocated logical
#: pages. Its contents are garbage by design; attention masks every
#: position that could read it.
NULL_PAGE = 0


@dataclasses.dataclass
class PagedKVCache:
    """Page-arena KV storage. Block tables are not part of it: they are
    host-owned scheduling state passed beside it as a ``[B, NP]``
    operand."""

    k: torch.Tensor     # [L, P, page_size, Hkv, hd] storage (int4: hd / 2)
    v: torch.Tensor
    pos: torch.Tensor   # [B] int32: per-slot number of valid positions
    # per-(token, head) f32 scales of int8/int4 codes, else None
    k_scale: Optional[torch.Tensor] = None   # [L, P, page_size, Hkv]
    v_scale: Optional[torch.Tensor] = None

    @property
    def num_pages(self) -> int:
        return self.k.shape[1]

    @property
    def page_size(self) -> int:
        return self.k.shape[2]

    @property
    def num_layers(self) -> int:
        return self.k.shape[0]

    @property
    def batch(self) -> int:
        return self.pos.shape[0]

    @property
    def kv_dtype(self) -> str:
        return kv_dtype_name(self.k.dtype)

    def reset_pos(self, pos) -> "PagedKVCache":
        """Same arena, new per-slot positions."""
        return PagedKVCache(self.k, self.v, pos, self.k_scale, self.v_scale)


def init_paged_cache(num_layers: int, num_pages: int, page_size: int,
                     kv_heads: int, head_dim: int, batch: int,
                     dtype=torch.bfloat16, device="cuda",
                     kv_cache_dtype: Optional[str] = None) -> PagedKVCache:
    """Allocate an empty page arena (zeros; page 0 included, so every
    block-table entry is a valid index) in the `kv_cache_dtype` storage;
    `dtype` is the compute dtype, bf16 only."""
    if dtype != torch.bfloat16:
        raise NotImplementedError("the port computes attention in bf16; "
                                  "pick the storage with kv_cache_dtype")
    name = resolve_kv_cache_dtype(kv_cache_dtype)
    k, v, ks, vs = _storage(name, (num_layers, num_pages, page_size,
                                   kv_heads, head_dim), device)
    return PagedKVCache(k, v, torch.zeros((batch,), dtype=torch.int32,
                                          device=device), ks, vs)


def _page_offsets(pos: torch.Tensor, s_new: int, page_size: int,
                  block_tables: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(phys, off) write coordinates [B, s_new] for s_new tokens appended
    at per-slot `pos`. A position whose logical page is past the table
    width goes to the null page (its offset stays in range)."""
    npp = block_tables.shape[1]
    abs_pos = pos.to(torch.int64).reshape(-1, 1) + torch.arange(
        s_new, dtype=torch.int64, device=pos.device)
    lp = abs_pos // page_size
    off = abs_pos % page_size
    phys = torch.gather(block_tables.to(torch.int64), 1,
                        torch.clamp(lp, 0, npp - 1))
    phys = torch.where(lp < npp, phys, torch.full_like(phys, NULL_PAGE))
    return phys, off


def paged_update_layer(cache_k: torch.Tensor, cache_v: torch.Tensor,
                       layer: int, k_new: torch.Tensor, v_new: torch.Tensor,
                       pos: torch.Tensor, block_tables: torch.Tensor,
                       cache_ks: Optional[torch.Tensor] = None,
                       cache_vs: Optional[torch.Tensor] = None):
    """Write k_new/v_new [B, S_new, Hkv, hd] of layer `layer` through the
    block table at per-slot offsets `pos` [B], in place (the paged
    ``update_layer``; int8/int4 rows are quantized by the slab's
    ``quantize_kv`` call). Returns (ck, cv), or with scale planes
    (ck, cv, cks, cvs)."""
    scaled = cache_ks is not None
    kc, vc, ks, vs = to_storage(k_new, v_new, cache_k.dtype, scaled)
    phys, off = _page_offsets(pos, k_new.shape[1], cache_k.shape[2],
                              block_tables)
    planes = [(cache_k, kc), (cache_v, vc)]
    if scaled:
        planes += [(cache_ks, ks), (cache_vs, vs)]
    for plane, new in planes:
        raw_view(plane)[layer][phys, off] = raw_view(new)
    if scaled:
        return cache_k, cache_v, cache_ks, cache_vs
    return cache_k, cache_v


def _gather_dense(plane_l: torch.Tensor, block_tables: torch.Tensor
                  ) -> torch.Tensor:
    """``[P, ps, ...]`` layer plane -> dense ``[B, NP * ps, ...]`` through
    the table. With ``NP * ps == max_seq`` it has the slab layout's
    per-layer shape."""
    g = raw_view(plane_l)[block_tables.to(torch.int64)]   # [B, NP, ps, ...]
    g = g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + g.shape[3:])
    return g.view(plane_l.dtype)


def paged_read_layer(cache_k: torch.Tensor, cache_v: torch.Tensor,
                     layer: int, block_tables: torch.Tensor,
                     compute_dtype=torch.bfloat16,
                     cache_ks: Optional[torch.Tensor] = None,
                     cache_vs: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense full-length K/V [B, NP * ps, Hkv, hd] of one layer, gathered
    through the block table and dequantized (scale planes given) or
    upcast."""
    def read(plane, sc):
        s = None if sc is None else _gather_dense(sc[layer], block_tables)
        return dequantize_kv(_gather_dense(plane[layer], block_tables), s,
                             compute_dtype)

    return read(cache_k, cache_ks), read(cache_v, cache_vs)


def paged_read_layer_quantized(cache_k: torch.Tensor, cache_v: torch.Tensor,
                               cache_ks: torch.Tensor, cache_vs: torch.Tensor,
                               layer: int, block_tables: torch.Tensor):
    """One layer's raw codes and scales gathered dense (no dequantization):
    the operands of ``sdp_attention(.., k_scale=, v_scale=)``."""
    return tuple(_gather_dense(p[layer], block_tables)
                 for p in (cache_k, cache_v, cache_ks, cache_vs))


def cow_copy_pages(cache_k: torch.Tensor, cache_v: torch.Tensor,
                   srcs: torch.Tensor, dsts: torch.Tensor,
                   cache_ks: Optional[torch.Tensor] = None,
                   cache_vs: Optional[torch.Tensor] = None):
    """Copy whole pages src -> dst across every layer, scale planes
    included, in place (the copy half of copy-on-write). The sources are
    gathered before the scatter, so a pair list that reads and writes one
    page sees pre-copy bytes; (0, 0) null-page self-copies pad a list
    harmlessly. Returns the planes it was given."""
    srcs, dsts = srcs.to(torch.int64), dsts.to(torch.int64)
    planes = [p for p in (cache_k, cache_v, cache_ks, cache_vs)
              if p is not None]
    for p in planes:
        raw = raw_view(p)
        raw[:, dsts] = raw[:, srcs]
    return tuple(planes)


def gather_pages_dense(cache_k: torch.Tensor, cache_v: torch.Tensor,
                       pages: torch.Tensor,
                       cache_ks: Optional[torch.Tensor] = None,
                       cache_vs: Optional[torch.Tensor] = None):
    """``n`` pages as dense ``[L, 1, n * ps, ...]`` planes: the slab layout
    of a private prefill cache, seeded from radix-shared pages. Returns
    (k, v), or with scale planes (k, v, ks, vs)."""
    pages = pages.to(torch.int64)

    def dense(plane):
        g = raw_view(plane)[:, pages]                   # [L, n, ps, ...]
        g = g.reshape((g.shape[0], 1, g.shape[1] * g.shape[2])
                      + g.shape[3:])
        return g.view(plane.dtype)

    return tuple(dense(p) for p in (cache_k, cache_v, cache_ks, cache_vs)
                 if p is not None)


def paged_cache_nbytes(num_layers: int, num_pages: int, page_size: int,
                       kv_heads: int, head_dim: int,
                       kv_cache_dtype: Optional[str] = None
                       ) -> Dict[str, int]:
    """Storage of a would-be arena without allocating it: the slab's count
    with batch -> num_pages and max_seq -> page_size, so an arena of
    ``batch * (max_seq // page_size)`` pages costs what that slab did."""
    return kv_cache_nbytes(num_layers, num_pages, page_size, kv_heads,
                           head_dim, kv_cache_dtype)


def paged_cache_bytes(cache: PagedKVCache) -> Dict[str, int]:
    """Storage of a live arena: codes, scales, total."""
    return _planes_bytes(cache)
