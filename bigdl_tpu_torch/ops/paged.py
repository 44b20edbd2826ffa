"""Paged KV cache: one page arena per layer + per-sequence block tables
(counterpart of ``bigdl_tpu/ops/paged.py``, bf16 storage).

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

int8/int4/fp8 arenas with their scale planes, and the metrics publisher,
are not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

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

    k: torch.Tensor     # [L, P, page_size, Hkv, hd] bf16
    v: torch.Tensor
    pos: torch.Tensor   # [B] int32: per-slot number of valid positions

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


def init_paged_cache(num_layers: int, num_pages: int, page_size: int,
                     kv_heads: int, head_dim: int, batch: int,
                     dtype=torch.bfloat16, device="cuda") -> PagedKVCache:
    """Allocate an empty page arena (zeros; page 0 included, so every
    block-table entry is a valid index)."""
    if dtype != torch.bfloat16:
        raise NotImplementedError("the port's paged arena stores bf16 only; "
                                  "fp8/int8/int4 pages are not ported yet")
    shape = (num_layers, num_pages, page_size, kv_heads, head_dim)
    return PagedKVCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros((batch,), dtype=torch.int32,
                                    device=device))


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
                       pos: torch.Tensor, block_tables: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write k_new/v_new [B, S_new, Hkv, hd] of layer `layer` through the
    block table at per-slot offsets `pos` [B], in place (the paged
    ``update_layer``). Returns the arena tensors."""
    phys, off = _page_offsets(pos, k_new.shape[1], cache_k.shape[2],
                              block_tables)
    ck, cv = cache_k[layer], cache_v[layer]             # [P, ps, Hkv, hd]
    ck[phys, off] = k_new.to(ck.dtype)
    cv[phys, off] = v_new.to(cv.dtype)
    return cache_k, cache_v


def _gather_dense(plane_l: torch.Tensor, block_tables: torch.Tensor
                  ) -> torch.Tensor:
    """``[P, ps, ...]`` layer plane -> dense ``[B, NP * ps, ...]`` through
    the table. With ``NP * ps == max_seq`` it has the slab layout's
    per-layer shape."""
    g = plane_l[block_tables.to(torch.int64)]          # [B, NP, ps, ...]
    return g.reshape((g.shape[0], g.shape[1] * g.shape[2]) + g.shape[3:])


def paged_read_layer(cache_k: torch.Tensor, cache_v: torch.Tensor,
                     layer: int, block_tables: torch.Tensor,
                     compute_dtype=torch.bfloat16
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense full-length K/V [B, NP * ps, Hkv, hd] of one layer, gathered
    through the block table."""
    return (_gather_dense(cache_k[layer], block_tables).to(compute_dtype),
            _gather_dense(cache_v[layer], block_tables).to(compute_dtype))


def cow_copy_pages(cache_k: torch.Tensor, cache_v: torch.Tensor,
                   srcs: torch.Tensor, dsts: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Copy whole pages src -> dst across every layer, in place (the copy
    half of copy-on-write). The sources are gathered before the scatter,
    so a pair list that reads and writes one page sees pre-copy bytes;
    (0, 0) null-page self-copies pad a list harmlessly."""
    srcs, dsts = srcs.to(torch.int64), dsts.to(torch.int64)
    ks = cache_k[:, srcs]
    vs = cache_v[:, srcs]
    cache_k[:, dsts] = ks
    cache_v[:, dsts] = vs
    return cache_k, cache_v


def gather_pages_dense(cache_k: torch.Tensor, cache_v: torch.Tensor,
                       pages: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n`` pages as dense ``[L, 1, n * ps, Hkv, hd]`` planes: the slab
    layout of a private prefill cache, seeded from radix-shared pages."""
    pages = pages.to(torch.int64)

    def dense(plane):
        g = plane[:, pages]                             # [L, n, ps, ...]
        return g.reshape((g.shape[0], 1, g.shape[1] * g.shape[2])
                         + g.shape[3:])

    return dense(cache_k), dense(cache_v)


def paged_cache_nbytes(num_layers: int, num_pages: int, page_size: int,
                       kv_heads: int, head_dim: int) -> Dict[str, int]:
    """Storage of a would-be bf16 arena without allocating it: an arena of
    ``batch * (max_seq // page_size)`` pages costs what that slab did."""
    codes = 2 * num_layers * num_pages * page_size * kv_heads * head_dim * 2
    return {"codes": codes, "scales": 0, "total": codes}


def paged_cache_bytes(cache: PagedKVCache) -> Dict[str, int]:
    """Storage of a live arena: codes, scales, total."""
    codes = (cache.k.numel() * cache.k.element_size()
             + cache.v.numel() * cache.v.element_size())
    return {"codes": codes, "scales": 0, "total": codes}
