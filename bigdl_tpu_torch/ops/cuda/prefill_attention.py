"""Prefill (flash) attention kernel B4, forward only, with its plain
version.

Counterpart of ``bigdl_tpu/ops/pallas/prefill_attention.py``
(``_pfa_impl``: the bf16 body ``_kernel`` with its float8_e5m2 input, and
the int8/int4 body ``_kernel_scaled``). Source:
``csrc/prefill_attention.cu``. The cache may hold any storage kind of
``ops/kvcache.py``; the kernel converts the codes exactly and folds the
int8/int4 scales out of the products, as B3 does. Each kind has its own
launch counter. The plain version is the same causal attention as B3's
(``decode_attention.plain_attention``).

One launch a call: a block takes 64 rows, the G = H / Hkv query heads of
one kv head times 64 / G queries (a query tile). ``plan_prefill`` gives
each query tile ``nspan`` blocks so that the grid reaches every SM; on the
card each tile's visible keys are cut evenly in whole 64-key tiles over as
many of them as its keys need (``prefill_spans`` repeats that cut). A
tile's blocks are one thread-block cluster and merge their partials
through distributed shared memory in the same launch (see the source): no
workspace, no tickets.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Tuple

import torch

from bigdl_tpu_torch import _native
from bigdl_tpu_torch.ops.cuda import LAUNCHES
from bigdl_tpu_torch.ops.cuda.decode_attention import (KV_KINDS,
                                                       _positions, _ptr,
                                                       _stream,
                                                       check_aligned,
                                                       check_kv_operands,
                                                       counter,
                                                       kernel_geometry_ok,
                                                       kv_kind,
                                                       plain_attention)
from bigdl_tpu_torch.ops.cuda.dequant_matmul import _sm_count

__all__ = ["plain_attention", "prefill_attention",
           "prefill_attention_supported"]

# the body's block (kRows, kKT, kMaxSpans, kWholeTiles in
# csrc/prefill_attention.cu; tests/test_torch_prefill_hopper.py holds the
# two in step): (query, head) rows a block, keys a tile, blocks (one
# cluster) a query tile, and key tiles a span before a query tile takes
# two. A span costs ~1-2 us beyond its keys (q, the cluster's merge), and
# on the H100 splitting tiles of 256 keys or fewer ran slower than one
# block a tile (tools/bench_attention.py's nspan sweep)
ROWS = 64
KEY_TILE = 64
MAX_SPANS = 8
WHOLE_TILES = 4
# head dims the body is built for, at every storage kind
HEAD_DIMS = (64, 128, 256)


def prefill_attention_supported(q: torch.Tensor, k: torch.Tensor,
                                k_scale: Optional[torch.Tensor] = None
                                ) -> bool:
    """Query-length alignment on top of the shared geometry gate; the
    kernel is built for head dims 64, 128 and 256."""
    return q.shape[1] >= 2 and q.shape[1] % 128 == 0 \
        and q.shape[3] in HEAD_DIMS \
        and kernel_geometry_ok(q, k, k_scale)


@functools.lru_cache(maxsize=1024)
def plan_prefill(b: int, h: int, hkv: int, sq: int, s: int,
                 pos: Optional[int], sms: int) -> Tuple[int, int, int]:
    """(queries a tile, query tiles, nspan) of a launch. A tile takes the
    64 / G queries of the G = H / Hkv heads of a kv head; nspan, the blocks
    a tile, is the fewest whose live blocks (those the cut of
    ``prefill_spans`` gives keys) put one on each of the `sms` SMs, or
    else the fewest that give the most live blocks.

    A position left on the card (`pos` None, as on the engine's path,
    whose private cache of S rows takes 256-token chunks at 0, 256, ..,
    S - 256) is taken as the last chunk's, s - sq: the most keys a call on
    this cache can see. An earlier chunk's tiles see fewer, and the card
    gives them no more spans than their keys need (one up to 256 keys), so
    the blocks of a first chunk's cluster past the first leave at once."""
    qt = ROWS // (h // hkv)
    nqt = -(-sq // qt)
    p = max(0, s - sq) if pos is None else pos
    best, most = 1, 0
    for nspan in range(1, MAX_SPANS + 1):
        live = b * hkv * sum(len(prefill_spans(t, qt, nspan, sq, s, p))
                             for t in range(nqt))
        if live > most:
            best, most = nspan, live
        if live >= sms:
            break
    return qt, nqt, best


def prefill_spans(tile: int, qt: int, nspan: int, sq: int, s: int,
                  pos: int) -> List[Tuple[int, int]]:
    """The keys [j0, j1) of each live block of query tile `tile` (queries
    tile * qt ..): its visible keys cut evenly in whole tiles over at most
    nspan spans and at most one a WHOLE_TILES key tiles (rounded up), as
    the kernel cuts them."""
    nvis = max(0, min(pos + min((tile + 1) * qt, sq), s))
    tiles = -(-nvis // KEY_TILE)
    nsp = min(nspan, max(1, -(-tiles // WHOLE_TILES)))
    per = -(-nvis // nsp)
    span = max(KEY_TILE, -(-per // KEY_TILE) * KEY_TILE)
    live = max(1, -(-nvis // span))
    return [(sp * span, min((sp + 1) * span, nvis)) for sp in range(live)]


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos, scale: float,
                      k_scale: Optional[torch.Tensor] = None,
                      v_scale: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """B4: q [B, Sq, H, hd] (Sq % 128 == 0) against the cache k/v
    [B, S_max, Hkv, hd] (codes of any storage kind; int8/int4 with f32
    scales [B, S_max, Hkv]), queries at q_pos + i. Returns bf16
    [B, Sq, H, hd]."""
    if q.device.type == "cpu":
        return plain_attention(q, k, v, q_pos, scale, k_scale, v_scale)
    b, sq, h, hd = q.shape
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("prefill_attention: q, k, v must share one CUDA "
                         "device")
    if k.dim() != 4 or k.shape[0] != b:
        raise ValueError(f"prefill_attention: cache shape {tuple(k.shape)} "
                         f"does not fit q {tuple(q.shape)}")
    check_kv_operands("prefill_attention", hd, k, v, k_scale, v_scale)
    if not prefill_attention_supported(q, k, k_scale):
        raise ValueError(
            f"prefill_attention: unsupported geometry Sq={sq} H={h} "
            f"Hkv={k.shape[2]} hd={hd} S={k.shape[1]} dtype={k.dtype}")
    if q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise ValueError("prefill_attention: q must be contiguous bfloat16")
    check_aligned("prefill_attention", k, v)
    return _launch(q, k, v, _positions(q_pos, b, q.device), scale, k_scale,
                   v_scale)


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            pos: torch.Tensor, scale: float,
            k_scale: Optional[torch.Tensor],
            v_scale: Optional[torch.Tensor],
            nspan: Optional[int] = None) -> torch.Tensor:
    """One B4 launch on checked operands (pos int32 [B], never read on
    the host: the plan takes the cache's last chunk); `nspan` overrides the
    plan (tools/bench_attention.py sweeps it)."""
    b, sq, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if nspan is None:
        nspan = plan_prefill(b, h, hkv, sq, s, None, _sm_count(q.device))[2]
    out = torch.empty_like(q)
    err = _native.kernel("prefill_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), pos.data_ptr(), out.data_ptr(), b, sq, s, h, hkv, hd,
        KV_KINDS[k.dtype][1], nspan, float(scale), _stream(q.device))
    _native.check("prefill_attention", err)
    LAUNCHES[counter("prefill_attention", kv_kind(k))] += 1
    return out
