"""Paged decode attention kernel B5 and the plain version it matches.

Counterpart of ``bigdl_tpu/ops/pallas/paged_decode_attention.py``
(``paged_decode_attention_pallas``, bf16 arena). Source:
``csrc/paged_decode_attention.cu``, which shares B3's body
(``csrc/decode_attention.cuh``) and differs only in the row address.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch import _native
from bigdl_tpu_torch.ops.cuda import LAUNCHES
from bigdl_tpu_torch.ops.cuda.decode_attention import (_DECODE_BUILT,
                                                       MAX_GROUP,
                                                       MAX_HEAD_DIM, _SPAN,
                                                       _positions,
                                                       plain_attention)
from bigdl_tpu_torch.ops.paged import _gather_dense


def plain_paged_attention(q: torch.Tensor, arena_k: torch.Tensor,
                          arena_v: torch.Tensor, block_tables: torch.Tensor,
                          q_pos, scale: float) -> torch.Tensor:
    """The dense gather through the table, then the plain causal attention
    (the XLA fallback of ``sdp_attention_paged``)."""
    return plain_attention(q, _gather_dense(arena_k, block_tables),
                           _gather_dense(arena_v, block_tables), q_pos,
                           scale)


def paged_attention_geometry_ok(q: torch.Tensor,
                                arena_k: torch.Tensor) -> bool:
    """The JAX gate for a bf16 arena (H % Hkv == 0, hd % 64 == 0,
    ps % 128 == 0) plus the kernel's own group and head-dim limits."""
    h, hd = q.shape[2], q.shape[3]
    ps, hkv = arena_k.shape[1], arena_k.shape[2]
    return (h % hkv == 0 and h // hkv <= MAX_GROUP and hd % 64 == 0
            and hd <= MAX_HEAD_DIM and ps % 128 == 0
            and arena_k.dtype == torch.bfloat16
            and (h // hkv, -(-hd // 128)) in _DECODE_BUILT)


def paged_decode_attention_supported(q: torch.Tensor,
                                     arena_k: torch.Tensor) -> bool:
    """Gate of the ``sdp_attention_paged`` dispatch."""
    return q.shape[1] == 1 and paged_attention_geometry_ok(q, arena_k)


def paged_decode_attention(q: torch.Tensor, arena_k: torch.Tensor,
                           arena_v: torch.Tensor, block_tables: torch.Tensor,
                           q_pos, scale: float) -> torch.Tensor:
    """B5: q [B, 1, H, hd] against one layer's bf16 arena k/v
    [P, ps, Hkv, hd] through block_tables [B, NP] int32 (entries must be
    valid page ids < P; 0 is the null page) at positions q_pos (scalar or
    [B]). Returns bf16 [B, 1, H, hd]."""
    if q.device.type == "cpu":
        return plain_paged_attention(q, arena_k, arena_v, block_tables,
                                     q_pos, scale)
    b, sq, h, hd = q.shape
    dev = q.device
    if not (q.is_cuda and arena_k.device == dev and arena_v.device == dev
            and block_tables.device == dev):
        raise ValueError("paged_decode_attention: q, arena and block tables "
                         "must share one CUDA device")
    if sq != 1:
        raise ValueError(f"paged_decode_attention: Sq must be 1, got {sq}")
    if arena_k.shape != arena_v.shape or arena_k.dim() != 4 \
            or arena_k.shape[3] != hd:
        raise ValueError(f"paged_decode_attention: arena shapes "
                         f"{tuple(arena_k.shape)}, {tuple(arena_v.shape)} "
                         f"do not fit q {tuple(q.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or block_tables.dtype != torch.int32 \
            or not block_tables.is_contiguous():
        raise ValueError(f"paged_decode_attention: block_tables must be "
                         f"contiguous int32 [{b}, NP], got "
                         f"{block_tables.dtype} {tuple(block_tables.shape)}")
    if not paged_decode_attention_supported(q, arena_k):
        raise ValueError(
            f"paged_decode_attention: unsupported geometry H={h} "
            f"Hkv={arena_k.shape[2]} hd={hd} ps={arena_k.shape[1]} "
            f"dtype={arena_k.dtype}")
    for name, t in (("q", q), ("arena_k", arena_k), ("arena_v", arena_v)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"paged_decode_attention: {name} must be "
                             "contiguous bfloat16")
    p_, ps = arena_k.shape[0], arena_k.shape[1]
    np_ = block_tables.shape[1]
    pos = _positions(q_pos, b, dev)
    out = torch.empty_like(q)
    # per (slot, head): the split-S partials (m, l, acc[hd]) over the
    # table's NP * ps logical keys
    parts = -(-(np_ * ps) // _SPAN) * 4
    ws = torch.empty((b * h * parts * (hd + 2),), dtype=torch.float32,
                     device=dev)
    err = _native.kernel("paged_decode_attention")(
        q.data_ptr(), arena_k.data_ptr(), arena_v.data_ptr(),
        block_tables.data_ptr(), pos.data_ptr(), out.data_ptr(),
        ws.data_ptr(), b, p_, ps, np_, h, arena_k.shape[2], hd, float(scale),
        torch.cuda.current_stream(dev).cuda_stream)
    _native.check("paged_decode_attention", err)
    LAUNCHES["paged_decode_attention"] += 1
    return out
