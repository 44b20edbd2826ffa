"""Paged decode attention kernel B5 and the plain version it matches.

Counterpart of ``bigdl_tpu/ops/pallas/paged_decode_attention.py``
(``paged_decode_attention_pallas``: ``_paged_kernel`` with bf16 or
float8_e5m2 pages, ``_paged_kernel_scaled`` with int8/int4 pages and
their f32 scale planes). Source: ``csrc/paged_decode_attention.cu``,
which shares B3's body (``csrc/decode_attention.cuh``) and B3's plan
(``plan_spans`` over the table's NP * ps keys, with B3's occupancy) and
differs only in the row address, so it gives B3's bits on the same rows.
One launch a call. Each storage kind has its own launch counter.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import _native
from bigdl_tpu_torch.ops.cuda import LAUNCHES
from bigdl_tpu_torch.ops.cuda.decode_attention import (_DECODE_BUILT,
                                                       KV_KINDS, MAX_GROUP,
                                                       MAX_HEAD_DIM,
                                                       _positions, _ptr,
                                                       _stream,
                                                       check_aligned,
                                                       check_kv_operands,
                                                       counter,
                                                       decode_buffers,
                                                       decode_plan,
                                                       kv_kind,
                                                       kv_operands_ok,
                                                       plain_attention)
from bigdl_tpu_torch.ops.paged import _gather_dense


def plain_paged_attention(q: torch.Tensor, arena_k: torch.Tensor,
                          arena_v: torch.Tensor, block_tables: torch.Tensor,
                          q_pos, scale: float,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """The dense gather through the table (scale planes too), then the
    plain causal attention (the XLA fallback of ``sdp_attention_paged``)."""
    def dense(t):
        return None if t is None else _gather_dense(t, block_tables)

    return plain_attention(q, dense(arena_k), dense(arena_v), q_pos, scale,
                           dense(k_scale), dense(v_scale))


def paged_attention_geometry_ok(q: torch.Tensor, arena_k: torch.Tensor,
                                k_scale: Optional[torch.Tensor] = None
                                ) -> bool:
    """The JAX gate (H % Hkv == 0, hd % 64 == 0, ps % 128 == 0; bf16 and
    e5m2 pages without scales, int8/int4 pages with them) plus the
    kernel's own group and head-dim limits."""
    h, hd = q.shape[2], q.shape[3]
    ps, hkv = arena_k.shape[1], arena_k.shape[2]
    return (h % hkv == 0 and h // hkv <= MAX_GROUP and hd % 64 == 0
            and hd <= MAX_HEAD_DIM and ps % 128 == 0
            and kv_operands_ok(hd, arena_k, k_scale)
            and (h // hkv, -(-hd // 128)) in _DECODE_BUILT)


def paged_decode_attention_supported(q: torch.Tensor, arena_k: torch.Tensor,
                                     k_scale: Optional[torch.Tensor] = None
                                     ) -> bool:
    """Gate of the ``sdp_attention_paged`` dispatch."""
    return q.shape[1] == 1 and paged_attention_geometry_ok(q, arena_k,
                                                           k_scale)


def paged_decode_attention(q: torch.Tensor, arena_k: torch.Tensor,
                           arena_v: torch.Tensor, block_tables: torch.Tensor,
                           q_pos, scale: float,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """B5: q [B, 1, H, hd] against one layer's arena k/v [P, ps, Hkv, hd]
    (codes of any storage kind; int8/int4 with f32 scales [P, ps, Hkv])
    through block_tables [B, NP] int32 (entries must be valid page ids
    < P; 0 is the null page) at positions q_pos (scalar or [B]). Returns
    bf16 [B, 1, H, hd]."""
    if q.device.type == "cpu":
        return plain_paged_attention(q, arena_k, arena_v, block_tables,
                                     q_pos, scale, k_scale, v_scale)
    b, sq, h, hd = q.shape
    dev = q.device
    if not (q.is_cuda and arena_k.device == dev and arena_v.device == dev
            and block_tables.device == dev):
        raise ValueError("paged_decode_attention: q, arena and block tables "
                         "must share one CUDA device")
    if sq != 1:
        raise ValueError(f"paged_decode_attention: Sq must be 1, got {sq}")
    if arena_k.dim() != 4:
        raise ValueError(f"paged_decode_attention: arena shape "
                         f"{tuple(arena_k.shape)} does not fit q "
                         f"{tuple(q.shape)}")
    check_kv_operands("paged_decode_attention", hd, arena_k, arena_v,
                      k_scale, v_scale)
    if block_tables.dim() != 2 or block_tables.shape[0] != b \
            or block_tables.dtype != torch.int32 \
            or not block_tables.is_contiguous():
        raise ValueError(f"paged_decode_attention: block_tables must be "
                         f"contiguous int32 [{b}, NP], got "
                         f"{block_tables.dtype} {tuple(block_tables.shape)}")
    if not paged_decode_attention_supported(q, arena_k, k_scale):
        raise ValueError(
            f"paged_decode_attention: unsupported geometry H={h} "
            f"Hkv={arena_k.shape[2]} hd={hd} ps={arena_k.shape[1]} "
            f"dtype={arena_k.dtype}")
    if q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise ValueError("paged_decode_attention: q must be contiguous "
                         "bfloat16")
    check_aligned("paged_decode_attention", arena_k, arena_v)
    return _launch(q, arena_k, arena_v, block_tables,
                   _positions(q_pos, b, dev), scale, k_scale, v_scale)


def _launch(q: torch.Tensor, arena_k: torch.Tensor, arena_v: torch.Tensor,
            block_tables: torch.Tensor, pos: torch.Tensor, scale: float,
            k_scale: Optional[torch.Tensor],
            v_scale: Optional[torch.Tensor],
            span: Optional[int] = None) -> torch.Tensor:
    """One B5 launch on checked operands (pos int32 [B]), planned as B3
    plans S = NP * ps keys; `span` overrides the plan."""
    b, _, h, hd = q.shape
    p_, ps, hkv = arena_k.shape[0], arena_k.shape[1], arena_k.shape[2]
    np_ = block_tables.shape[1]
    kind = KV_KINDS[arena_k.dtype][1]
    if span is None:
        span, nspan = decode_plan(b, hkv, np_ * ps, kind, hd, h // hkv,
                                  q.device)
    else:
        nspan = -(-(np_ * ps) // span)
    out = torch.empty_like(q)
    # the workspace stays referenced until the launch is queued
    ws, tickets = decode_buffers(b, h, hkv, hd, nspan, q.device)
    err = _native.kernel("paged_decode_attention")(
        q.data_ptr(), arena_k.data_ptr(), arena_v.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), block_tables.data_ptr(), pos.data_ptr(),
        out.data_ptr(), _ptr(ws), _ptr(tickets), b, p_, ps, np_, h, hkv, hd,
        kind, span, float(scale), _stream(q.device))
    _native.check("paged_decode_attention", err)
    LAUNCHES[counter("paged_decode_attention", kv_kind(arena_k))] += 1
    return out
