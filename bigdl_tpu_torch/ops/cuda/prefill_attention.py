"""Prefill (flash) attention kernel B4, forward only, with its plain
version.

Counterpart of ``bigdl_tpu/ops/pallas/prefill_attention.py``
(``_pfa_impl``, bf16 cache). Source: ``csrc/prefill_attention.cu``. The
plain version is the same causal attention as B3's
(``decode_attention.plain_attention``).
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch import _native
from bigdl_tpu_torch.ops.cuda import LAUNCHES
from bigdl_tpu_torch.ops.cuda.decode_attention import (_positions,
                                                       kernel_geometry_ok,
                                                       plain_attention)

__all__ = ["plain_attention", "prefill_attention",
           "prefill_attention_supported"]


def prefill_attention_supported(q: torch.Tensor, k: torch.Tensor) -> bool:
    """Query-length alignment on top of the shared geometry gate; the
    kernel is built for head dims 64, 128 and 256."""
    return q.shape[1] >= 2 and q.shape[1] % 128 == 0 \
        and q.shape[3] in (64, 128, 256) and kernel_geometry_ok(q, k)


def prefill_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos, scale: float) -> torch.Tensor:
    """B4: q [B, Sq, H, hd] (Sq % 128 == 0) against the bf16 cache k/v
    [B, S_max, Hkv, hd], queries at q_pos + i. Returns bf16
    [B, Sq, H, hd]."""
    if q.device.type == "cpu":
        return plain_attention(q, k, v, q_pos, scale)
    b, sq, h, hd = q.shape
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("prefill_attention: q, k, v must share one CUDA "
                         "device")
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != b \
            or k.shape[3] != hd:
        raise ValueError(f"prefill_attention: cache shapes "
                         f"{tuple(k.shape)}, {tuple(v.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if not prefill_attention_supported(q, k):
        raise ValueError(
            f"prefill_attention: unsupported geometry Sq={sq} H={h} "
            f"Hkv={k.shape[2]} hd={hd} S={k.shape[1]} dtype={k.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"prefill_attention: {name} must be contiguous "
                             "bfloat16")
    pos = _positions(q_pos, b, q.device)
    out = torch.empty_like(q)
    err = _native.kernel("prefill_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        out.data_ptr(), b, sq, k.shape[1], h, k.shape[2], hd, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _native.check("prefill_attention", err)
    LAUNCHES["prefill_attention"] += 1
    return out
