"""Prefill (flash) attention kernel B4, forward only, with its plain
version.

Counterpart of ``bigdl_tpu/ops/pallas/prefill_attention.py``
(``_pfa_impl``: the bf16 body ``_kernel`` with its float8_e5m2 input, and
the int8/int4 body ``_kernel_scaled``). Source:
``csrc/prefill_attention.cu``. The cache may hold any storage kind of
``ops/kvcache.py``, dequantized as B3 does; each kind has its own launch
counter. The plain version is the same causal attention as B3's
(``decode_attention.plain_attention``).
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch import _native
from bigdl_tpu_torch.ops.cuda import LAUNCHES
from bigdl_tpu_torch.ops.cuda.decode_attention import (_positions, _ptr,
                                                       check_kv_operands,
                                                       counter,
                                                       kernel_geometry_ok,
                                                       kv_kind,
                                                       plain_attention)

__all__ = ["plain_attention", "prefill_attention",
           "prefill_attention_supported"]


def prefill_attention_supported(q: torch.Tensor, k: torch.Tensor,
                                k_scale: Optional[torch.Tensor] = None
                                ) -> bool:
    """Query-length alignment on top of the shared geometry gate; the
    kernel is built for head dims 64, 128 and 256."""
    return q.shape[1] >= 2 and q.shape[1] % 128 == 0 \
        and q.shape[3] in (64, 128, 256) \
        and kernel_geometry_ok(q, k, k_scale)


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
    kind = check_kv_operands("prefill_attention", hd, k, v, k_scale,
                             v_scale)
    if not prefill_attention_supported(q, k, k_scale):
        raise ValueError(
            f"prefill_attention: unsupported geometry Sq={sq} H={h} "
            f"Hkv={k.shape[2]} hd={hd} S={k.shape[1]} dtype={k.dtype}")
    if q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise ValueError("prefill_attention: q must be contiguous bfloat16")
    pos = _positions(q_pos, b, q.device)
    out = torch.empty_like(q)
    err = _native.kernel("prefill_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), pos.data_ptr(), out.data_ptr(), b, sq, k.shape[1], h,
        k.shape[2], hd, kind, float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _native.check("prefill_attention", err)
    LAUNCHES[counter("prefill_attention", kv_kind(k))] += 1
    return out
