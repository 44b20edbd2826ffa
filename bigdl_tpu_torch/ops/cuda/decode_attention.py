"""Decode attention kernel B3 and the plain causal attention it matches.

Counterpart of ``bigdl_tpu/ops/pallas/decode_attention.py``
(``decode_attention_pallas``, bf16 cache). Source:
``csrc/decode_attention.cu``, whose body (``csrc/decode_attention.cuh``)
B5 shares.
"""

from __future__ import annotations

import torch

from bigdl_tpu_torch import _native
from bigdl_tpu_torch.ops.cuda import LAUNCHES

# the kernels' limits: query heads per kv head and head dims
MAX_GROUP = 16
MAX_HEAD_DIM = 256
# the decode kernel is built for these (group size, 128-wide head-dim
# slices) pairs: its per-lane query rows and accumulators live in registers
_DECODE_BUILT = {(1, 1), (2, 1), (4, 1), (8, 1), (16, 1),
                 (1, 2), (2, 2), (4, 2), (8, 2)}
# keys per block of the decode kernel (kSpan in csrc/decode_attention.cu)
_SPAN = 256


def _positions(pos, b: int, device) -> torch.Tensor:
    """Scalar or [B] positions -> contiguous int32 [B] on `device`."""
    p = torch.as_tensor(pos, device=device).to(torch.int32).reshape(-1)
    return p.expand(b).contiguous()


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos, scale: float) -> torch.Tensor:
    """Causal GQA attention against a (partly filled) cache: query i of
    slot b attends keys j <= q_pos[b] + i. q [B, Sq, H, D], k/v
    [B, Skv, Hkv, D]; q_pos scalar or [B]. Operands rounded to bf16,
    scores and softmax in f32, probabilities rounded to bf16 before the
    value product (the XLA body of ``sdp_attention``). Returns q.dtype."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    f32, bf16 = torch.float32, torch.bfloat16
    qf = q.reshape(b, sq, hkv, g, d).to(bf16).to(f32)
    kf = k.to(bf16).to(f32)
    vf = v.to(bf16).to(f32)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qf, kf) * scale
    pos = torch.as_tensor(q_pos, device=q.device).to(torch.int64)
    k_ids = torch.arange(skv, device=q.device)
    q_off = torch.arange(sq, device=q.device)
    if pos.dim() == 1:
        q_ids = pos[:, None] + q_off[None, :]                 # [B, Sq]
        mask = k_ids[None, None, :] <= q_ids[:, :, None]      # [B, Sq, Skv]
        mask = mask[:, None, None]
    else:
        q_ids = pos + q_off                                   # [Sq]
        mask = (k_ids[None, :] <= q_ids[:, None])[None, None, None]
    scores = scores.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(bf16).to(f32), vf)
    return out.reshape(b, sq, h, d).to(q.dtype)


def kernel_geometry_ok(q: torch.Tensor, k: torch.Tensor) -> bool:
    """The shared gate of both attention kernels (``attention_geometry_ok``
    for the bf16 cache) plus the CUDA kernels' own group and head-dim
    limits."""
    h, hd = q.shape[2], q.shape[3]
    s, hkv = k.shape[1], k.shape[2]
    return (h % hkv == 0 and h // hkv <= MAX_GROUP and hd % 64 == 0
            and hd <= MAX_HEAD_DIM and s % 128 == 0
            and k.dtype == torch.bfloat16)


def decode_attention_supported(q: torch.Tensor, k: torch.Tensor) -> bool:
    g, slices = q.shape[2] // k.shape[2], -(-q.shape[3] // 128)
    return q.shape[1] == 1 and kernel_geometry_ok(q, k) \
        and (g, slices) in _DECODE_BUILT


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos, scale: float) -> torch.Tensor:
    """B3: q [B, 1, H, hd] against the bf16 cache k/v [B, S, Hkv, hd] at
    positions q_pos (scalar or [B]). Returns bf16 [B, 1, H, hd]."""
    if q.device.type == "cpu":
        return plain_attention(q, k, v, q_pos, scale)
    b, sq, h, hd = q.shape
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("decode_attention: q, k, v must share one CUDA "
                         "device")
    if sq != 1:
        raise ValueError(f"decode_attention: Sq must be 1, got {sq}")
    if k.shape != v.shape or k.dim() != 4 or k.shape[0] != b \
            or k.shape[3] != hd:
        raise ValueError(f"decode_attention: cache shapes {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not fit q {tuple(q.shape)}")
    if not decode_attention_supported(q, k):
        raise ValueError(
            f"decode_attention: unsupported geometry H={h} Hkv={k.shape[2]} "
            f"hd={hd} S={k.shape[1]} dtype={k.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} must be contiguous "
                             "bfloat16")
    pos = _positions(q_pos, b, q.device)
    out = torch.empty_like(q)
    # per (slot, head): P partial (m, l, acc[hd]) of the split-S pass
    parts = -(-k.shape[1] // _SPAN) * 4
    ws = torch.empty((b * h * parts * (hd + 2),), dtype=torch.float32,
                     device=q.device)
    err = _native.kernel("decode_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
        out.data_ptr(), ws.data_ptr(), b, k.shape[1], h, k.shape[2], hd,
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _native.check("decode_attention", err)
    LAUNCHES["decode_attention"] += 1
    return out
