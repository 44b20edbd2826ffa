"""Causal scaled-dot-product attention over the slab KV cache and the paged
arena (counterpart of ``bigdl_tpu/ops/attention.py``: ``sdp_attention``,
``sdp_attention_paged``).

Dispatch: Sq == 1 goes to the decode kernel B3; Sq >= 2 with Sq % 128 == 0
and a scalar position goes to the prefill kernel B4; both need the
kernels' geometry (bf16 cache, hd % 64 == 0, S % 128 == 0, H % Hkv == 0).
Over a paged arena, Sq == 1 with the B5 gate (bf16 arena, ps % 128 == 0)
goes to the paged decode kernel B5; everything else gathers the dense view
through the block table and takes the slab dispatch, as the JAX package
does. Everything else, and every call with
``BIGDL_TPU_TORCH_ATTENTION_BACKEND=plain``, runs the plain version.
Alibi, soft-capping and sliding windows are not ported yet.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.config import flags
from bigdl_tpu_torch.ops.cuda.decode_attention import (
    decode_attention, decode_attention_supported, plain_attention)
from bigdl_tpu_torch.ops.cuda.paged_decode_attention import (
    paged_decode_attention, paged_decode_attention_supported)
from bigdl_tpu_torch.ops.cuda.prefill_attention import (
    prefill_attention, prefill_attention_supported)
from bigdl_tpu_torch.ops.paged import _gather_dense


def sdp_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  q_pos, scale: Optional[float] = None) -> torch.Tensor:
    """q [B, Sq, H, D] (post-RoPE) against k/v [B, Skv, Hkv, D]; query i
    attends keys j <= q_pos + i (q_pos scalar or [B]). Returns
    [B, Sq, H, D] in q.dtype; softmax in f32."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if flags().attention_backend == "auto":
        if decode_attention_supported(q, k):
            return decode_attention(q, k, v, q_pos, scale).to(q.dtype)
        scalar_pos = torch.as_tensor(q_pos).dim() == 0
        if scalar_pos and prefill_attention_supported(q, k):
            return prefill_attention(q, k, v, q_pos, scale).to(q.dtype)
    return plain_attention(q, k, v, q_pos, scale)


def sdp_attention_paged(q: torch.Tensor, arena_k: torch.Tensor,
                        arena_v: torch.Tensor, block_tables: torch.Tensor,
                        q_pos, scale: Optional[float] = None
                        ) -> torch.Tensor:
    """Causal SDP reading K/V of one layer's arena [P, ps, Hkv, D]
    through block_tables [B, NP] (0 = null page) at per-slot q_pos [B].
    With ``NP * ps == max_seq`` the result equals ``sdp_attention`` over
    the slab holding the same rows."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if flags().attention_backend == "auto" \
            and paged_decode_attention_supported(q, arena_k):
        return paged_decode_attention(q, arena_k, arena_v, block_tables,
                                      q_pos, scale).to(q.dtype)
    return sdp_attention(q, _gather_dense(arena_k, block_tables),
                         _gather_dense(arena_v, block_tables), q_pos, scale)
