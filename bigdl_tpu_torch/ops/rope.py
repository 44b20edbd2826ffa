"""Rotary position embeddings (counterpart of ``bigdl_tpu/ops/rope.py``:
``rope_freqs``, ``rope_cos_sin``, ``apply_rope``; scaled variants are
not ported yet)."""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def rope_freqs(head_dim: int, base: float = 10000.0,
               rotary_dim: Optional[int] = None,
               scaling_factor: float = 1.0,
               device=None) -> torch.Tensor:
    """Inverse frequencies [rotary_dim // 2] (f32), linear scaling only."""
    rd = rotary_dim or head_dim
    exponent = torch.arange(0, rd, 2, dtype=torch.float32,
                            device=device) / rd
    inv_freq = 1.0 / (base ** exponent)
    return inv_freq / scaling_factor


def rope_cos_sin(positions: torch.Tensor, inv_freq: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [..., rd // 2] (f32) for the given positions."""
    angles = positions.to(torch.float32)[..., None] * inv_freq
    return torch.cos(angles), torch.sin(angles)


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    h = x.shape[-1] // 2
    return torch.cat([-x[..., h:], x[..., :h]], dim=-1)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
               interleaved: bool = False) -> torch.Tensor:
    """Rotate the first 2 * (rd // 2) channels of the last dim.

    x is [..., seq, heads, head_dim] (cos/sin broadcast over heads) or
    [..., seq, head_dim]; computed in f32, returned in x.dtype."""
    rd = cos.shape[-1] * 2
    xf = x.to(torch.float32)
    x_rot, x_pass = xf[..., :rd], xf[..., rd:]
    if x.dim() == cos.dim() + 1:
        cos = cos[..., None, :]
        sin = sin[..., None, :]
    if interleaved:
        x1 = x_rot[..., 0::2]
        x2 = x_rot[..., 1::2]
        o1 = x1 * cos - x2 * sin
        o2 = x2 * cos + x1 * sin
        out = torch.stack([o1, o2], dim=-1).reshape(x_rot.shape)
    else:
        cs = torch.cat([cos, cos], dim=-1)
        sn = torch.cat([sin, sin], dim=-1)
        out = x_rot * cs + _rotate_half(x_rot) * sn
    if x_pass.shape[-1]:
        out = torch.cat([out, x_pass], dim=-1)
    return out.to(x.dtype)
