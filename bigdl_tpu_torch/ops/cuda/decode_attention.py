"""Decode attention kernel B3 and the plain causal attention it matches.

Counterpart of ``bigdl_tpu/ops/pallas/decode_attention.py``
(``decode_attention_pallas``: the bf16 bodies, their float8_e5m2 input,
and the int8/int4 bodies ``_kernel_scaled`` / ``_kernel_blocked_scaled``).
Source: ``csrc/decode_attention.cu``, whose body
(``csrc/decode_attention.cuh``) B5 shares.

The cache may hold any storage kind of ``ops/kvcache.py``: bf16,
float8_e5m2 codes (upcast exactly), or int8 / packed int4 codes with f32
scales [B, S, Hkv]. The plain version dequantizes as ``_dequant_rows``
does (code to f32, times its scale in f32, rounded to bf16 before any
dot); the kernel folds the scales out of the products instead (the
score's scale times the exact codes' dot, and the probability times the
V scale before its bf16 rounding). Each kind has its own launch counter:
``decode_attention`` (bf16) and ``decode_attention_<kind>``.

One launch a call: ``plan_spans`` cuts the keys into spans so the
(slot, kv head, span) blocks cover the card, and the last span of a
(slot, kv head) to finish merges the others' partials in the same launch
(a workspace and a ticket buffer, see ``csrc/decode_attention.cuh``). B5
plans with the same function and occupancy, so it cuts the keys as B3
does.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from bigdl_tpu_torch import _native
from bigdl_tpu_torch.ops.cuda import LAUNCHES
from bigdl_tpu_torch.ops.cuda.dequant_matmul import _sm_count, ticket_buffer
from bigdl_tpu_torch.ops.kvcache import SCALED_KV_DTYPES, dequantize_kv

# the kernels' limits: query heads per kv head and head dims
MAX_GROUP = 16
MAX_HEAD_DIM = 256
# the (group size, 128-wide head-dim slices) pairs the gate sends to the
# decode kernel, which builds every group up to 8 at hd 64-256 and up to 16
# at hd 64-128 (its query rows and accumulators live in registers)
_DECODE_BUILT = {(1, 1), (2, 1), (4, 1), (8, 1), (16, 1),
                 (1, 2), (2, 2), (4, 2), (8, 2)}
# keys a warp of the decode body stages and multiplies at once, and warps
# a block (kTile, kWarps in csrc/decode_attention.cuh)
TILE = 16
WARPS = 4
# blocks a (slot, kv head), at most (kMaxSpans)
MAX_SPANS = 64

_occupancy: Dict[tuple, int] = {}
# code storage the kernels read -> (kind name, KvKind of csrc/kv_storage.cuh)
KV_KINDS = {torch.bfloat16: ("bf16", 0), torch.float8_e5m2: ("fp8_e5m2", 1),
            torch.int8: ("int8", 2), torch.uint8: ("int4", 3)}


def kv_kind(k: torch.Tensor) -> Optional[str]:
    """Storage kind name of a code plane, None for one no kernel reads."""
    kind = KV_KINDS.get(k.dtype)
    return kind[0] if kind else None


def counter(base: str, kind: str) -> str:
    """Launch-counter name of kernel `base` on storage `kind`."""
    return base if kind == "bf16" else f"{base}_{kind}"


def kv_operands_ok(hd: int, k: torch.Tensor,
                   k_scale: Optional[torch.Tensor]) -> bool:
    """Codes of a known kind whose rows hold hd dims (int4: hd / 2
    bytes), with scales exactly for the scaled kinds (the JAX gate:
    bf16 and e5m2 pass without scales, int8 and int4 only with them)."""
    kind = kv_kind(k)
    if kind is None:
        return False
    width = hd // 2 if kind == "int4" else hd
    return k.shape[-1] == width and \
        (k_scale is not None) == (kind in SCALED_KV_DTYPES)


def check_kv_operands(fn: str, hd: int, k: torch.Tensor, v: torch.Tensor,
                      k_scale: Optional[torch.Tensor],
                      v_scale: Optional[torch.Tensor]) -> int:
    """Raise unless k/v are contiguous codes of one kind fitting hd, with
    contiguous f32 scales of shape k.shape[:-1] on their device exactly
    for the scaled kinds. Returns the kind's KvKind id."""
    kind = kv_kind(k)
    if k.shape != v.shape or k.dtype != v.dtype or kind is None \
            or not (k.is_contiguous() and v.is_contiguous()):
        raise ValueError(f"{fn}: k/v must be contiguous codes of one "
                         f"storage kind, got {k.dtype} {tuple(k.shape)} and "
                         f"{v.dtype} {tuple(v.shape)}")
    if (k_scale is None) != (v_scale is None) or \
            not kv_operands_ok(hd, k, k_scale):
        raise ValueError(f"{fn}: {kind} codes {tuple(k.shape)} do not fit "
                         f"hd={hd} with k_scale "
                         f"{'given' if k_scale is not None else 'None'} "
                         f"(int8/int4 need scales, bf16/fp8_e5m2 take none)")
    for name, s in (("k_scale", k_scale), ("v_scale", v_scale)):
        if s is not None and (s.dtype != torch.float32
                              or s.shape != k.shape[:-1]
                              or s.device != k.device
                              or not s.is_contiguous()):
            raise ValueError(f"{fn}: {name} must be contiguous float32 "
                             f"{tuple(k.shape[:-1])} on {k.device}")
    return KV_KINDS[k.dtype][1]


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def plan_spans(b: int, hkv: int, s: int, sms: int,
               slots: int) -> Tuple[int, int]:
    """(span, nspan) of a decode launch over `s` keys per slot: keys a
    block takes at a full cache (a multiple of ``TILE``) and blocks a
    (slot, kv head). The fewest blocks that put one on each of the `sms`
    SMs and all of them resident at once (`slots`, one wave), each with at
    least one tile a warp and at most ``MAX_SPANS`` a (slot, kv head),
    where the keys allow; a span never exceeds the keys. A block costs a
    few microseconds beyond its keys (the positions, the merges), so more
    blocks ran slower (tools/bench_attention.py sweeps the spans). On the
    card each slot's visible keys are cut evenly over its nspan blocks,
    again in whole tiles (the positions stay on the card), so a B5 tile
    never crosses a page, whose size is a multiple of ``TILE``."""
    tiles = -(-s // TILE)
    pairs = b * hkv
    want = max(1, min(-(-sms // pairs), slots // pairs))
    span_tiles = min(tiles, max(WARPS, -(-tiles // MAX_SPANS),
                                tiles // want))
    span = span_tiles * TILE
    return span, -(-s // span)


def decode_plan(b: int, hkv: int, s: int, kind: int, hd: int, group: int,
                device: torch.device) -> Tuple[int, int]:
    """``plan_spans`` on this card: its SMs and the decode body's resident
    blocks (the occupancy from B3's library, which B5's plan reads too, so
    both cut the keys alike)."""
    key = (kind, hd, group, device.index)
    occ = _occupancy.get(key)
    if occ is None:
        occ = _native.kernel("decode_attention",
                             "bigdl_decode_attention_blocks_per_sm")(
                                 kind, hd, group)
        if occ <= 0:
            raise RuntimeError(f"decode_attention: no body for kind {kind} "
                               f"hd {hd} group {group}")
        _occupancy[key] = occ
    sms = _sm_count(device)
    return plan_spans(b, hkv, s, sms, occ * sms)


def decode_buffers(b: int, h: int, hkv: int, hd: int, nspan: int,
                   device: torch.device):
    """(workspace, tickets) of a launch with `nspan` spans: the f32
    partials (m, l, acc[hd]) of every (slot, head, span) and one ticket a
    (slot, kv head); None for both with one span (each block writes its
    rows itself)."""
    if nspan == 1:
        return None, None
    ws = torch.empty((b * h * nspan * (hd + 2),), dtype=torch.float32,
                     device=device)
    return ws, ticket_buffer(device, b * hkv)


def _positions(pos, b: int, device) -> torch.Tensor:
    """Scalar or [B] positions -> contiguous int32 [B] on `device`. Inside
    a CUDA graph capture they must already be a tensor on `device`: a
    Python int or a host tensor would be copied once, at capture, and the
    graph would replay that position forever."""
    if (not (isinstance(pos, torch.Tensor) and pos.device == device)
            and torch.cuda.is_current_stream_capturing()):
        raise ValueError("attention positions must be a tensor on "
                         f"{device} inside a CUDA graph capture, got "
                         f"{type(pos).__name__}")
    p = torch.as_tensor(pos, device=device).to(torch.int32).reshape(-1)
    return p.expand(b).contiguous()


def plain_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos, scale: float,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Causal GQA attention against a (partly filled) cache: query i of
    slot b attends keys j <= q_pos[b] + i. q [B, Sq, H, D], k/v
    [B, Skv, Hkv, D] of any storage kind (int8/int4 with scales
    [B, Skv, Hkv]); q_pos scalar or [B]. K/V are dequantized to bf16
    (code times scale in f32), operands rounded to bf16, scores and
    softmax in f32, probabilities rounded to bf16 before the value product
    (the XLA body of ``sdp_attention``). Returns q.dtype."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    g = h // hkv
    f32, bf16 = torch.float32, torch.bfloat16
    qf = q.reshape(b, sq, hkv, g, d).to(bf16).to(f32)
    kf = dequantize_kv(k, k_scale, bf16).to(f32)
    vf = dequantize_kv(v, v_scale, bf16).to(f32)
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


def kernel_geometry_ok(q: torch.Tensor, k: torch.Tensor,
                       k_scale: Optional[torch.Tensor] = None) -> bool:
    """The shared gate of both attention kernels (``attention_geometry_ok``)
    plus the CUDA kernels' own group and head-dim limits."""
    h, hd = q.shape[2], q.shape[3]
    s, hkv = k.shape[1], k.shape[2]
    return (h % hkv == 0 and h // hkv <= MAX_GROUP and hd % 64 == 0
            and hd <= MAX_HEAD_DIM and s % 128 == 0
            and kv_operands_ok(hd, k, k_scale))


def decode_attention_supported(q: torch.Tensor, k: torch.Tensor,
                               k_scale: Optional[torch.Tensor] = None
                               ) -> bool:
    g, slices = q.shape[2] // k.shape[2], -(-q.shape[3] // 128)
    return q.shape[1] == 1 and kernel_geometry_ok(q, k, k_scale) \
        and (g, slices) in _DECODE_BUILT


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     q_pos, scale: float,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """B3: q [B, 1, H, hd] against the cache k/v [B, S, Hkv, hd] (codes
    of any storage kind; int8/int4 with f32 scales [B, S, Hkv]) at
    positions q_pos (scalar or [B]). Returns bf16 [B, 1, H, hd]."""
    if q.device.type == "cpu":
        return plain_attention(q, k, v, q_pos, scale, k_scale, v_scale)
    b, sq, h, hd = q.shape
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError("decode_attention: q, k, v must share one CUDA "
                         "device")
    if sq != 1:
        raise ValueError(f"decode_attention: Sq must be 1, got {sq}")
    if k.dim() != 4 or k.shape[0] != b:
        raise ValueError(f"decode_attention: cache shape {tuple(k.shape)} "
                         f"does not fit q {tuple(q.shape)}")
    check_kv_operands("decode_attention", hd, k, v, k_scale, v_scale)
    if not decode_attention_supported(q, k, k_scale):
        raise ValueError(
            f"decode_attention: unsupported geometry H={h} Hkv={k.shape[2]} "
            f"hd={hd} S={k.shape[1]} dtype={k.dtype}")
    if q.dtype != torch.bfloat16 or not q.is_contiguous():
        raise ValueError("decode_attention: q must be contiguous bfloat16")
    check_aligned("decode_attention", k, v)
    return _launch(q, k, v, _positions(q_pos, b, q.device), scale, k_scale,
                   v_scale)


def check_aligned(fn: str, k: torch.Tensor, v: torch.Tensor) -> None:
    """TMA reads the code planes: their base must be 16-byte aligned."""
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError(f"{fn}: k/v codes must start on a 16-byte "
                         "boundary")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            pos: torch.Tensor, scale: float,
            k_scale: Optional[torch.Tensor],
            v_scale: Optional[torch.Tensor],
            span: Optional[int] = None) -> torch.Tensor:
    """One B3 launch on checked operands (pos int32 [B]); `span` overrides
    the plan (tools/bench_attention.py sweeps it)."""
    b, _, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    kind = KV_KINDS[k.dtype][1]
    if span is None:
        span, nspan = decode_plan(b, hkv, s, kind, hd, h // hkv, q.device)
    else:
        nspan = -(-s // span)
    out = torch.empty_like(q)
    # the workspace stays referenced until the launch is queued
    ws, tickets = decode_buffers(b, h, hkv, hd, nspan, q.device)
    err = _native.kernel("decode_attention")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(k_scale),
        _ptr(v_scale), pos.data_ptr(), out.data_ptr(), _ptr(ws),
        _ptr(tickets), b, s, h, hkv, hd, kind, span, float(scale),
        _stream(q.device))
    _native.check("decode_attention", err)
    LAUNCHES[counter("decode_attention", kv_kind(k))] += 1
    return out
