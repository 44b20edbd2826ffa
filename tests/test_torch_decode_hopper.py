"""The one-launch decode attention body (``csrc/decode_attention.cuh``) of
B3 and B5 on the CPU.

The CUDA kernels cannot run here, so:
- the planner ``plan_spans`` is held to its promises at the main path's
  geometries (Llama-2-7B's 32 kv heads, Mixtral's 8, one slot and 32,
  short and long caches, a paged table): spans a multiple of the tile,
  a block on every SM and all of them in one wave where the keys allow,
  no tile across a page, workspace and tickets covering the plan;
- the wrappers run with the native library stood in for (as
  tests/test_torch_smallm.py does), and hand the entry point the planned
  span, one workspace of the planned size held through the launch, and
  the ticket buffer; one call is one native launch and one count;
- the sources have one kernel a call (no merge pass) and one shared body;
- a torch model of the kernel's arithmetic (scales folded out of the
  products, the planner's blocks with each slot's keys cut evenly over
  them, the warps' tiles, the fixed merge order)
  is held against the Pallas kernels in interpret mode at every storage
  kind, MHA and GQA, hd 64 and 128, with an idle slot and a position past
  the cache, at per-row scales from 1e-3 to 1e2, within the 2e-2 of
  tests/test_torch_kvcache.py (its absolute part on the output's scale,
  which those scales take to ~200). The kernel's numbers are held against
  the plain versions on the card by chip_smoke.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops import kvcache as jkv
from bigdl_tpu.ops.pallas.decode_attention import decode_attention_pallas
from bigdl_tpu.ops.pallas.paged_decode_attention import \
    paged_decode_attention_pallas
from bigdl_tpu_torch import _native, bridge
from bigdl_tpu_torch.ops.cuda import LAUNCHES
from bigdl_tpu_torch.ops.cuda import decode_attention as da
from bigdl_tpu_torch.ops.cuda import dequant_matmul as dm
from bigdl_tpu_torch.ops.cuda import paged_decode_attention as pda
from bigdl_tpu_torch.ops.kvcache import unpack_int4
from bigdl_tpu_torch.ops.paged import _gather_dense
from torch_threads import one_intra_op_thread  # noqa: F401

SMS = 132
KINDS = ("bf16", "fp8_e5m2", "int8", "int4")
ATOL = 2e-2          # as tests/test_torch_kvcache.py: same codes, f32 softmax
LOG2E = 1.4426950408889634


# ---------------------------------------------------------------------------
# the planner


@pytest.mark.parametrize("occ", [1, 3])
@pytest.mark.parametrize("b,hkv,s", [
    (8, 32, 2048),          # Llama-2-7B decode, max_seq 2048
    (8, 8, 2048),           # Mixtral-8x7B GQA
    (1, 32, 2048), (1, 8, 256), (32, 32, 2048), (32, 8, 256),
    (4, 8, 2048),           # Mixtral's gather engine, max_batch 4
    (1, 1, 32768),          # one slot, one kv head, a long cache
    (8, 32, 256), (8, 8, 16 * 128), (4, 2, 2 * 128),   # paged NP * ps
])
def test_plan_covers_the_card_in_one_wave(b, hkv, s, occ):
    slots = occ * SMS
    span, nspan = da.plan_spans(b, hkv, s, SMS, slots)
    tiles = -(-s // da.TILE)
    assert span % da.TILE == 0 and da.TILE <= span <= tiles * da.TILE
    assert nspan == -(-s // span) and (nspan - 1) * span < s
    assert nspan <= da.MAX_SPANS
    blocks = b * hkv * nspan
    floor = span == min(tiles, da.WARPS) * da.TILE   # a tile a warp
    top = nspan == -(-tiles // -(-tiles // da.MAX_SPANS))
    # one wave, unless one span a (slot, kv head) is already more
    assert blocks <= slots or nspan == 1
    # a block on every SM, unless the keys or the wave allow no more spans
    wave_full = b * hkv * (nspan + 1) > slots
    assert blocks >= SMS or floor or top or wave_full


@pytest.mark.parametrize("b,hkv,s,nspan", [(8, 32, 2048, 1), (8, 8, 2048, 4),
                                           (4, 8, 2048, 6)])
def test_plan_at_the_main_path(b, hkv, s, nspan):
    """Llama-2-7B's 256 (slot, kv head) pairs fill the 132 SMs alone;
    Mixtral's 64 (32 at max_batch 4) take several spans each."""
    assert da.plan_spans(b, hkv, s, SMS, 3 * SMS)[1] == nspan


def _slot_span(nvalid, nspan):
    """Keys a block takes on the card: a slot's visible keys cut evenly
    over its nspan blocks in whole tiles (decode_attention.cuh)."""
    per = -(-nvalid // nspan)
    return max(da.TILE, -(-per // da.TILE) * da.TILE)


@pytest.mark.parametrize("ps,np_", [(128, 16), (128, 2), (256, 8)])
@pytest.mark.parametrize("b,hkv", [(8, 32), (8, 8), (1, 8)])
def test_plan_tiles_never_cross_a_page(b, hkv, ps, np_):
    s = np_ * ps
    _, nspan = da.plan_spans(b, hkv, s, SMS, 3 * SMS)
    for nvalid in sorted({1, 15, 16, 17, ps - 1, ps + 1, s // 3, s - 1, s}):
        span = _slot_span(nvalid, nspan)
        live = -(-nvalid // span)
        assert live <= nspan and (live - 1) * span < nvalid <= live * span
        for j in range(0, nvalid, da.TILE):      # every tile a block stages
            assert j // ps == (j + da.TILE - 1) // ps


@pytest.mark.parametrize("b,h,hkv,hd,s", [(8, 32, 32, 128, 2048),
                                          (8, 32, 8, 128, 2048),
                                          (32, 32, 32, 128, 2048),
                                          (2, 8, 2, 64, 256)])
def test_buffers_cover_the_plan(b, h, hkv, hd, s, monkeypatch):
    monkeypatch.setattr(dm, "_tickets", {})
    span, nspan = da.plan_spans(b, hkv, s, SMS, 3 * SMS)
    ws, tickets = da.decode_buffers(b, h, hkv, hd, nspan, torch.device("cpu"))
    if nspan == 1:
        assert ws is None and tickets is None
    else:
        assert ws.dtype == torch.float32
        assert ws.numel() == b * h * nspan * (hd + 2)
        assert tickets.dtype == torch.int32 and tickets.numel() >= b * hkv
        assert not tickets.any()


# ---------------------------------------------------------------------------
# the wrappers with the native library stood in for


class _Lib:
    """Native libraries: occupancy queries answer `occ`, launches 0; every
    call is recorded with the buffers alive at that moment."""

    def __init__(self, occ):
        self.occ = occ
        self.calls = []

    def kernel(self, lib, sym=None):
        def fn(*args):
            self.calls.append((lib, sym, args))
            return self.occ if sym and sym.endswith("_blocks_per_sm") else 0
        return fn

    def launches(self):
        return [c for c in self.calls
                if not (c[1] or "").endswith("_blocks_per_sm")]


@pytest.fixture
def lib(monkeypatch):
    rec = _Lib(occ=3)
    monkeypatch.setattr(_native, "kernel", rec.kernel)
    monkeypatch.setattr(da, "_sm_count", lambda device: SMS)
    monkeypatch.setattr(da, "_occupancy", {})
    monkeypatch.setattr(dm, "_tickets", {})
    monkeypatch.setattr(da, "_stream", lambda device: 0)
    monkeypatch.setattr(pda, "_stream", lambda device: 0)
    made = []
    real = da.decode_buffers

    def buffers(*args):
        made.append(real(*args))
        return made[-1]

    monkeypatch.setattr(da, "decode_buffers", buffers)
    monkeypatch.setattr(pda, "decode_buffers", buffers)
    rec.buffers = made
    return rec


def _operands(b, h, hkv, hd, rows, kind):
    """q and zero K/V codes (and scales) of `kind` over `rows` rows: the
    stand-in library reads none of them."""
    q = torch.zeros((b, 1, h, hd), dtype=torch.bfloat16)
    dt = {"bf16": torch.bfloat16, "fp8_e5m2": torch.float8_e5m2,
          "int8": torch.int8, "int4": torch.uint8}[kind]
    width = hd // 2 if kind == "int4" else hd
    kc, vc = (torch.zeros((rows, hkv, width), dtype=dt) for _ in range(2))
    ks = vs = None
    if kind in ("int8", "int4"):
        ks, vs = (torch.ones((rows, hkv)) for _ in range(2))
    return q, kc, vc, ks, vs


def _check_launch(lib, entry, b, h, hkv, hd, s, out, nargs_ptr):
    """The one native launch of a wrapper call: the planned span, the
    workspace and tickets of the plan, alive and apart from out."""
    (call,) = lib.launches()
    assert call[0] == entry and call[1] is None
    args = call[2]
    span, nspan = da.plan_spans(b, hkv, s, SMS, 3 * SMS)
    ints = args[nargs_ptr:-2]
    assert ints[-1] == span and ints[-2] in range(4)
    (ws, tickets), = lib.buffers
    if nspan == 1:
        assert args[nargs_ptr - 2] is None and args[nargs_ptr - 1] is None
    else:
        assert args[nargs_ptr - 2] == ws.data_ptr()
        assert ws.numel() == b * h * nspan * (hd + 2)
        assert args[nargs_ptr - 1] == tickets.data_ptr()
        assert tickets.numel() >= b * hkv
        lo, hi = ws.data_ptr(), ws.data_ptr() + 4 * ws.numel()
        assert not lo <= out.data_ptr() < hi
    return span, nspan


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("b,h,hkv,hd,s", [(8, 32, 32, 128, 512),
                                          (8, 32, 8, 128, 512),
                                          (32, 32, 32, 128, 256),
                                          (2, 8, 2, 64, 256)])
def test_b3_launches_once_with_the_plan(lib, kind, b, h, hkv, hd, s):
    q, kc, vc, ks, vs = _operands(b, h, hkv, hd, b * s, kind)
    kc, vc = kc.reshape(b, s, hkv, -1), vc.reshape(b, s, hkv, -1)
    ks = None if ks is None else ks.reshape(b, s, hkv)
    vs = None if vs is None else vs.reshape(b, s, hkv)
    pos = torch.arange(b, dtype=torch.int32) * 7
    name = da.counter("decode_attention", kind)
    before = LAUNCHES[name]
    out = da._launch(q, kc, vc, pos, hd ** -0.5, ks, vs)
    assert LAUNCHES[name] == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    # q k v ks vs pos out ws tickets | B S H Hkv hd kind span | scale stream
    _check_launch(lib, "decode_attention", b, h, hkv, hd, s, out, 9)
    args = lib.launches()[0][2]
    assert args[9:14] == (b, s, h, hkv, hd)
    assert args[14] == da.KV_KINDS[kc.dtype][1]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("b,h,hkv,hd,ps,np_", [(8, 32, 32, 128, 128, 4),
                                               (8, 32, 8, 128, 128, 4),
                                               (2, 8, 2, 64, 128, 2)])
def test_b5_launches_once_with_b3s_plan(lib, kind, b, h, hkv, hd, ps, np_):
    p_ = b * np_ + 1
    q, ak, av, aks, avs = _operands(b, h, hkv, hd, p_ * ps, kind)
    ak, av = ak.reshape(p_, ps, hkv, -1), av.reshape(p_, ps, hkv, -1)
    aks = None if aks is None else aks.reshape(p_, ps, hkv)
    avs = None if avs is None else avs.reshape(p_, ps, hkv)
    bt = (torch.arange(b * np_, dtype=torch.int32) + 1).reshape(b, np_)
    pos = torch.full((b,), ps + 3, dtype=torch.int32)
    name = da.counter("paged_decode_attention", kind)
    before = LAUNCHES[name]
    out = pda._launch(q, ak, av, bt, pos, hd ** -0.5, aks, avs)
    assert LAUNCHES[name] == before + 1
    # q k v ks vs bt pos out ws tickets | B P ps NP H Hkv hd kind span | ..
    _check_launch(lib, "paged_decode_attention", b, h, hkv, hd, np_ * ps,
                  out, 10)
    args = lib.launches()[0][2]
    assert args[10:17] == (b, p_, ps, np_, h, hkv, hd)
    # the occupancy both plan with is B3's library's
    assert {c[:2] for c in lib.calls if c[1]} == {
        ("decode_attention", "bigdl_decode_attention_blocks_per_sm")}


def test_wrappers_refuse_misaligned_codes():
    with pytest.raises(ValueError, match="16-byte"):
        flat = torch.zeros(4 * 128 * 2 * 64 + 1, dtype=torch.uint8)
        k = flat[1:].view(4, 128, 2, 64)
        da.check_aligned("decode_attention", k, k)


# ---------------------------------------------------------------------------
# the sources


def _src(name):
    with open(os.path.join(_native.CSRC, name)) as f:
        return f.read()


def test_one_kernel_a_call_and_one_shared_body():
    hdr = _src("decode_attention.cuh")
    assert hdr.count("__global__") == 1
    assert "atomicAdd(ticket" in hdr and "*ticket = 0u" in hdr
    assert "tma_2d" in hdr and "mbar_wait" in hdr and "mma_bf16" in hdr
    for fn in os.listdir(_native.CSRC):
        assert "decode_attention_combine" not in _src(fn), fn
    for fn in ("decode_attention.cu", "paged_decode_attention.cu"):
        src = _src(fn)
        assert '#include "decode_attention.cuh"' in src
        assert "<<<" not in src and "__global__" not in src


def test_built_set_keeps_every_earlier_geometry():
    earlier = {(1, 1), (2, 1), (4, 1), (8, 1), (16, 1),
               (1, 2), (2, 2), (4, 2), (8, 2)}
    assert da._DECODE_BUILT >= earlier
    # the body builds every group to 8 at hd <= 256, to 16 at hd <= 128
    for g, slices in da._DECODE_BUILT:
        assert g <= (16 if slices == 1 else 8)
    # B4 stays built at hd 64 / 128 / 256 for all four storage kinds
    from bigdl_tpu_torch.ops.cuda import prefill_attention as pa
    assert set(pa.HEAD_DIMS) >= {64, 128, 256}
    src = _src("prefill_attention.cu")
    for hd in (64, 128, 256):
        assert f"case {hd}: return launch_one<KIND, {hd}>" in src
    for kind in ("KV_BF16", "KV_E5M2", "KV_INT8", "KV_INT4"):
        assert f"case {kind}: return launch_hd<{kind}>" in src


# ---------------------------------------------------------------------------
# a torch model of the kernel's arithmetic against the Pallas kernels


def _code_values(c: torch.Tensor) -> torch.Tensor:
    """Exact f32 values of codes, before any scale."""
    if c.dtype == torch.uint8:
        return unpack_int4(c).float()
    return c.float()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def model_decode(q, kc, vc, ks, vs, pos, scale, nspan):
    """The kernel's arithmetic in torch over dense rows [B, S, Hkv, hd]:
    each slot's visible keys cut evenly over `nspan` blocks in whole tiles,
    scores scale * log2(e) * k_scale * (q . c) in f32, each warp's tiles
    (tile i of a span to warp i % 4) in an online base-2 softmax, the
    probability times v_scale rounded to bf16 against the exact V codes,
    the warps merged in order, then the live spans in order."""
    b, _, h, hd = q.shape
    s, hkv = kc.shape[1], kc.shape[2]
    g = h // hkv
    kf, vf = _code_values(kc), _code_values(vc)
    ksf = torch.ones(b, s, hkv) if ks is None else ks.float()
    vsf = torch.ones(b, s, hkv) if vs is None else vs.float()
    qf = q.float().reshape(b, hkv, g, hd)
    out = torch.zeros(b, hkv, g, hd)
    tile, warps = da.TILE, da.WARPS

    def merge(parts):
        mx = torch.stack([m for m, _, _ in parts]).max(0).values
        num = torch.zeros(g, hd)
        den = torch.zeros(g)
        for m, l, acc in parts:
            f = torch.exp2(m - mx)
            den = den + l * f
            num = num + acc * f[:, None]
        return mx, den, num

    for bi in range(b):
        nvalid = max(0, min(int(pos[bi]) + 1, s))
        span = _slot_span(nvalid, nspan)
        live = max(1, -(-nvalid // span))
        for kh in range(hkv):
            spans = []
            for sp in range(live):
                j0, j1 = sp * span, min((sp + 1) * span, nvalid)
                ntiles = -(-(j1 - j0) // tile) if j1 > j0 else 0
                warp_parts = []
                for w in range(warps):
                    m = torch.full((g,), -1e30)
                    l = torch.zeros(g)
                    acc = torch.zeros(g, hd)
                    for t in range(w, ntiles, warps):
                        jt = j0 + t * tile
                        keys = torch.arange(jt, jt + tile)
                        vis = keys < j1
                        kk = keys.clamp(max=s - 1)
                        dot = qf[bi, kh] @ kf[bi, kk, kh].T          # [g, 16]
                        sc = dot * (scale * LOG2E) * ksf[bi, kk, kh]
                        sc = torch.where(vis, sc, torch.tensor(-np.inf))
                        m_new = torch.maximum(m, sc.max(1).values)
                        corr = torch.exp2(m - m_new)
                        p = torch.exp2(sc - m_new[:, None])
                        l = l * corr + p.sum(1)
                        pv = _bf16(p * torch.where(vis, vsf[bi, kk, kh], 0.))
                        vrows = torch.where(vis[:, None], vf[bi, kk, kh], 0.)
                        acc = acc * corr[:, None] + pv @ vrows
                        m = m_new
                    warp_parts.append((m, l, acc))
                spans.append(merge(warp_parts))
            _, den, num = merge(spans)
            out[bi, kh] = num / torch.where(den > 0, den, 1.)[:, None]
    return out.reshape(b, 1, h, hd).bfloat16()


def _spread(rng, shape, lo, hi):
    """Normal values, each (row, head) vector scaled by 10**U(lo, hi), in
    bf16: int8 / int4 scales of absmax / 127 or / 7 from ~1e-3 to ~1e2."""
    x = rng.standard_normal(shape).astype(np.float32)
    x *= 10.0 ** rng.uniform(lo, hi, shape[:-1] + (1,))
    return np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


_RANGES = {"bf16": (-1.0, 2.0), "fp8_e5m2": (-1.0, 2.0),
           "int8": (-1.4, 3.4), "int4": (-2.6, 2.4)}


def _codes(x, kind):
    xb = jnp.asarray(x, jnp.bfloat16)
    if kind in ("int8", "int4"):
        jc, js = jkv.quantize_kv(xb, jkv.KV_CACHE_DTYPES[kind])
    else:
        jc, js = xb.astype(jkv.KV_CACHE_DTYPES[kind]), None
    tc = bridge.kv_plane_from_numpy(np.asarray(jc), "cpu")
    ts = None if js is None else bridge.kv_plane_from_numpy(np.asarray(js),
                                                            "cpu")
    return jc, js, tc, ts


def _query(rng, b, h, hd, kind):
    """Queries small enough that scores stay of order one against the
    largest keys (softmax weights spread over many keys)."""
    q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    q *= 3.0 / 10.0 ** (_RANGES[kind][1] + 0.5)
    return np.asarray(jnp.asarray(q, jnp.bfloat16).astype(jnp.float32))


def _assert_close(got: torch.Tensor, want) -> None:
    """Within 2e-2, the absolute part taken on the output's scale: at
    per-row scales up to 1e2 the outputs reach ~200, where one bf16 ulp is
    1.0 and an output near zero is the difference of terms of that size
    (the plain version, which rounds as the Pallas kernels do, is itself
    1.0 from them there)."""
    want = np.asarray(want, np.float32)
    top = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=ATOL,
                               atol=ATOL * top)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("plan", ["planned", "one span"])
def test_model_matches_pallas_interpret(kind, h, hkv, hd, plan):
    rng = np.random.default_rng(hd + 10 * h + hkv + len(kind))
    b, s = 3, 256
    lo, hi = _RANGES[kind]
    q = _query(rng, b, h, hd, kind)
    jk, jks, tk, tks = _codes(_spread(rng, (b, s, hkv, hd), lo, hi), kind)
    jv, jvs, tv, tvs = _codes(_spread(rng, (b, s, hkv, hd), lo, hi), kind)
    if tks is not None:
        both = torch.cat([tks.flatten(), tvs.flatten()])
        assert both.min() < 1e-2 and both.max() > 1e1   # the scale range
    pos = np.array([s - 1, 77, s + 40], np.int32)      # last slot idle
    scale = hd ** -0.5
    nspan = (da.plan_spans(b, hkv, s, SMS, 2 * SMS)[1] if plan == "planned"
             else 1)
    got = model_decode(torch.tensor(q).bfloat16(), tk, tv, tks, tvs,
                       torch.tensor(pos), scale, nspan)
    pal = decode_attention_pallas(jnp.asarray(q, jnp.bfloat16), jk, jv,
                                  jnp.asarray(pos), scale, interpret=True,
                                  k_scale=jks, v_scale=jvs)
    _assert_close(got, pal)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2)])
def test_paged_model_matches_pallas_interpret(kind, h, hkv):
    rng = np.random.default_rng(50 + h + hkv + len(kind))
    b, hd, ps, np_, p = 2, 64, 128, 2, 5
    lo, hi = _RANGES[kind]
    q = _query(rng, b, h, hd, kind)
    jk, jks, tk, tks = _codes(_spread(rng, (p, ps, hkv, hd), lo, hi), kind)
    jv, jvs, tv, tvs = _codes(_spread(rng, (p, ps, hkv, hd), lo, hi), kind)
    bt = np.stack([rng.permutation(np.arange(1, p))[:np_],
                   np.zeros(np_, np.int64)]).astype(np.int32)
    pos = np.array([200, np_ * ps + 9], np.int32)      # row 1 idle
    tbt = torch.from_numpy(bt)
    nspan = da.plan_spans(b, hkv, np_ * ps, SMS, 2 * SMS)[1]

    def dense(t):
        return None if t is None else _gather_dense(t, tbt)

    got = model_decode(torch.tensor(q).bfloat16(), dense(tk), dense(tv),
                       dense(tks), dense(tvs), torch.tensor(pos),
                       hd ** -0.5, nspan)
    pal = paged_decode_attention_pallas(jnp.asarray(q, jnp.bfloat16), jk, jv,
                                        jnp.asarray(bt), jnp.asarray(pos),
                                        hd ** -0.5, interpret=True,
                                        k_scale=jks, v_scale=jvs)
    _assert_close(got, pal)
