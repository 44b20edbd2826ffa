"""A torch model of B4's arithmetic (``csrc/prefill_attention.cu``) and the
operands it is held to ``prefill_attention_pallas`` (interpret mode) on:
the comparison of tests/test_torch_prefill_hopper_model_pos0.py and
tests/test_torch_prefill_hopper_model_pos256.py (see
tests/test_torch_prefill_hopper.py for what it covers).
"""

import jax.numpy as jnp
import numpy as np
import torch

from bigdl_tpu.ops import kvcache as jkv
from bigdl_tpu.ops.pallas.prefill_attention import prefill_attention_pallas
from bigdl_tpu_torch import bridge
from bigdl_tpu_torch.ops.cuda import prefill_attention as pa
from bigdl_tpu_torch.ops.kvcache import unpack_int4

SMS = 132
KINDS = ("bf16", "fp8_e5m2", "int8", "int4")
ATOL = 3e-2          # the prefill tolerance of tests/test_torch_attention.py
LOG2E = 1.4426950408889634


def _code_values(c: torch.Tensor) -> torch.Tensor:
    """Exact f32 values of codes, before any scale."""
    if c.dtype == torch.uint8:
        return unpack_int4(c).float()
    return c.float()


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def model_prefill(q, kc, vc, ks, vs, pos: int, scale, nspan):
    """The kernel's arithmetic in torch: each block's 64 rows (head r //
    qt, query t * qt + r % qt) over its span of the tile's visible keys in
    64-key tiles, scores scale * log2(e) * k_scale * (q . c) in f32 over
    the exact codes, an online base-2 softmax, the probability times
    v_scale rounded to bf16 against the exact V codes, then the spans
    merged in order, each rescaled to the running max as it is added."""
    b, sq, h, hd = q.shape
    s, hkv = kc.shape[1], kc.shape[2]
    g = h // hkv
    qt, nqt, _ = pa.plan_prefill(b, h, hkv, sq, s, pos, SMS)
    kt = pa.KEY_TILE
    kf, vf = _code_values(kc), _code_values(vc)
    ksf = torch.ones(b, s, hkv) if ks is None else ks.float()
    vsf = torch.ones(b, s, hkv) if vs is None else vs.float()
    qf = q.float()
    out = torch.zeros(b, sq, h, hd)
    r = torch.arange(pa.ROWS)
    for bi in range(b):
        for kh in range(hkv):
            for t in range(nqt):
                heads, qidx = r // qt, t * qt + r % qt
                valid = (heads < g) & (qidx < sq)
                hh, qq = heads.clamp(max=g - 1), qidx.clamp(max=sq - 1)
                rows = qf[bi, qq, kh * g + hh]                    # [64, hd]
                parts = []
                for j0, j1 in pa.prefill_spans(t, qt, nspan, sq, s, pos):
                    m = torch.full((pa.ROWS,), -1e30)
                    l = torch.zeros(pa.ROWS)
                    acc = torch.zeros(pa.ROWS, hd)
                    for jt in range(j0, j1, kt):
                        keys = torch.arange(jt, jt + kt)
                        sc = rows @ kf[bi, keys, kh].T
                        sc = sc * (scale * LOG2E * ksf[bi, keys, kh])
                        vis = (keys[None] < j1) & (keys[None]
                                                   <= pos + qidx[:, None])
                        sc = torch.where(vis, sc, torch.tensor(-np.inf))
                        m_new = torch.maximum(m, sc.max(1).values)
                        corr = torch.exp2(m - m_new)
                        p = torch.exp2(sc - m_new[:, None])
                        l = l * corr + p.sum(1)
                        pv = _bf16(p * vsf[bi, keys, kh])
                        acc = acc * corr[:, None] + pv @ vf[bi, keys, kh]
                        m = m_new
                    parts.append((m, l, acc))
                if len(parts) == 1:
                    _, den, num = parts[0]
                else:   # in span order, rescaled to the running max
                    mx = torch.full((pa.ROWS,), -1e30)
                    den = torch.zeros(pa.ROWS)
                    num = torch.zeros(pa.ROWS, hd)
                    for m, l, acc in parts:
                        m_new = torch.maximum(mx, m)
                        f_old, f_new = torch.exp2(mx - m_new), torch.exp2(
                            m - m_new)
                        den = den * f_old + l * f_new
                        num = num * f_old[:, None] + acc * f_new[:, None]
                        mx = m_new
                o = num / torch.where(den > 0, den, 1.)[:, None]
                out[bi, qq[valid], kh * g + hh[valid]] = o[valid]
    return out.bfloat16()


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


def _assert_close(got: torch.Tensor, want) -> None:
    """Within 3e-2, the absolute part taken on each (query, head) row's
    own largest output (at least 1): at per-row scales up to 1e2 a row's
    outputs reach ~200, where one bf16 ulp is 1.0 and an output near zero
    is the difference of terms of that size, while a row of small-scale
    keys keeps outputs of order 1e-3 .. 1 and is held to 3e-2."""
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    top = np.maximum(1.0, np.abs(want).max(axis=-1, keepdims=True))
    err = np.abs(got - want)
    bad = err > ATOL * top + ATOL * np.abs(want)
    assert not bad.any(), (
        f"{int(bad.sum())} of {bad.size} outputs off; worst "
        f"{float((err - ATOL * top - ATOL * np.abs(want)).max())} past the "
        f"tolerance")


def check_model_matches_pallas(kind, h, hkv, hd, sq, pos):
    """The torch model at the engine's plan and at one span a tile
    against ``prefill_attention_pallas`` in interpret mode on the same
    codes and scales."""
    rng = np.random.default_rng(hd + 10 * h + hkv + len(kind) + sq + pos)
    b, s = 1, 512
    lo, hi = _RANGES[kind]
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    # scores of order one against the largest keys
    q *= 3.0 / 10.0 ** (hi + 0.5)
    q = np.asarray(jnp.asarray(q, jnp.bfloat16).astype(jnp.float32))
    jk, jks, tk, tks = _codes(_spread(rng, (b, s, hkv, hd), lo, hi), kind)
    jv, jvs, tv, tvs = _codes(_spread(rng, (b, s, hkv, hd), lo, hi), kind)
    if tks is not None:
        both = torch.cat([tks.flatten(), tvs.flatten()])
        assert both.min() < 1e-2 and both.max() > 1e1   # the scale range
    scale = hd ** -0.5
    # the engine's plan (the position on the card), and one span a tile
    plans = {pa.plan_prefill(b, h, hkv, sq, s, None, SMS)[2], 1}
    pal = prefill_attention_pallas(jnp.asarray(q, jnp.bfloat16), jk, jv,
                                   jnp.int32(pos), scale, interpret=True,
                                   k_scale=jks, v_scale=jvs)
    for nspan in sorted(plans):
        got = model_prefill(torch.tensor(q).bfloat16(), tk, tv, tks, tvs,
                            pos, scale, nspan)
        _assert_close(got, pal)
