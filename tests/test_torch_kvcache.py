"""bigdl_tpu_torch's quantized KV cache (fp8_e5m2, int8, int4) against the
JAX package.

Inputs are drawn with numpy from fixed seeds and handed to both packages;
the JAX package's codes reach the port through ``bridge.py``, so every
comparison is on the same bytes.

- ``quantize_kv`` codes and scales are the JAX package's bits (zero
  vectors included); fp8 storage bytes equal ``astype(float8_e5m2)``.
- ``update_layer`` / ``paged_update_layer`` (and the copy-on-write and
  prefix-seeding gathers) leave bit-identical code and scale planes, at
  scalar, per-slot and clamped positions; byte counts equal
  ``kv_cache_nbytes`` / ``paged_cache_nbytes``.
- The port's plain attention over codes and scales (what B3, B4 and B5
  run on CPU tensors) agrees with ``sdp_attention(backend="xla")`` and
  with the Pallas bodies in interpret mode (``_kernel`` with e5m2 input,
  ``_kernel_scaled``, ``_kernel_blocked_scaled``, prefill
  ``_kernel_scaled``, ``_paged_kernel_scaled``) within 2e-2; paged output
  equals slab output byte for byte.
- Greedy and seeded streams of the port's engine equal the JAX engine's
  on TINY_LLAMA for every kind, in the slab and in the paged engine with
  prefix sharing; tiny Mixtral at int8 gives the JAX engine's greedy
  streams; a family without ``SUPPORTS_SCALED_KV`` is refused int8.
- Wrappers given ``device="meta"`` tensors of any kind raise.
"""

import types
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models import mixtral as jmx
from bigdl_tpu.models.mixtral import MixtralConfig as JaxMixtralConfig
from bigdl_tpu.ops import kvcache as jkv
from bigdl_tpu.ops import paged as jpaged
from bigdl_tpu.ops.attention import sdp_attention as jax_sdp
from bigdl_tpu.ops.attention import sdp_attention_paged as jax_sdp_paged
from bigdl_tpu.ops.pallas import decode_attention as jda
from bigdl_tpu.ops.pallas.paged_decode_attention import \
    paged_decode_attention_pallas
from bigdl_tpu.ops.pallas.prefill_attention import prefill_attention_pallas
from bigdl_tpu.serving.engine import EngineConfig as JaxEngineConfig
from bigdl_tpu.serving.engine import LLMEngine as JaxLLMEngine
from bigdl_tpu.serving.engine import SamplingParams as JaxSamplingParams
from bigdl_tpu.utils.testing import random_mixtral_params as jax_random_mixtral
from bigdl_tpu.utils.testing import tiny_random_model
from bigdl_tpu_torch import bridge
from bigdl_tpu_torch.models import llama as tllama
from bigdl_tpu_torch.models import mixtral as tmx
from bigdl_tpu_torch.models.mixtral import MixtralConfig
from bigdl_tpu_torch.ops import attention as tatt
from bigdl_tpu_torch.ops import kvcache as tkv
from bigdl_tpu_torch.ops import paged as tpaged
from bigdl_tpu_torch.ops.cuda import decode_attention as tdec
from bigdl_tpu_torch.ops.cuda import paged_decode_attention as tb5
from bigdl_tpu_torch.ops.cuda import prefill_attention as tpre
from bigdl_tpu_torch.serving.engine import (EngineConfig, LLMEngine,
                                            SamplingParams)
from bigdl_tpu_torch.utils.testing import TINY_LLAMA, SyntheticCausalLM
from torch_threads import one_intra_op_thread  # noqa: F401

KINDS = ("fp8_e5m2", "int8", "int4")
SCALED = ("int8", "int4")
ATOL = 2e-2          # plain vs XLA / interpret: same codes, f32 softmax


def _np_plane(a) -> np.ndarray:
    """A JAX plane in ``bridge.kv_plane_to_numpy``'s form."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16)
    if a.dtype.name == "float8_e5m2":
        return a.view(np.uint8)
    if a.dtype.name == "int4":
        return a.astype(np.int8)
    return a


def _assert_planes_equal(tplanes, jplanes):
    for t, j in zip(tplanes, jplanes):
        assert (t is None) == (j is None)
        if t is not None:
            np.testing.assert_array_equal(bridge.kv_plane_to_numpy(t),
                                          _np_plane(j))


def _bf16_data(rng, *shape, zero_rows=False, spread=True):
    """f32 numpy values with bf16 bits: standard normal, with each [.., D]
    vector scaled by a power of ten in [1e-2, 10] when `spread`; some
    whole vectors zero when asked."""
    x = rng.standard_normal(shape).astype(np.float32)
    if spread:
        x *= 10.0 ** rng.integers(-2, 2, shape[:-1] + (1,))
    if zero_rows:
        x[..., ::7, :, :] = 0.0
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _unit(rng, *shape):
    """Unit-scale data for the attention tests (outputs of order 1)."""
    return _bf16_data(rng, *shape, spread=False)


def _codes(x: np.ndarray, kind: str):
    """JAX codes (and scales) of f32 values x in storage `kind`, and the
    same bytes as port tensors on the CPU."""
    xb = jnp.asarray(x, jnp.bfloat16)
    if kind in SCALED:
        jc, js = jkv.quantize_kv(xb, jkv.KV_CACHE_DTYPES[kind])
    else:
        jc, js = xb.astype(jkv.KV_CACHE_DTYPES[kind]), None
    tc = bridge.kv_plane_from_numpy(np.asarray(jc), "cpu")
    ts = None if js is None else bridge.kv_plane_from_numpy(np.asarray(js),
                                                            "cpu")
    return jc, js, tc, ts


# ---------------------------------------------------------------------------
# names, quantization and storage


def test_resolve_kv_cache_dtype_and_guard():
    r = tkv.resolve_kv_cache_dtype
    for spec in ("bf16", "bfloat16", None, False):
        assert r(spec) == jkv.resolve_kv_cache_dtype(spec) == "bf16"
    for spec in ("fp8", "E5M2", "float8_e5m2", " fp8_e5m2 ", "int8", "int4"):
        assert r(spec) == jkv.resolve_kv_cache_dtype(spec)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert r(True) == "fp8_e5m2"
    with pytest.raises(ValueError, match="unknown kv_cache_dtype"):
        r("int2")
    with pytest.raises(NotImplementedError, match="int8/int4"):
        tkv.reject_scaled_kv("int4", "gpt2")
    tkv.reject_scaled_kv("fp8", "gpt2")
    assert [tkv.kv_dtype_name(tkv.KV_CACHE_DTYPES[k]) for k in KINDS] == \
        list(KINDS)


@pytest.mark.parametrize("kind", SCALED)
def test_quantize_kv_bits_match_jax(kind):
    rng = np.random.default_rng(1 if kind == "int8" else 2)
    x = _bf16_data(rng, 3, 21, 2, 64, zero_rows=True)
    jc, js = jkv.quantize_kv(jnp.asarray(x, jnp.bfloat16),
                             jkv.KV_CACHE_DTYPES[kind])
    tc, ts = tkv.quantize_kv(torch.from_numpy(x).to(torch.bfloat16), kind)
    assert tc.shape == ((3, 21, 2, 32) if kind == "int4" else x.shape)
    np.testing.assert_array_equal(bridge.kv_plane_to_numpy(tc),
                                  _np_plane(jc))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ts.numpy()[:, ::7] == 0).all()
    # packing: dim 2i in the low nibble of byte i, two's complement
    codes = torch.tensor([[-8, 7, -1, 0, 3, -3]], dtype=torch.int8)
    assert tkv.pack_int4(codes).tolist() == [[0x78, 0x0F, 0xD3]]
    assert torch.equal(tkv.unpack_int4(tkv.pack_int4(codes)), codes)
    # dequantization: code times scale in f32, rounded to bf16
    got = tkv.dequantize_kv(tc, ts)
    want = jkv.dequantize_kv(jc, js)
    np.testing.assert_array_equal(bridge.kv_plane_to_numpy(got),
                                  _np_plane(want))


def test_fp8_storage_bytes_match_jax():
    rng = np.random.default_rng(3)
    x = _bf16_data(rng, 2, 9, 2, 16)
    x[0, 0, 0, :4] = [0.0, -0.0, 1e-7, 6e4]     # zero, subnormal, overflow
    _, _, tc, _ = _codes(x, "fp8_e5m2")
    want = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float8_e5m2))
    got = torch.from_numpy(x).to(torch.bfloat16).to(torch.float8_e5m2)
    np.testing.assert_array_equal(bridge.kv_plane_to_numpy(got),
                                  want.view(np.uint8))
    np.testing.assert_array_equal(bridge.kv_plane_to_numpy(tc),
                                  want.view(np.uint8))


@pytest.mark.parametrize("kind", ("bf16",) + KINDS)
def test_init_cache_bytes_and_bridge_match_jax(kind):
    geo = (2, 3, 128, 2, 64)
    jc = jkv.init_cache(*geo, kv_cache_dtype=kind, per_slot_pos=True)
    tc = tkv.init_cache(*geo, kv_cache_dtype=kind, per_slot_pos=True,
                        device="cpu")
    want = jkv.kv_cache_nbytes(*geo, kv_cache_dtype=kind)
    assert tkv.kv_cache_bytes(tc) == tkv.kv_cache_nbytes(
        *geo, kv_cache_dtype=kind) == want == jkv.kv_cache_bytes(jc)
    pgeo = (2, 7, 16, 2, 64)
    jp = jpaged.init_paged_cache(*pgeo, batch=3, kv_cache_dtype=kind)
    tp = tpaged.init_paged_cache(*pgeo, batch=3, kv_cache_dtype=kind,
                                 device="cpu")
    assert tpaged.paged_cache_bytes(tp) == tpaged.paged_cache_nbytes(
        *pgeo, kv_cache_dtype=kind) == jpaged.paged_cache_nbytes(
        *pgeo, kv_cache_dtype=kind) == jpaged.paged_cache_bytes(jp)
    assert tc.kv_dtype == tp.kv_dtype == kind
    # JAX caches (with data) cross the bridge and come back unchanged
    rng = np.random.default_rng(4)
    x = _bf16_data(rng, 3, 5, 2, 64)
    planes = jkv.update_layer(jc.k, jc.v, 1, jnp.asarray(x, jnp.bfloat16),
                              jnp.asarray(-x, jnp.bfloat16),
                              jnp.asarray([0, 7, 120], jnp.int32),
                              jc.k_scale, jc.v_scale)
    jc = jkv.KVCache(planes[0], planes[1], jc.pos, *planes[2:])
    back = bridge.kv_cache_from_numpy(jax.tree.map(np.asarray, jc), "cpu")
    assert isinstance(back, tkv.KVCache)
    got = bridge.kv_cache_to_numpy(back)
    for f in ("k", "v", "pos", "k_scale", "v_scale"):
        j = getattr(jc, f)
        assert (got[f] is None) == (j is None)
        if j is not None:
            np.testing.assert_array_equal(got[f], _np_plane(j))
    pback = bridge.kv_cache_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    assert isinstance(pback, tpaged.PagedKVCache) and pback.kv_dtype == kind


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("pos", [
    np.int32(5), np.int32(126),                 # 126 + 4 > 128: clamped
    np.array([0, 3, 125, 400], np.int32)])      # per slot, two clamped
def test_update_layer_planes_match_jax(kind, pos):
    rng = np.random.default_rng(int(np.sum(pos)) + len(kind))
    layers, b, s, hkv, hd = 2, 4, 128, 2, 64
    per_slot = np.ndim(pos) == 1
    jc = jkv.init_cache(layers, b, s, hkv, hd, kv_cache_dtype=kind,
                        per_slot_pos=per_slot)
    tc = tkv.init_cache(layers, b, s, hkv, hd, kv_cache_dtype=kind,
                        per_slot_pos=per_slot, device="cpu")
    s_new = 1 if per_slot else 4
    for layer, sign in ((1, 1.0), (0, -2.0)):
        new_k = _bf16_data(rng, b, s_new, hkv, hd) * sign
        new_v = _bf16_data(rng, b, s_new, hkv, hd)
        jplanes = jkv.update_layer(
            jc.k, jc.v, layer, jnp.asarray(new_k, jnp.bfloat16),
            jnp.asarray(new_v, jnp.bfloat16), jnp.asarray(pos), jc.k_scale,
            jc.v_scale)
        jc = jkv.KVCache(jplanes[0], jplanes[1], jc.pos, *jplanes[2:])
        tplanes = tkv.update_layer(
            tc.k, tc.v, layer, torch.from_numpy(new_k).to(torch.bfloat16),
            torch.from_numpy(new_v).to(torch.bfloat16),
            torch.from_numpy(np.asarray(pos)), tc.k_scale, tc.v_scale)
        assert len(tplanes) == len(jplanes) == (4 if kind in SCALED else 2)
    _assert_planes_equal((tc.k, tc.v, tc.k_scale, tc.v_scale),
                         (jc.k, jc.v, jc.k_scale, jc.v_scale))
    # the dequantizing read of the XLA fallback, bit for bit
    rk, rv = tkv.read_layer(tc.k, tc.v, 1, cache_ks=tc.k_scale,
                            cache_vs=tc.v_scale)
    jrk, jrv = jkv.read_layer(jc.k, jc.v, 1, cache_ks=jc.k_scale,
                              cache_vs=jc.v_scale)
    _assert_planes_equal((rk, rv), (jrk, jrv))
    if kind in SCALED:
        q = tkv.read_layer_quantized(tc.k, tc.v, tc.k_scale, tc.v_scale, 1)
        jq = jkv.read_layer_quantized(jc.k, jc.v, jc.k_scale, jc.v_scale, 1)
        _assert_planes_equal(q, jq)


@pytest.mark.parametrize("kind", KINDS)
def test_paged_planes_match_jax(kind):
    rng = np.random.default_rng(5 + len(kind))
    layers, p, ps, hkv, hd, np_ = 2, 9, 16, 2, 64, 4
    jc = jpaged.init_paged_cache(layers, p, ps, hkv, hd, 3,
                                 kv_cache_dtype=kind)
    tc = tpaged.init_paged_cache(layers, p, ps, hkv, hd, 3,
                                 kv_cache_dtype=kind, device="cpu")
    bt = np.zeros((3, np_), np.int32)
    bt[0] = [3, 7, 1, 0]            # two pages unallocated
    bt[1] = [2, 8, 5, 6]
    pos = np.array([13, 61, 70], np.int32)   # row 2 idle, past the table
    for layer, s_new in ((1, 3), (0, 1), (1, 2)):
        new_k = _bf16_data(rng, 3, s_new, hkv, hd)
        new_v = _bf16_data(rng, 3, s_new, hkv, hd)
        jplanes = jpaged.paged_update_layer(
            jc.k, jc.v, layer, jnp.asarray(new_k, jnp.bfloat16),
            jnp.asarray(new_v, jnp.bfloat16), jnp.asarray(pos),
            jnp.asarray(bt), jc.k_scale, jc.v_scale)
        jc = jpaged.PagedKVCache(jplanes[0], jplanes[1], jc.pos,
                                 *jplanes[2:])
        tpaged.paged_update_layer(
            tc.k, tc.v, layer, torch.from_numpy(new_k).to(torch.bfloat16),
            torch.from_numpy(new_v).to(torch.bfloat16),
            torch.from_numpy(pos), torch.from_numpy(bt), tc.k_scale,
            tc.v_scale)
        pos = pos + s_new
    tplanes = (tc.k, tc.v, tc.k_scale, tc.v_scale)
    jplanes = (jc.k, jc.v, jc.k_scale, jc.v_scale)
    _assert_planes_equal(tplanes, jplanes)
    tbt, jbt = torch.from_numpy(bt[:2]), jnp.asarray(bt[:2])
    _assert_planes_equal(
        tpaged.paged_read_layer(tc.k, tc.v, 1, tbt, cache_ks=tc.k_scale,
                                cache_vs=tc.v_scale),
        jpaged.paged_read_layer(jc.k, jc.v, 1, jbt, cache_ks=jc.k_scale,
                                cache_vs=jc.v_scale))
    if kind in SCALED:
        _assert_planes_equal(
            tpaged.paged_read_layer_quantized(*tplanes, 1, tbt),
            jpaged.paged_read_layer_quantized(*jplanes, 1, jbt))
    pages = np.array([3, 1, 4], np.int32)
    _assert_planes_equal(
        tpaged.gather_pages_dense(tc.k, tc.v, torch.from_numpy(pages),
                                  tc.k_scale, tc.v_scale),
        jpaged.gather_pages_dense(jc.k, jc.v, jnp.asarray(pages),
                                  jc.k_scale, jc.v_scale))
    srcs, dsts = np.array([4, 1, 0], np.int32), np.array([1, 5, 0], np.int32)
    tpaged.cow_copy_pages(tc.k, tc.v, torch.from_numpy(srcs),
                          torch.from_numpy(dsts), tc.k_scale, tc.v_scale)
    jout = jpaged.cow_copy_pages(jc.k, jc.v, jnp.asarray(srcs),
                                 jnp.asarray(dsts), jc.k_scale, jc.v_scale)
    _assert_planes_equal(tplanes, tuple(jout) + (None,) * (4 - len(jout)))


def test_init_rejects_odd_int4_head_dim_and_non_bf16_compute():
    with pytest.raises(ValueError, match="even head_dim"):
        tkv.init_cache(1, 1, 8, 1, 7, kv_cache_dtype="int4", device="cpu")
    with pytest.raises(NotImplementedError):
        tpaged.init_paged_cache(1, 2, 16, 1, 8, 1, dtype=torch.float16,
                                kv_cache_dtype="int8", device="cpu")


# ---------------------------------------------------------------------------
# attention over codes (the plain versions the wrappers run on the CPU)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("h,hkv,per_slot", [(8, 2, True), (4, 4, False)])
def test_decode_matches_xla_and_pallas_interpret(kind, h, hkv, per_slot):
    rng = np.random.default_rng(h + hkv + per_slot + len(kind))
    b, s, hd = 2, 256, 64
    q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    jk, jks, tk, tks = _codes(_unit(rng, b, s, hkv, hd), kind)
    jv, jvs, tv, tvs = _codes(_unit(rng, b, s, hkv, hd), kind)
    pos_np = np.array([s - 1, 97], np.int32) if per_slot else np.int32(130)
    jq, tq = jnp.asarray(q, jnp.bfloat16), torch.from_numpy(q).bfloat16()
    jpos, tpos = jnp.asarray(pos_np), torch.from_numpy(np.asarray(pos_np))
    scale = hd ** -0.5
    got = tdec.decode_attention(tq, tk, tv, tpos, scale, tks, tvs).float()
    assert got.shape == (b, 1, h, hd)
    xla = jax_sdp(jq, jk, jv, jpos, backend="xla", k_scale=jks, v_scale=jvs)
    pal = jda.decode_attention_pallas(jq, jk, jv, jpos, scale, interpret=True,
                                      k_scale=jks, v_scale=jvs)
    for want in (xla, pal):
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   rtol=ATOL, atol=ATOL)
    # the gate sends these operands to B3 (its CPU path is the plain one)
    assert tdec.decode_attention_supported(tq, tk, tks)
    assert torch.equal(tatt.sdp_attention(tq, tk, tv, tpos, k_scale=tks,
                                          v_scale=tvs).float(), got)


@pytest.mark.parametrize("kind", SCALED)
def test_decode_blocked_scaled_matches_pallas_interpret(kind, monkeypatch):
    monkeypatch.setattr(jda, "_RESIDENT_MAX", 256)
    rng = np.random.default_rng(6 + len(kind))
    b, s, h, hkv, hd = 3, 640, 4, 2, 64
    q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    jk, jks, tk, tks = _codes(_unit(rng, b, s, hkv, hd), kind)
    jv, jvs, tv, tvs = _codes(_unit(rng, b, s, hkv, hd), kind)
    pos = np.array([5, 300, 639], np.int32)
    scale = hd ** -0.5
    got = tdec.decode_attention(torch.from_numpy(q).bfloat16(), tk, tv,
                                torch.from_numpy(pos), scale, tks, tvs)
    pal = jda.decode_attention_pallas(jnp.asarray(q, jnp.bfloat16), jk, jv,
                                      jnp.asarray(pos), scale, interpret=True,
                                      k_scale=jks, v_scale=jvs)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(pal, np.float32), rtol=ATOL,
                               atol=ATOL)


@pytest.mark.parametrize("kind", KINDS)
def test_prefill_matches_xla_and_pallas_interpret(kind):
    rng = np.random.default_rng(7 + len(kind))
    b, sq, smax, h, hkv, hd, p0 = 1, 128, 256, 4, 2, 64, 100
    q = rng.standard_normal((b, sq, h, hd)).astype(np.float32)
    jk, jks, tk, tks = _codes(_unit(rng, b, smax, hkv, hd), kind)
    jv, jvs, tv, tvs = _codes(_unit(rng, b, smax, hkv, hd), kind)
    jq, tq = jnp.asarray(q, jnp.bfloat16), torch.from_numpy(q).bfloat16()
    scale = hd ** -0.5
    got = tpre.prefill_attention(tq, tk, tv, torch.tensor(p0), scale, tks,
                                 tvs).float()
    xla = jax_sdp(jq, jk, jv, jnp.int32(p0), backend="xla", k_scale=jks,
                  v_scale=jvs)
    pal = prefill_attention_pallas(jq, jk, jv, jnp.int32(p0), scale,
                                   interpret=True, k_scale=jks, v_scale=jvs)
    for want in (xla, pal):
        np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                                   rtol=ATOL, atol=ATOL)
    assert tpre.prefill_attention_supported(tq, tk, tks)
    assert torch.equal(tatt.sdp_attention(tq, tk, tv, torch.tensor(p0),
                                          k_scale=tks, v_scale=tvs).float(),
                       got)


@pytest.mark.parametrize("kind", KINDS)
def test_paged_matches_xla_pallas_interpret_and_slab(kind):
    rng = np.random.default_rng(8 + len(kind))
    b, h, hkv, hd, ps, np_, p = 2, 8, 4, 64, 128, 2, 5
    q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    jk, jks, tk, tks = _codes(_unit(rng, p, ps, hkv, hd), kind)
    jv, jvs, tv, tvs = _codes(_unit(rng, p, ps, hkv, hd), kind)
    bt = np.stack([rng.permutation(np.arange(1, p))[:np_],
                   np.zeros(np_, np.int64)]).astype(np.int32)
    pos = np.array([200, np_ * ps + 9], np.int32)   # row 1 idle
    jq, tq = jnp.asarray(q, jnp.bfloat16), torch.from_numpy(q).bfloat16()
    tbt, tpos = torch.from_numpy(bt), torch.from_numpy(pos)
    scale = hd ** -0.5
    got = tb5.paged_decode_attention(tq, tk, tv, tbt, tpos, scale, tks, tvs)
    xla = jax_sdp_paged(jq, jk, jv, jnp.asarray(bt), jnp.asarray(pos),
                        backend="xla", k_scale=jks, v_scale=jvs)
    pal = paged_decode_attention_pallas(jq, jk, jv, jnp.asarray(bt),
                                        jnp.asarray(pos), scale,
                                        interpret=True, k_scale=jks,
                                        v_scale=jvs)
    for want in (xla, pal):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), rtol=ATOL,
                                   atol=ATOL)
    assert tb5.paged_decode_attention_supported(tq, tk, tks)

    def dense(t):
        return None if t is None else tpaged._gather_dense(t, tbt)

    slab = tatt.sdp_attention(tq, dense(tk), dense(tv), tpos,
                              k_scale=dense(tks), v_scale=dense(tvs))
    assert torch.equal(tatt.sdp_attention_paged(tq, tk, tv, tbt, tpos,
                                                k_scale=tks, v_scale=tvs),
                       got)
    assert torch.equal(got, slab)


def test_gates_follow_the_jax_storage_rule():
    q = torch.zeros(1, 1, 8, 64, dtype=torch.bfloat16)
    sc = torch.zeros(1, 256, 2)
    for kind in ("bf16",) + KINDS:
        k = tkv.init_cache(1, 1, 256, 2, 64, kv_cache_dtype=kind,
                           device="cpu").k[0]
        scaled = kind in SCALED
        assert tdec.decode_attention_supported(q, k, sc if scaled else None)
        assert not tdec.decode_attention_supported(
            q, k, None if scaled else sc)
        assert tdec.kernel_geometry_ok(q, k, sc if scaled else None)
    # packed int4 rows must hold hd / 2 bytes
    assert not tdec.kernel_geometry_ok(
        q, torch.zeros(1, 256, 2, 64, dtype=torch.uint8), sc)
    arena = tpaged.init_paged_cache(1, 3, 128, 2, 64, 1, device="cpu",
                                    kv_cache_dtype="int4")
    assert tb5.paged_attention_geometry_ok(q, arena.k[0], arena.k_scale[0])
    assert not tb5.paged_attention_geometry_ok(q, arena.k[0])


@pytest.mark.parametrize("kind", KINDS)
def test_meta_tensors_never_take_the_plain_path(kind):
    scaled = kind in SCALED
    cache = tkv.init_cache(1, 1, 128, 4, 64, kv_cache_dtype=kind,
                           device="meta")
    k, v = cache.k[0], cache.v[0]
    ks = cache.k_scale[0] if scaled else None
    vs = cache.v_scale[0] if scaled else None
    q1 = torch.zeros(1, 1, 4, 64, dtype=torch.bfloat16, device="meta")
    q128 = torch.zeros(1, 128, 4, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tdec.decode_attention(q1, k, v, 0, 0.125, ks, vs)
    with pytest.raises(ValueError, match="CUDA"):
        tpre.prefill_attention(q128, k, v, 0, 0.125, ks, vs)
    arena = tpaged.init_paged_cache(1, 2, 128, 4, 64, 1, device="meta",
                                    kv_cache_dtype=kind)
    bt = torch.zeros(1, 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tb5.paged_decode_attention(
            q1, arena.k[0], arena.v[0], bt, 0, 0.125,
            arena.k_scale[0] if scaled else None,
            arena.v_scale[0] if scaled else None)


# ---------------------------------------------------------------------------
# engines


@pytest.fixture(scope="module")
def tiny_models():
    jm = tiny_random_model(seed=0)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jm.params),
                                  device="cpu")
    return jm, SyntheticCausalLM(tp, TINY_LLAMA)


def _drive(eng, prompts, params_of, max_steps=800):
    outs = {f"r{i}": [] for i in range(len(prompts))}
    done = set()
    for i, (pr, sp) in enumerate(zip(prompts, params_of)):
        eng.add_request(f"r{i}", pr, sp)
    for _ in range(max_steps):
        eng.step()
        for rid in outs:
            for o in eng.get_outputs(rid):
                outs[rid] += o.new_token_ids
                done.update([rid] if o.finished else [])
        if len(done) == len(prompts):
            break
    assert len(done) == len(prompts), f"unfinished: {done}"
    return outs


_ECFG = dict(max_batch=4, max_seq=64, prefill_bucket=8, prefill_chunk=8)


def _prompts_and_params():
    """A shared 32-token prefix (two full pages at ps 16) and distinct
    tails: greedy and seeded requests alternate."""
    pre = list(range(1, 33))
    prompts = [pre + [100 + i, 200 + i, 7 * i + 1] for i in range(4)]
    kws = [dict(max_tokens=8) if i % 2 == 0 else
           dict(max_tokens=8, temperature=0.8, top_k=8, seed=i)
           for i in range(4)]
    return prompts, kws


@pytest.mark.parametrize("kind", KINDS)
def test_engine_streams_equal_jax_slab_and_paged(tiny_models, kind):
    jm, tm = tiny_models
    prompts, kws = _prompts_and_params()
    jsp = [JaxSamplingParams(**k) for k in kws]
    sps = [SamplingParams(**k) for k in kws]
    want = _drive(JaxLLMEngine(jm, JaxEngineConfig(
        prefix_cache_entries=0, kv_cache_dtype=kind, **_ECFG)), prompts, jsp)
    slab = LLMEngine(tm, EngineConfig(kv_cache_dtype=kind, **_ECFG),
                     device="cpu")
    assert slab.cache.kv_dtype == kind
    assert (slab.cache.k_scale is not None) == (kind in SCALED)
    assert _drive(slab, prompts, sps) == want
    jeng = JaxLLMEngine(jm, JaxEngineConfig(
        prefix_cache_entries=0, kv_cache_dtype=kind, kv_page_size=16,
        prefix_sharing="on", **_ECFG))
    assert _drive(jeng, prompts, jsp) == want
    eng = LLMEngine(tm, EngineConfig(kv_cache_dtype=kind, kv_page_size=16,
                                     prefix_sharing="on", **_ECFG),
                    device="cpu")
    assert _drive(eng, prompts, sps) == want
    snap = eng._paged_snapshot()
    assert snap["radix"]["hits"] == 3
    assert snap["radix"]["hit_tokens"] == 3 * 32
    assert snap["cow_pages_total"] == 4
    assert snap["kv_bytes_per_page"] == tpaged.paged_cache_nbytes(
        2, 1, 16, 4, 8, kind)["total"]
    assert eng._bt_np.tolist() == jeng._bt_np.tolist()


def test_env_flag_picks_the_storage(tiny_models, monkeypatch):
    _, tm = tiny_models
    monkeypatch.setenv("BIGDL_TPU_TORCH_KV_CACHE_DTYPE", "int4")
    eng = LLMEngine(tm, EngineConfig(**_ECFG), device="cpu")
    assert eng.kv_cache_dtype == "int4" and eng.cache.k.dtype == torch.uint8
    assert eng.cache.k.shape[-1] == TINY_LLAMA.hd // 2
    eng = LLMEngine(tm, EngineConfig(kv_cache_dtype="bf16", **_ECFG),
                    device="cpu")
    assert eng.cache.k_scale is None
    monkeypatch.setenv("BIGDL_TPU_TORCH_KV_CACHE_DTYPE", "int3")
    with pytest.raises(ValueError, match="unknown kv_cache_dtype"):
        LLMEngine(tm, EngineConfig(**_ECFG), device="cpu")


def test_engine_refuses_scaled_kv_without_family_support(tiny_models):
    _, tm = tiny_models
    family = types.SimpleNamespace(
        **{k: getattr(tllama, k) for k in (
            "check_supported", "forward", "new_cache", "forward_paged",
            "new_paged_cache", "SUPPORTS_PAGED_KV")})
    model = SyntheticCausalLM(tm.params, TINY_LLAMA, family=family)
    for kind in SCALED:
        with pytest.raises(ValueError, match="SUPPORTS_SCALED_KV"):
            LLMEngine(model, EngineConfig(kv_cache_dtype=kind, **_ECFG),
                      device="cpu")
    eng = LLMEngine(model, EngineConfig(kv_cache_dtype="fp8_e5m2", **_ECFG),
                    device="cpu")
    assert eng.cache.kv_dtype == "fp8_e5m2"


class _JaxMixtral:
    def __init__(self, params, cfg):
        self.params, self.config = params, cfg
        self.hf_config = {"eos_token_id": None}

    class family:
        name = "mixtral"
        SUPPORTS_SCALED_KV = True
        forward = staticmethod(jmx.forward)
        prefill = staticmethod(jmx.forward_last_token)
        new_cache = staticmethod(jmx.new_cache)


def test_mixtral_int8_engine_equals_jax_greedy():
    geom = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
                num_hidden_layers=2, num_attention_heads=4,
                num_key_value_heads=2, max_position_embeddings=256,
                num_experts_per_tok=2, num_local_experts=4)
    jcfg, tcfg = JaxMixtralConfig(**geom), MixtralConfig(**geom)
    jp = jax_random_mixtral(jcfg, "sym_int4", seed=0)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, 256, n).tolist() for n in (5, 20, 9)]
    ecfg = dict(max_batch=2, max_seq=128)
    want = _drive(JaxLLMEngine(_JaxMixtral(jp, jcfg), JaxEngineConfig(
        kv_cache_dtype="int8", **ecfg)), prompts,
        [JaxSamplingParams(max_tokens=8)] * 3)
    eng = LLMEngine(SyntheticCausalLM(tp, tcfg, family=tmx),
                    EngineConfig(kv_cache_dtype="int8", **ecfg),
                    device="cpu")
    assert eng.cache.kv_dtype == "int8"
    assert _drive(eng, prompts, [SamplingParams(max_tokens=8)] * 3) == want
