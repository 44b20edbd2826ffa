"""bigdl_tpu_torch attention, KV cache, norm and rope against the JAX
package.

The port's plain attention (what the B3/B4 wrappers run on CPU tensors)
is held against ``sdp_attention(backend="xla")`` and the Pallas decode
and prefill kernels in interpret mode, at hd = 64, S in {128, 256}, GQA,
scalar and per-slot positions, within 2e-2 (3e-2 for prefill). Cache
writes, including a write past S_max that JAX clamps, match byte for byte.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops import kvcache as jkv
from bigdl_tpu.ops.attention import sdp_attention as jax_sdp
from bigdl_tpu.ops.norms import rms_norm as jax_rms_norm
from bigdl_tpu.ops.pallas.decode_attention import decode_attention_pallas
from bigdl_tpu.ops.pallas.prefill_attention import prefill_attention_pallas
from bigdl_tpu.ops.rope import apply_rope as jax_apply_rope
from bigdl_tpu.ops.rope import rope_cos_sin as jax_rope_cos_sin
from bigdl_tpu.ops.rope import rope_freqs as jax_rope_freqs
from bigdl_tpu_torch.ops import attention as tatt
from bigdl_tpu_torch.ops import kvcache as tkv
from bigdl_tpu_torch.ops.cuda import decode_attention as tdec
from bigdl_tpu_torch.ops.cuda import prefill_attention as tpre
from bigdl_tpu_torch.ops.norms import rms_norm
from bigdl_tpu_torch.ops.rope import apply_rope, rope_cos_sin, rope_freqs


def _bf16(rng, *shape):
    a = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(a, jnp.bfloat16), torch.from_numpy(a).to(
        torch.bfloat16)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.float().numpy()


@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("s", [128, 256])
@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_matches_xla_and_pallas_interpret(h, hkv, s, per_slot):
    rng = np.random.default_rng(h * 1000 + s + per_slot)
    b, hd = 2, 64
    jq, tq = _bf16(rng, b, 1, h, hd)
    jk, tk = _bf16(rng, b, s, hkv, hd)
    jv, tv = _bf16(rng, b, s, hkv, hd)
    pos_np = np.array([s - 1, s // 3], np.int32) if per_slot \
        else np.int32(s // 2)
    jpos, tpos = jnp.asarray(pos_np), torch.from_numpy(np.asarray(pos_np))
    scale = hd ** -0.5
    got = _np(tdec.decode_attention(tq, tk, tv, tpos, scale))
    assert got.shape == (b, 1, h, hd)
    xla = np.asarray(jax_sdp(jq, jk, jv, jpos, backend="xla"), np.float32)
    pal = np.asarray(decode_attention_pallas(jq, jk, jv, jpos, scale,
                                             interpret=True), np.float32)
    np.testing.assert_allclose(got, xla, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got, pal, rtol=2e-2, atol=2e-2)
    # the dispatch sends this geometry to the decode wrapper
    np.testing.assert_array_equal(_np(tatt.sdp_attention(tq, tk, tv, tpos)),
                                  got)


@pytest.mark.parametrize("h,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("sq,smax,pos", [(128, 128, 0), (128, 256, 128),
                                         (256, 256, 0)])
def test_prefill_matches_xla_and_pallas_interpret(h, hkv, sq, smax, pos):
    rng = np.random.default_rng(sq + smax + pos + h)
    b, hd = 1, 64
    jq, tq = _bf16(rng, b, sq, h, hd)
    jk, tk = _bf16(rng, b, smax, hkv, hd)
    jv, tv = _bf16(rng, b, smax, hkv, hd)
    scale = hd ** -0.5
    got = _np(tpre.prefill_attention(tq, tk, tv, torch.tensor(pos), scale))
    xla = np.asarray(jax_sdp(jq, jk, jv, jnp.int32(pos), backend="xla"),
                     np.float32)
    pal = np.asarray(prefill_attention_pallas(jq, jk, jv, jnp.int32(pos),
                                              scale, interpret=True),
                     np.float32)
    np.testing.assert_allclose(got, xla, rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(got, pal, rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("sq,per_slot", [(32, False), (4, True)])
def test_plain_paths_match_xla(sq, per_slot):
    """Shapes the kernels do not take (Sq % 128 != 0, or per-slot
    positions with Sq > 1) run the plain version."""
    rng = np.random.default_rng(sq)
    b, h, hkv, hd, s = 2, 4, 2, 64, 128
    jq, tq = _bf16(rng, b, sq, h, hd)
    jk, tk = _bf16(rng, b, s, hkv, hd)
    jv, tv = _bf16(rng, b, s, hkv, hd)
    pos = np.array([3, 60], np.int32) if per_slot else np.int32(17)
    got = _np(tatt.sdp_attention(tq, tk, tv, torch.from_numpy(
        np.asarray(pos))))
    want = np.asarray(jax_sdp(jq, jk, jv, jnp.asarray(pos), backend="xla"),
                      np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


def test_dispatch_gates(monkeypatch):
    q1 = torch.zeros(1, 1, 8, 64)
    q128 = torch.zeros(1, 128, 8, 64)
    k = torch.zeros(1, 256, 2, 64, dtype=torch.bfloat16)
    assert tdec.decode_attention_supported(q1, k)
    assert not tdec.decode_attention_supported(q128, k)
    assert tpre.prefill_attention_supported(q128, k)
    assert not tpre.prefill_attention_supported(torch.zeros(1, 96, 8, 64), k)
    assert not tdec.kernel_geometry_ok(q1, torch.zeros(1, 200, 2, 64))
    assert not tdec.kernel_geometry_ok(q1, torch.zeros(1, 256, 2, 64))
    assert not tdec.kernel_geometry_ok(torch.zeros(1, 1, 8, 96), k)
    calls = []
    monkeypatch.setattr(tatt, "decode_attention",
                        lambda *a: calls.append("b3") or tdec.plain_attention(
                            *a))
    monkeypatch.setattr(tatt, "prefill_attention",
                        lambda *a: calls.append("b4") or tdec.plain_attention(
                            *a))
    kv = torch.zeros(1, 256, 2, 64, dtype=torch.bfloat16)
    tatt.sdp_attention(q1.bfloat16(), kv, kv, torch.tensor(3))
    tatt.sdp_attention(q128.bfloat16(), kv, kv, torch.tensor(0))
    tatt.sdp_attention(q128.bfloat16(), kv, kv, torch.tensor([0]))
    assert calls == ["b3", "b4"]
    monkeypatch.setenv("BIGDL_TPU_TORCH_ATTENTION_BACKEND", "plain")
    tatt.sdp_attention(q1.bfloat16(), kv, kv, torch.tensor(3))
    assert calls == ["b3", "b4"]


@pytest.mark.parametrize("fn", [tdec.decode_attention,
                                tpre.prefill_attention])
def test_non_cpu_tensor_never_takes_the_plain_path(fn):
    q = torch.zeros(1, 128, 4, 64, dtype=torch.bfloat16, device="meta")
    kv = torch.zeros(1, 128, 4, 64, dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fn(q, kv, kv, 0, 0.125)


def _cache_pair(rng, layers, b, s, hkv, hd, per_slot):
    jc = jkv.init_cache(layers, b, s, hkv, hd, per_slot_pos=per_slot)
    tc = tkv.init_cache(layers, b, s, hkv, hd, per_slot_pos=per_slot,
                        device="cpu")
    base = rng.standard_normal((layers, b, s, hkv, hd)).astype(np.float32)
    return (jnp.asarray(base, jnp.bfloat16),
            torch.from_numpy(base).to(torch.bfloat16), jc, tc)


def _bits(t):
    return t.view(torch.int16).numpy()


@pytest.mark.parametrize("pos", [
    np.int32(5), np.int32(126),                 # 126 + 4 > 128: clamped
    np.array([0, 3, 125, 400], np.int32)])      # per slot, two clamped
def test_update_layer_bytes_match_jax_including_clamp(pos):
    rng = np.random.default_rng(7)
    layers, b, s, hkv, hd = 2, 4, 128, 2, 8
    per_slot = np.ndim(pos) == 1
    jbase, tbase, _, _ = _cache_pair(rng, layers, b, s, hkv, hd, per_slot)
    s_new = 1 if per_slot else 4
    new = rng.standard_normal((b, s_new, hkv, hd)).astype(np.float32)
    jk, jv = jkv.update_layer(jbase, jbase * 2, 1, jnp.asarray(new),
                              jnp.asarray(new) * 3, jnp.asarray(pos))
    tk_, tv_ = tbase.clone(), (tbase.float() * 2).to(torch.bfloat16)
    tkv.update_layer(tk_, tv_, 1, torch.from_numpy(new),
                     torch.from_numpy(new) * 3,
                     torch.from_numpy(np.asarray(pos)))
    np.testing.assert_array_equal(_bits(tk_),
                                  np.asarray(jk).view(np.int16))
    np.testing.assert_array_equal(_bits(tv_),
                                  np.asarray(jv).view(np.int16))
    rk, rv = tkv.read_layer(tk_, tv_, 1)
    jrk, _ = jkv.read_layer(jk, jv, 1)
    np.testing.assert_array_equal(_bits(rk), np.asarray(jrk).view(np.int16))


def test_init_cache_shapes_and_bf16_only():
    c = tkv.init_cache(2, 3, 128, 2, 64, per_slot_pos=True, device="cpu")
    assert c.k.shape == (2, 3, 128, 2, 64) and c.pos.shape == (3,)
    assert c.k.dtype == torch.bfloat16 and c.max_seq == 128
    with pytest.raises(NotImplementedError):
        tkv.init_cache(1, 1, 8, 1, 8, dtype=torch.float8_e5m2, device="cpu")


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 5, 4, 64)).astype(np.float32)
    w = rng.standard_normal((64,)).astype(np.float32)
    got = rms_norm(torch.from_numpy(x).bfloat16(), torch.from_numpy(w), 1e-5)
    want = jax_rms_norm(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w), 1e-5)
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=1e-2, atol=1e-2)
    pos = np.array([[0, 1, 7, 100, 511]], np.int32)
    inv = rope_freqs(64, 10000.0)
    np.testing.assert_allclose(inv.numpy(), np.asarray(jax_rope_freqs(64)),
                               rtol=1e-6)
    cos, sin = rope_cos_sin(torch.from_numpy(pos), inv)
    jcos, jsin = jax_rope_cos_sin(jnp.asarray(pos), jax_rope_freqs(64))
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-5)
    for inter in (False, True):
        got = apply_rope(torch.from_numpy(x), cos, sin, interleaved=inter)
        want = jax_apply_rope(jnp.asarray(x), jcos, jsin, interleaved=inter)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
