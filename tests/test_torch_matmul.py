"""bigdl_tpu_torch quantized linear against the JAX package.

The port's ``q_matmul`` runs its plain versions on CPU tensors; it is held
against ``bigdl_tpu.ops.matmul.q_matmul(backend="xla")`` and the Pallas
kernel in interpret mode (as tests/test_pallas_matmul.py runs it), within
rtol = atol = 3e-2 (bf16 outputs, different summation order). Routing
between the two kernel wrappers and the plain large-M path is checked
with stand-ins, and a non-CPU tensor is shown to reach the kernel path
(and raise here) instead of falling back to the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.matmul import q_matmul as jax_q_matmul
from bigdl_tpu.ops.pallas.dequant_matmul import q_matmul_pallas
from bigdl_tpu.ops.quant import quantize as jax_quantize
from bigdl_tpu_torch import bridge
from bigdl_tpu_torch.ops import matmul as tmatmul
from bigdl_tpu_torch.ops.cuda import dequant_matmul as dm
from bigdl_tpu_torch.ops.quant import QTensor

QTYPES = ["sym_int4", "asym_int4", "sym_int8", "nf4", "fp4", "nf3"]


def _pair(k, n, qtype, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    jw = jax_quantize(jnp.asarray(w), qtype)
    tw = bridge.qtensor_from_numpy(jax.tree.map(np.asarray, jw), device="cpu")
    return jw, tw


def _x(m, k, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)) * 0.3).astype(np.float32)


@pytest.mark.parametrize("qtype", QTYPES)
@pytest.mark.parametrize("m", [1, 8, 33, 128])
def test_q_matmul_matches_jax_xla(qtype, m):
    k, n = 200, 128                       # K not a block multiple: padding
    jw, tw = _pair(k, n, qtype)
    x = _x(m, k)
    want = np.asarray(jax_q_matmul(jnp.asarray(x, jnp.bfloat16), jw,
                                   backend="xla"), np.float32)
    got = tmatmul.q_matmul(torch.from_numpy(x).to(torch.bfloat16), tw)
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2,
                               atol=3e-2)


@pytest.mark.parametrize("qtype", QTYPES)
@pytest.mark.parametrize("m", [1, 8, 33])
def test_q_matmul_matches_pallas_interpret(qtype, m):
    k, n = 256, 128
    jw, tw = _pair(k, n, qtype, seed=2)
    x = _x(m, k, seed=3)
    want = np.asarray(q_matmul_pallas(jnp.asarray(x), jw, interpret=True),
                      np.float32)
    got = tmatmul.q_matmul(torch.from_numpy(x), tw)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-2, atol=3e-2)


def test_leading_batch_dims_and_dense_linear():
    jw, tw = _pair(64, 96, "sym_int4", seed=4)
    x = _x(15, 64).reshape(3, 5, 64)
    want = np.asarray(jax_q_matmul(jnp.asarray(x), jw, backend="xla"))
    got = tmatmul.linear(torch.from_numpy(x), tw)
    assert got.shape == (3, 5, 96)
    np.testing.assert_allclose(got.numpy(), want, rtol=3e-2, atol=3e-2)
    dense = np.random.default_rng(5).standard_normal((64, 32)).astype(
        np.float32)
    np.testing.assert_allclose(
        tmatmul.linear(torch.from_numpy(x), torch.from_numpy(dense)).numpy(),
        x @ dense, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("m,route", [(1, "gemv"), (32, "gemv"),
                                     (33, "gemm"), (128, "gemm"),
                                     (129, "plain"), (256, "plain")])
def test_dispatch_routes_by_rows(monkeypatch, m, route):
    """M <= 32 -> B1, 32 < M <= 128 -> B2, larger -> dequantize + matmul
    (the routing table of the serving path)."""
    seen = []

    def stand_in(name):
        def fn(x, w):
            seen.append(name)
            return dm.plain_q_matmul(x, w)
        return fn

    monkeypatch.setattr(tmatmul, "dequant_gemv", stand_in("gemv"))
    monkeypatch.setattr(tmatmul, "dequant_gemm", stand_in("gemm"))
    monkeypatch.setattr(tmatmul, "plain_q_matmul", stand_in("plain"))
    _, tw = _pair(64, 32, "sym_int4")
    tmatmul.q_matmul(torch.zeros(m, 64), tw)
    assert seen == [route]


def test_max_m_flag_moves_the_gemm_ceiling(monkeypatch):
    seen = []
    monkeypatch.setattr(tmatmul, "dequant_gemm",
                        lambda x, w: seen.append("gemm") or
                        dm.plain_q_matmul(x, w))
    monkeypatch.setenv("BIGDL_TPU_TORCH_MATMUL_MAX_M", "64")
    _, tw = _pair(64, 32, "sym_int4")
    tmatmul.q_matmul(torch.zeros(100, 64), tw)
    assert seen == []
    tmatmul.q_matmul(torch.zeros(64, 64), tw)
    assert seen == ["gemm"]


@pytest.mark.parametrize("fn", [dm.dequant_gemv, dm.dequant_gemm])
def test_non_cpu_tensor_never_takes_the_plain_path(fn):
    """Only CPU tensors get the plain version; any other device goes to
    the kernel path, which validates and raises here (meta tensors)."""
    _, tw = _pair(64, 32, "sym_int4")
    with pytest.raises(ValueError, match="CUDA"):
        fn(torch.zeros(4, 64, device="meta"), tw)


@pytest.mark.parametrize("m", [4, 64])
@pytest.mark.parametrize("n,qtype", [(6, "sym_int4"), (32, "q4_0"),
                                     (32, "int8")])
def test_q_matmul_never_falls_back_for_a_non_cpu_tensor(m, n, qtype):
    """q_matmul sends every M <= 128 to a kernel wrapper, whatever the
    weight's N or qtype name: a shape or qtype a kernel cannot take
    raises from the kernel path instead of running the plain version."""
    _, tw = _pair(64, n, qtype)
    with pytest.raises(ValueError, match="CUDA"):
        tmatmul.q_matmul(torch.zeros(m, 64, device="meta"), tw)


@pytest.mark.parametrize("alias,qtype", [("q4_0", "sym_int4"),
                                         ("int8", "sym_int8")])
def test_qtype_alias_matches_its_qtype(alias, qtype):
    _, tw = _pair(64, 32, qtype, seed=6)
    tw_alias = QTensor(tw.data, tw.scale, tw.zero, alias, tw.shape)
    x = torch.from_numpy(_x(8, 64, seed=7))
    assert torch.equal(tmatmul.q_matmul(x, tw_alias),
                       tmatmul.q_matmul(x, tw))


def test_gemm_rejects_more_rows_than_one_launch():
    _, tw = _pair(64, 32, "sym_int4")
    with pytest.raises(ValueError, match="outside"):
        dm.dequant_gemm(torch.zeros(dm.GEMM_MAX_M + 1, 64, device="meta"),
                        tw)


@pytest.mark.parametrize("value", ["-1", "129", "512"])
def test_max_m_flag_out_of_range_raises(monkeypatch, value):
    monkeypatch.setenv("BIGDL_TPU_TORCH_MATMUL_MAX_M", value)
    _, tw = _pair(64, 32, "sym_int4")
    with pytest.raises(ValueError, match="MATMUL_MAX_M"):
        tmatmul.q_matmul(torch.zeros(100, 64), tw)


def test_plain_version_is_bf16_weights_f32_sum():
    """The plain version rounds each dequantized weight and x to bf16 and
    sums in f32 — exactly what the kernels compute."""
    jw, tw = _pair(96, 16, "asym_int4", seed=9)
    x = _x(4, 96, seed=8)
    dense = np.asarray(jw.dequantize(jnp.bfloat16).astype(jnp.float32))
    xb = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
    want = (xb.astype(np.float64) @ dense.astype(np.float64))
    got = dm.plain_q_matmul(torch.from_numpy(x), tw).float().numpy()
    np.testing.assert_allclose(got, want, rtol=8e-3, atol=8e-3)


@pytest.mark.parametrize("name,m,k,n,occ", [
    ("dequant_gemv", 8, 4096, 22016, 2), ("dequant_gemv", 1, 4096, 4096, 3),
    ("dequant_gemv", 20, 11008, 4096, 2), ("dequant_gemv", 8, 640, 260, 4),
    ("dequant_gemm", 128, 4096, 32000, 2), ("dequant_gemm", 64, 4096, 12288,
                                             3)])
def test_split_k_fills_one_wave(monkeypatch, name, m, k, n, occ):
    """The K split puts at most one wave of resident blocks on the card,
    covers every 64-row chunk, and leaves no split empty."""
    sms = 132
    monkeypatch.setattr(dm, "_sm_count", lambda device: sms)
    monkeypatch.setattr(dm, "_occupancy", {})
    monkeypatch.setattr(dm._native, "kernel",
                        lambda lib, sym=None: (lambda *a: occ))
    cw = dm._cw(name, n)
    assert cw == (4 if name == "dequant_gemv" and n % 16 == 0 else 1)
    split, per = dm._split_k(name, m, n, k, 0, cw, torch.device("cpu"))
    chunks = -(-k // 64)
    blocks_n = -(-n // (4 * 32 * cw))
    assert (split - 1) * per < chunks <= split * per
    assert split == 1 or blocks_n * split <= occ * sms
    # as few chunks per block as one wave allows
    assert per == -(-chunks // max(1, min(chunks, occ * sms // blocks_n)))
