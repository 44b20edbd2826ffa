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
from torch_threads import one_intra_op_thread  # noqa: F401

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
        def fn(x, w, body="std"):
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
                        lambda x, w, body="std": seen.append("gemm") or
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
    """The K split covers every 64-row chunk and leaves no split empty. B1
    (the small-M body) takes the fewest waves a split, B2 (the Hopper
    body) one wave of resident blocks; both sum it in one launch."""
    sms = 132
    monkeypatch.setattr(dm, "_sm_count", lambda device: sms)
    monkeypatch.setattr(dm, "_occupancy", {})
    monkeypatch.setattr(dm._native, "kernel",
                        lambda lib, sym=None: (lambda *a: occ))
    # words a thread, columns a block and splits: B1 std runs the small-M
    # body (16-byte loads at M <= 16, 8-byte above; a strip of 32 cw
    # columns a block; the split with the fewest waves a split), B2 the
    # Hopper body (256-column strips, one wave, at most 5 splits: lm_head's
    # 125 strips take 2 on 264 slots, qkv's 48 5 on 396)
    cw, cols, want = {("dequant_gemv", 8, 22016): (4, 128, 3),
                      ("dequant_gemv", 1, 4096): (4, 128, 8),
                      ("dequant_gemv", 20, 4096): (2, 64, 4),
                      ("dequant_gemv", 8, 260): (1, 32, 1),
                      ("dequant_gemm", 128, 32000): (1, 256, 2),
                      ("dequant_gemm", 64, 12288): (1, 256, 5)}[
                          (name, m, n)]
    assert dm._cw(name, n, m) == cw
    assert dm._block_cols(name, cw) == cols
    split, per = dm._split_k(name, m, n, k, 0, cw, torch.device("cpu"))
    chunks = -(-k // 64)
    blocks_n = -(-n // cols)
    assert (split - 1) * per < chunks <= split * per
    assert split == want
    rule = dm.wgmma_split if name == "dequant_gemm" else dm._balanced_split
    assert split == rule(blocks_n, occ * sms, chunks)


# -- the int4-layout and scale-folded bodies -----------------------------------
# (mxu, fold, mxuflat, mxu8 of B1 and i4 of B2; their plain versions against
# the JAX package's Pallas bodies in interpret mode, switched as its own
# tests switch them: set_flags(matmul_gemv=...) + jax.clear_caches())

BF16_ULP = 2.0 ** -7     # tests/test_decode_fastpath.py's tolerance


@pytest.fixture
def jax_gemv_mode():
    from bigdl_tpu.config import flags as jflags
    from bigdl_tpu.config import set_flags

    before = jflags().matmul_gemv

    def use(mode):
        set_flags(matmul_gemv=mode)
        jax.clear_caches()           # flags are read at trace time
    yield use
    set_flags(matmul_gemv=before)
    jax.clear_caches()


def _pair_layout(k, n, qtype, layout, seed=0, lead=()):
    from bigdl_tpu.ops.quant import to_mxu_layout as jax_to_mxu
    from bigdl_tpu_torch.ops.quant import to_mxu_layout

    jw, tw = _pair(k, n, qtype, seed)
    if layout == "int4":
        jw, tw = jax_to_mxu(jw), to_mxu_layout(tw)
        assert tw.layout == "int4"
    return jw, tw


FUSED_CASES = [("sym_int4", "canonical"), ("sym_int4", "int4"),
               ("asym_int4", "canonical"), ("nf4", "canonical"),
               ("sym_int8", "canonical")]


@pytest.mark.parametrize("qtype,layout", FUSED_CASES)
@pytest.mark.parametrize("m", [1, 8, 32])
def test_xla_fused_within_one_ulp_of_jax(qtype, layout, m):
    from bigdl_tpu.ops.matmul import _q_matmul_xla_fused

    k, n = 320, 192                           # 320: odd K for nf4's block
    jw, tw = _pair_layout(k, n, qtype, layout, seed=20)
    x = _x(m, k, seed=21)
    want = np.asarray(_q_matmul_xla_fused(jnp.asarray(x), jw), np.float32)
    got = tmatmul.q_matmul(torch.from_numpy(x), tw, backend="xla_fused")
    np.testing.assert_allclose(got.numpy(), want, rtol=BF16_ULP,
                               atol=BF16_ULP * np.abs(want).max())


@pytest.mark.parametrize("layout", ["canonical", "int4"])
def test_xla_fused_batch_dims_and_padding(layout):
    from bigdl_tpu.ops.matmul import _q_matmul_xla_fused

    k, n = 200, 96                            # K pads to 224
    jw, tw = _pair_layout(k, n, "sym_int4", layout, seed=22)
    x = _x(6, k, seed=23).reshape(2, 3, k)
    want = np.asarray(_q_matmul_xla_fused(jnp.asarray(x), jw), np.float32)
    got = tmatmul.q_matmul(torch.from_numpy(x), tw, backend="xla_fused")
    assert got.shape == (2, 3, n)
    np.testing.assert_allclose(got.numpy(), want, rtol=BF16_ULP,
                               atol=BF16_ULP * np.abs(want).max())


@pytest.mark.parametrize("qtype", ["fp4", "nf3"])
def test_xla_fused_rejects_unfactorable_qtypes(qtype):
    _, tw = _pair(64, 32, qtype)
    with pytest.raises(NotImplementedError):
        tmatmul.q_matmul(torch.zeros(1, 64), tw, backend="xla_fused")
    with pytest.raises(ValueError, match="backend"):
        tmatmul.q_matmul(torch.zeros(1, 64), tw, backend="pallas")


# (flag, qtype, layout, the body both packages pick)
GEMV_CASES = [("auto", "sym_int4", "int4", "mxu"),
              ("mxu", "sym_int4", "int4", "mxu"),
              ("fold", "sym_int4", "canonical", "fold"),
              ("fold", "nf4", "canonical", "fold"),
              ("fold", "sym_int8", "canonical", "fold"),
              ("fold", "fp4", "canonical", "fold"),
              ("fold", "nf3", "canonical", "fold"),
              ("mxuflat", "sym_int4", "int4", "mxuflat"),
              ("mxu8", "sym_int4", "int4", "mxu8"),
              ("mxu8", "sym_int8", "canonical", "mxu8")]


@pytest.mark.parametrize("mode,qtype,layout,body", GEMV_CASES)
@pytest.mark.parametrize("m", [1, 8, 17, 32])
def test_gemv_body_plain_versions_match_pallas_interpret(
        jax_gemv_mode, mode, qtype, layout, body, m):
    k, n = 512, 256
    jw, tw = _pair_layout(k, n, qtype, layout, seed=24)
    assert dm.pick_gemv_body(mode, tw) == body
    x = _x(m, k, seed=25)
    jax_gemv_mode(mode)
    want = np.asarray(q_matmul_pallas(jnp.asarray(x), jw, interpret=True),
                      np.float32)
    got = dm.dequant_gemv(torch.from_numpy(x), tw, body)
    tol = 6e-2 if body == "mxu8" else 3e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("m", [64, 100, 128])
def test_gemm_i4_plain_version_matches_pallas_interpret(m):
    k, n = 512, 256
    jw, tw = _pair_layout(k, n, "sym_int4", "int4", seed=26)
    x = _x(m, k, seed=27)
    want = np.asarray(q_matmul_pallas(jnp.asarray(x), jw, interpret=True),
                      np.float32)
    got = dm.dequant_gemm(torch.from_numpy(x), tw, "i4")
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2,
                               atol=3e-2)


@pytest.mark.parametrize("m,k", [(1, 64), (8, 512), (17, 320), (32, 1024)])
def test_mxu8_activation_codes_bit_identical_to_jax(m, k):
    """The q8 activation codes and scales are the JAX expression of
    ``_q_gemv_pallas`` (L532-537), bit for bit (a zero block included)."""
    x = _x(m, k, seed=28)
    x[0, :32] = 0.0
    xb = jnp.asarray(x, jnp.bfloat16)
    x3 = xb.reshape(m, k // 32, 32).transpose(1, 0, 2)
    xf = x3.astype(jnp.float32)
    amax = jnp.max(jnp.abs(xf), axis=-1)
    sxt = amax * (1.0 / 127.0)
    inv = jnp.where(sxt == 0, 0.0, 1.0 / jnp.where(sxt == 0, 1.0, sxt))
    xq = jnp.round(xf * inv[..., None]).astype(jnp.int8)
    got_q, got_s = dm.quantize_x_q8(torch.from_numpy(x).to(torch.bfloat16))
    np.testing.assert_array_equal(
        got_q.numpy(), np.asarray(xq).transpose(1, 0, 2).reshape(m, k))
    np.testing.assert_array_equal(got_s.numpy().view(np.int32),
                                  np.asarray(sxt).T.view(np.int32))


@pytest.mark.parametrize("mode,layout,m,route", [
    ("auto", "int4", 8, ("gemv", "mxu")),
    ("auto", "canonical", 8, ("gemv", "std")),
    ("fold", "int4", 8, ("gemv", "mxu")),
    ("mxuflat", "canonical", 8, ("gemv", "std")),
    ("mxu8", "int4", 32, ("gemv", "mxu8")),
    ("off", "int4", 8, ("gemm", "i4")),
    ("off", "canonical", 1, ("gemm", "std")),
    ("auto", "int4", 33, ("gemm", "i4")),
    ("mxu8", "int4", 128, ("gemm", "i4")),
    ("auto", "int4", 129, ("plain", None))])
def test_dispatch_picks_the_body(monkeypatch, mode, layout, m, route):
    """M <= 32 -> B1 with the flag's body for the layout (``off``: B2),
    32 < M <= 128 -> B2 (``i4`` on the int4 layout), larger -> the plain
    dequantize-then-matmul path, which reads either layout."""
    seen = []

    def stand_in(name):
        def fn(x, w, body=None):
            seen.append((name, body))
            return dm.plain_q_matmul(x, w)
        return fn

    monkeypatch.setenv("BIGDL_TPU_TORCH_MATMUL_GEMV", mode)
    monkeypatch.setattr(tmatmul, "dequant_gemv", stand_in("gemv"))
    monkeypatch.setattr(tmatmul, "dequant_gemm", stand_in("gemm"))
    monkeypatch.setattr(tmatmul, "plain_q_matmul", stand_in("plain"))
    _, tw = _pair_layout(64, 32, "sym_int4", layout)
    tmatmul.q_matmul(torch.zeros(m, 64), tw)
    assert seen == [route]


def test_matmul_gemv_flag_rejects_unknown_values(monkeypatch):
    monkeypatch.setenv("BIGDL_TPU_TORCH_MATMUL_GEMV", "turbo")
    _, tw = _pair(64, 32, "sym_int4")
    with pytest.raises(ValueError, match="MATMUL_GEMV"):
        tmatmul.q_matmul(torch.zeros(1, 64), tw)


@pytest.mark.parametrize("fn,body,qtype,layout", [
    (dm.dequant_gemv, "mxu", "sym_int4", "int4"),
    (dm.dequant_gemv, "fold", "nf4", "canonical"),
    (dm.dequant_gemv, "mxuflat", "sym_int4", "int4"),
    (dm.dequant_gemv, "mxu8", "sym_int8", "canonical"),
    (dm.dequant_gemm, "i4", "sym_int4", "int4")])
def test_new_bodies_never_take_the_plain_path_off_the_cpu(fn, body, qtype,
                                                          layout):
    _, tw = _pair_layout(64, 32, qtype, layout)
    with pytest.raises(ValueError, match="CUDA"):
        fn(torch.zeros(4, 64, device="meta"), tw, body)


@pytest.mark.parametrize("fn,body,qtype,layout", [
    (dm.dequant_gemv, "mxu", "sym_int4", "canonical"),
    (dm.dequant_gemv, "std", "sym_int4", "int4"),
    (dm.dequant_gemv, "fold", "asym_int4", "canonical"),
    (dm.dequant_gemv, "fold", "sym_int4", "int4"),
    (dm.dequant_gemv, "mxuflat", "sym_int8", "canonical"),
    (dm.dequant_gemv, "mxu8", "sym_int4", "canonical"),
    (dm.dequant_gemm, "i4", "sym_int4", "canonical"),
    (dm.dequant_gemm, "std", "sym_int4", "int4")])
def test_a_body_refuses_a_weight_it_does_not_read(fn, body, qtype, layout):
    """On any device: a body given a layout or qtype it does not read
    raises (no other body runs in its place)."""
    _, tw = _pair_layout(64, 32, qtype, layout)
    for dev in ("cpu", "meta"):
        with pytest.raises(ValueError, match="does not take"):
            fn(torch.zeros(4, 64, device=dev), tw, body)


@pytest.mark.parametrize("name,m,n,cw", [
    ("dequant_gemv_mxu", 8, 22016, 2), ("dequant_gemv_mxu", 20, 22016, 1),
    ("dequant_gemv_fold", 8, 260, 1), ("dequant_gemv_mxu8", 1, 4096, 4),
    ("dequant_gemv_mxuflat", 8, 22016, 4), ("dequant_gemv_mxuflat", 8, 260,
                                            1),
    ("dequant_gemm_i4", 128, 22016, 1), ("dequant_gemv_fold", 8, 22016, 4),
    ("dequant_gemv_fold", 20, 22016, 2), ("dequant_gemv_fold", 32, 260, 1),
    ("dequant_gemv_mxuflat", 20, 22016, 2)])
def test_variant_words_and_split(monkeypatch, name, m, n, cw):
    """Words a thread loads per packed row for each body, and the K split
    from the occupancy query of the body's own library. mxu, fold, mxuflat
    and mxu8 run the small-M body: 16-byte loads at M <= 16, 8-byte above,
    4-byte where N % 16 (M <= 16) or N % 8 (above) is not 0 (the mxu ids'
    cw is an older body's: 2 at M 8, 1 at M 20), the split with the fewest
    waves a split, and query it through the variants library's body id. i4
    runs B2's Hopper body: its library's query takes (M, kind), and the
    split is one wave of its 256-column strips."""
    cw = {("dequant_gemv_mxu", 8, 22016): 4,
          ("dequant_gemv_mxu", 20, 22016): 2}.get((name, m, n), cw)
    assert dm._cw(name, n, m) == cw
    calls = []

    def kernel(lib, sym=None):
        def q(*a):
            calls.append((lib, sym, a))
            return 2
        return q
    monkeypatch.setattr(dm, "_sm_count", lambda device: 132)
    monkeypatch.setattr(dm, "_occupancy", {})
    monkeypatch.setattr(dm._native, "kernel", kernel)
    split, per = dm._split_k(name, m, n, 4096, dm._KIND_I4, cw,
                             torch.device("cpu"))
    assert (split - 1) * per < 64 <= split * per
    lib, sym, args = calls[0]
    assert sym.endswith("_blocks_per_sm")
    if name == "dequant_gemm_i4":
        assert lib == "dequant_gemm" and args == (m, dm._KIND_I4)
        assert split == dm.wgmma_split(dm.wgmma_strips(n), 2 * 132, 64)
        return
    assert lib == "dequant_variants"
    assert args == (dm._VARIANT_BODY[name], m, dm._KIND_I4, cw)
    assert name in dm._SMALLM and dm._block_cols(name, cw) == 32 * cw
    assert split == -(-64 // -(-64 // dm._balanced_split(
        -(-n // (32 * cw)), 2 * 132, 64)))
