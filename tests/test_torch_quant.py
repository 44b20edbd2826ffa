"""bigdl_tpu_torch quantization against the JAX package, plus the import
guard that keeps the port free of JAX.

The same f32 weights (numpy, fixed seed) quantize to identical data /
scale / zero bytes in both packages, and the JAX package's QTensors,
carried across by bridge.py, dequantize bit for bit in the port.
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops import quant as jq
from bigdl_tpu_torch import bridge
from bigdl_tpu_torch.ops import quant as tq
from torch_threads import one_intra_op_thread  # noqa: F401

QTYPES = ["sym_int4", "asym_int4", "sym_int8", "nf4", "fp4", "nf3"]
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _bits(t: torch.Tensor) -> np.ndarray:
    """Raw bytes of a torch tensor as a numpy array (bf16 -> uint16)."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _jbits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _weights(k, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((k, n)) * 0.05).astype(np.float32)


@pytest.mark.parametrize("qtype", QTYPES)
@pytest.mark.parametrize("k,n", [(256, 96), (100, 40), (2048, 64)])
def test_quantize_bytes_match_jax(qtype, k, n):
    w = _weights(k, n, seed=k + n)
    a = jq.quantize(jnp.asarray(w), qtype)
    b = tq.quantize(torch.from_numpy(w), qtype)
    assert b.shape == tuple(a.shape) and b.qtype == a.qtype
    np.testing.assert_array_equal(_bits(b.data), _jbits(a.data))
    np.testing.assert_array_equal(_bits(b.scale), _jbits(a.scale))
    if a.zero is None:
        assert b.zero is None
    else:
        np.testing.assert_array_equal(_bits(b.zero), _jbits(a.zero))


def test_asym_scale_on_bf16_midpoint():
    """A block whose f32 quotient (max - min) / 15 lands on a bf16
    rounding midpoint: the scale must round as XLA's reciprocal multiply
    does, not as a true division would."""
    mn, mx = np.float32(-0.08249719), np.float32(0.108390264)
    w = np.zeros((32, 4), np.float32)
    w[0], w[1] = mn, mx
    div = torch.tensor([(mx - mn) / np.float32(15)]).to(torch.bfloat16)
    mul = torch.tensor([(mx - mn) * np.float32(1 / 15)]).to(torch.bfloat16)
    assert div.item() != mul.item()          # the case really is a midpoint
    a = jq.quantize(jnp.asarray(w), "asym_int4")
    b = tq.quantize(torch.from_numpy(w), "asym_int4")
    np.testing.assert_array_equal(_bits(b.scale), _jbits(a.scale))


@pytest.mark.parametrize("qtype", QTYPES)
def test_dequantize_bit_identical_after_bridge(qtype):
    w = _weights(300, 64, seed=5)
    a = jq.quantize(jnp.asarray(w), qtype)
    b = bridge.qtensor_from_numpy(jax.tree.map(np.asarray, a), device="cpu")
    want = _jbits(jq.dequantize(a))
    got = _bits(tq.dequantize(b))
    assert got.shape == (300, 64)
    np.testing.assert_array_equal(got, want)
    # f32 output too (no final bf16 rounding)
    np.testing.assert_array_equal(
        tq.dequantize(b, torch.float32).numpy(),
        np.asarray(jq.dequantize(a, jnp.float32)))


def test_stacked_planes_and_concat_split_roundtrip():
    ws = [_weights(128, n, seed=n) for n in (32, 48, 16)]
    ja = [jq.quantize(jnp.asarray(w), "sym_int4") for w in ws]
    stacked = jax.tree.map(lambda *xs: jnp.stack(xs), ja[0], ja[0])
    tb = bridge.qtensor_from_numpy(jax.tree.map(np.asarray, stacked),
                                   device="cpu")
    assert tuple(tb.data.shape) == (2, 64, 32) and tb.shape == (128, 32)
    np.testing.assert_array_equal(_bits(tq.dequantize(tb.index(1))),
                                  _jbits(jq.dequantize(ja[0])))
    tparts = [tq.quantize(torch.from_numpy(w), "sym_int4") for w in ws]
    cat = tq.concat_qtensors_n(tparts)
    jcat = jq.concat_qtensors_n(ja)
    assert cat.shape == (128, 96)
    np.testing.assert_array_equal(_bits(cat.data), _jbits(jcat.data))
    back = tq.split_qtensor_n(cat, [32, 48, 16])
    for p, q in zip(back, tparts):
        np.testing.assert_array_equal(_bits(p.data), _bits(q.data))
        np.testing.assert_array_equal(_bits(p.scale), _bits(q.scale))


def test_bridge_bf16_leaves_keep_their_bits():
    x = jnp.asarray(np.linspace(-3, 3, 24, dtype=np.float32)).astype(
        jnp.bfloat16)
    as_bf16 = bridge.tensor_from_numpy(np.asarray(x), device="cpu")
    as_u16 = bridge.tensor_from_numpy(np.asarray(x).view(np.uint16),
                                      device="cpu")
    assert as_bf16.dtype == as_u16.dtype == torch.bfloat16
    np.testing.assert_array_equal(_bits(as_bf16), _jbits(x))
    np.testing.assert_array_equal(_bits(as_u16), _jbits(x))


def test_unported_qtype_raises():
    with pytest.raises(ValueError, match="unported"):
        tq.quantize(torch.zeros(64, 8), "q2_k")


def _port_sources():
    root = os.path.join(REPO, "bigdl_tpu_torch")
    for dirpath, _, files in os.walk(root):
        for fn in files:
            if fn.endswith(".py"):
                yield os.path.join(dirpath, fn)
    yield os.path.join(REPO, "chip_smoke.py")


def _forbidden(module: str) -> bool:
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "safetensors") or top == "bigdl_tpu"


def test_port_never_imports_jax_or_the_jax_package():
    """AST guard: no `import jax...`, no import of bigdl_tpu or
    bigdl_tpu.* and none of safetensors (the card's machine has no such
    package) anywhere in the port or its chip smoke (bigdl_tpu_torch
    itself is fine: the module name is matched exactly)."""
    bad = []
    files = list(_port_sources())
    assert len(files) > 10
    rel = {os.path.relpath(f, REPO) for f in files}
    assert {"bigdl_tpu_torch/ops/paged.py", "bigdl_tpu_torch/ops/random.py",
            "bigdl_tpu_torch/serving/pagepool.py",
            "bigdl_tpu_torch/ops/cuda/paged_decode_attention.py",
            "bigdl_tpu_torch/transformers/lowbit_io.py",
            "bigdl_tpu_torch/transformers/model.py",
            "bigdl_tpu_torch/models/registry.py",
            "bigdl_tpu_torch/serving/api_server.py",
            "bigdl_tpu_torch/observability/metrics.py",
            "bigdl_tpu_torch/observability/tracing.py",
            "bigdl_tpu_torch/cuda_graph.py"} <= rel
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            bad += [(path, n) for n in names if _forbidden(n)]
    assert not bad, bad
    assert not _forbidden("bigdl_tpu_torch.ops.quant")
    assert _forbidden("bigdl_tpu.ops") and _forbidden("jax.numpy")
    assert _forbidden("safetensors.numpy")
