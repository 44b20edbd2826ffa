"""B2 (std and i4) and B6's quantized prefill tiles on the Hopper GEMM body
(``csrc/dequant_wgmma.cuh``), on the CPU.

The body runs only on the card, where chip_smoke.py holds it against the
plain versions below. Here:

- B2's plain version against the JAX package's Pallas kernel
  (``q_matmul_pallas`` in interpret mode, as tests/test_pallas_matmul.py
  runs it) at the rows the body takes past B1 (64, 100, 128), every ported
  qtype, at a K that needs padding; rtol = atol = 3e-2 (bf16 outputs, f32
  sums in another order), as tests/test_torch_matmul.py.
- B6's plain version against ``ragged_expert_matmul(interpret=True)`` on a
  skewed routing built by ``ragged_routing`` (one expert over two tiles,
  one with no row, trailing empty tiles), within one bf16 ulp as
  tests/test_torch_moe.py's rule.
- The body's host-side geometry, as plain functions and as what the
  wrappers hand the native library (stood in for, as
  tests/test_torch_smallm.py does): tokens a wgmma, column strips, K split
  and tickets, workspace, and which operands arrive by TMA and which by
  cp.async, at the Llama-2-7B and Mixtral-8x7B widths and the smoke's
  every-qtype shape (K 1000, N 512).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.ops.pallas import moe_dispatch as jmoe
from bigdl_tpu.ops.pallas.dequant_matmul import q_matmul_pallas
from bigdl_tpu.ops.quant import quantize as jax_quantize
from bigdl_tpu_torch import _native, bridge
from bigdl_tpu_torch.ops.cuda import LAUNCHES
from bigdl_tpu_torch.ops.cuda import dequant_matmul as dm
from bigdl_tpu_torch.ops.cuda import moe_dispatch as cmoe
from bigdl_tpu_torch.ops.moe_dispatch import ragged_routing
from bigdl_tpu_torch.ops.quant import (QTensor, get_qtype, quantize,
                                       to_mxu_layout)
from torch_threads import one_intra_op_thread  # noqa: F401

QTYPES = ["sym_int4", "asym_int4", "sym_int8", "nf4", "fp4", "nf3"]
SMS = 132
OCC = 1

# [K, N] of each linear the body takes on the main path
LLAMA2_7B = {"qkv_proj": (4096, 12288), "o_proj": (4096, 4096),
             "gate_up_proj": (4096, 22016), "down_proj": (11008, 4096),
             "lm_head": (4096, 32000)}
MIXTRAL = {"gate_up": (4096, 14336), "down": (14336, 4096)}
SMALL = {"every_qtype": (1000, 512)}
WIDTHS = {**LLAMA2_7B, **MIXTRAL, **SMALL}


def _pair(k, n, qtype, seed, layout="canonical"):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    jw = jax_quantize(jnp.asarray(w), qtype)
    tw = bridge.qtensor_from_numpy(jax.tree.map(np.asarray, jw), device="cpu")
    return jw, (to_mxu_layout(tw) if layout == "int4" else tw)


def _x(m, k, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)) * 0.3).astype(np.float32)


# -- B2's plain version against the Pallas kernel ---------------------------

@pytest.mark.parametrize("qtype", QTYPES)
@pytest.mark.parametrize("m", [64, 100, 128])
def test_gemm_plain_version_matches_pallas_interpret(qtype, m):
    k, n = 200, 128                  # K padded to the block, past a chunk
    jw, tw = _pair(k, n, qtype, seed=40)
    x = _x(m, k, seed=41)
    want = np.asarray(q_matmul_pallas(jnp.asarray(x), jw, interpret=True),
                      np.float32)
    got = dm.dequant_gemm(torch.from_numpy(x), tw, "std")
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2,
                               atol=3e-2)


@pytest.mark.parametrize("m", [33, 100])
def test_gemm_i4_plain_version_at_ragged_rows(m):
    """The int4 layout at rows that are no multiple of a wgmma's tokens
    (K 200 padded to 224)."""
    k, n = 200, 256
    jw, tw = _pair(k, n, "sym_int4", seed=42, layout="int4")
    x = _x(m, k, seed=43)
    want = np.asarray(q_matmul_pallas(jnp.asarray(x), jw, interpret=True),
                      np.float32)
    got = dm.dequant_gemm(torch.from_numpy(x), tw, "i4")
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2,
                               atol=3e-2)


# -- B6's plain version on a skewed routing ---------------------------------

def _bf16_ulp(a):
    e = np.floor(np.log2(np.maximum(np.abs(a), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def _skewed_topi(n_tok):
    """top-2 of 4 experts: expert 0 in 150 choices (two tiles), expert 3 in
    none; the rest spread over experts 1 and 2."""
    return np.asarray([(0, 1 + i % 2) if i < 150 else (1, 2)
                       for i in range(n_tok)], np.int64)


@pytest.mark.parametrize("qtype", ["sym_int4", "asym_int4", "sym_int8",
                                   "nf4"])
def test_ragged_plain_matches_interpret_on_skewed_routing(qtype):
    e, k, n, n_tok = 4, 128, 256, 200
    r = ragged_routing(torch.from_numpy(_skewed_topi(n_tok)), e)
    te = r.tile_expert.tolist()
    rows = r.tile_rows.tolist()
    # expert 0 over two tiles, expert 3 with none, trailing empty tiles
    assert te[:2] == [0, 0] and rows[:2] == [128, 22]
    assert 3 not in [x for x, c in zip(te, rows) if c]
    assert rows[-1] == 0
    rng = np.random.default_rng(44)
    x = np.zeros((r.np_, k), np.float32)
    x[r.dest.numpy()] = rng.standard_normal((len(r.dest), k)) * 0.3
    jw = jax.tree.map(lambda *xs: jnp.stack(xs), *[
        jax_quantize(jnp.asarray(rng.standard_normal((k, n)).astype(
            np.float32) * 0.05), qtype) for _ in range(e)])
    tw = bridge.params_from_numpy(jax.tree.map(np.asarray, jw),
                                  device="cpu")
    want = np.asarray(jmoe.ragged_expert_matmul(
        jnp.asarray(x, jnp.bfloat16), jw,
        jnp.asarray(r.tile_expert.numpy()), interpret=True), np.float32)
    got = cmoe.ragged_expert_matmul(
        torch.from_numpy(x).to(torch.bfloat16), tw, r.tile_expert,
        r.tile_rows, max_tile_rows=128).float().numpy()
    floor = np.abs(want).max() * 2.0 ** -16
    ulp = _bf16_ulp(np.maximum(np.maximum(np.abs(got), np.abs(want)),
                               floor))
    assert np.all(np.abs(got - want) <= ulp), float(
        np.max(np.abs(got - want) / ulp))
    # the rows no tile holds are zeros
    real = np.zeros(r.np_, bool)
    real[r.dest.numpy()] = True
    assert not got[~real].any()


# -- the body's geometry -----------------------------------------------------

@pytest.mark.parametrize("m,tokens", [(1, 64), (33, 64), (64, 64),
                                      (65, 128), (100, 128), (128, 128)])
def test_tokens_a_wgmma(m, tokens):
    assert dm.wgmma_tokens(m) == tokens


@pytest.mark.parametrize("blocks,slots,chunks,split", [
    (86, 132, 64, 1), (48, 132, 64, 2), (16, 132, 64, 5),
    (16, 132, 172, 5), (32, 264, 64, 5), (30, 132, 64, 4),
    (2, 132, 16, 1), (2, 132, 40, 3), (672, 132, 64, 1)])
def test_wgmma_split_keeps_one_wave(blocks, slots, chunks, split):
    """As many splits as one wave holds, at most 5, at least 12 chunks a
    split."""
    assert dm.wgmma_split(blocks, slots, chunks) == split


@pytest.mark.parametrize("lname", sorted(WIDTHS))
def test_strips_split_and_workspace_at_main_path_widths(monkeypatch, lname):
    """256-column strips; the K split that keeps one wave resident at one
    block an SM; a workspace and a ticket a strip only when K is split."""
    k, n = WIDTHS[lname]
    monkeypatch.setattr(dm, "_sm_count", lambda device: SMS)
    monkeypatch.setattr(dm, "_occupancy", {})
    monkeypatch.setattr(dm._native, "kernel",
                        lambda lib, sym=None: (lambda *a: OCC))
    strips = dm.wgmma_strips(n)
    assert strips == -(-n // 256) and dm._block_cols("dequant_gemm", 1) == 256
    kp = -(-k // 32) * 32
    chunks = -(-kp // 64)
    for m in (33, 64, 100, 128):
        split, per = dm._split_k("dequant_gemm", m, n, kp, 0, 1,
                                 torch.device("cpu"))
        assert (split - 1) * per < chunks <= split * per
        assert split == -(-chunks // -(-chunks // dm.wgmma_split(
            strips, OCC * SMS, chunks)))
        shape = dm.wgmma_workspace(split, m, n)
        assert shape == ((split, m, n) if split > 1 else None)
    # one wave at one block an SM, at least 12 chunks and at most 5 splits:
    # gate_up's 86 strips and lm_head's 125 alone, qkv's 48 (Mixtral
    # gate_up's 56) in 2 splits, the 16 strips of N 4096 in 5, the smoke's
    # 2 strips (16 chunks) in 1
    want = {"gate_up_proj": 1, "qkv_proj": 2, "o_proj": 5,
            "down_proj": 5, "lm_head": 1, "gate_up": 2, "down": 5,
            "every_qtype": 1}[lname]
    assert dm._split_k("dequant_gemm", 128, n, kp, 0, 1,
                       torch.device("cpu"))[0] == want


@pytest.mark.parametrize("lname", sorted(WIDTHS))
@pytest.mark.parametrize("qtype", QTYPES)
def test_plane_loads_at_main_path_widths(lname, qtype):
    """Every main-path width is a multiple of 16: all planes by TMA."""
    n = WIDTHS[lname][1]
    loads = dm.plane_loads(n, qtype, [0, 256, 4096])
    want = {"x": "tma", "codes": "tma", "scale": "tma"}
    if qtype == "asym_int4":
        want["zero"] = "tma"
    assert loads == want


@pytest.mark.parametrize("n,addresses,way", [
    (260, [0, 256], "cp.async"),          # N % 16 != 0 (4-column rows)
    (4104, [0, 256], "cp.async"),         # N % 16 == 8
    (4096, [0, 264], "cp.async"),         # a plane 8-byte aligned
    (4096, [0, 256, 4096 * 2048, 2 * 64 * 4096], "tma"),
    (4096, [0, 256, 4100], "cp.async")])  # an expert stride off 16 bytes
def test_plane_loads_fall_back_to_cp_async(n, addresses, way):
    loads = dm.plane_loads(n, "asym_int4", addresses)
    assert loads == {"x": "tma", "codes": way, "scale": way, "zero": way}


class _Lib:
    """Stand-in for the native libraries: occupancy queries answer OCC,
    launches return 0; every call is recorded."""

    def __init__(self):
        self.calls = []

    def kernel(self, lib, sym=None):
        def fn(*args):
            self.calls.append((lib, sym, args))
            return OCC if sym and sym.endswith("_blocks_per_sm") else 0
        return fn

    def launches(self):
        return [c for c in self.calls
                if not (c[1] or "").endswith("_blocks_per_sm")]


@pytest.fixture
def lib(monkeypatch):
    rec = _Lib()
    monkeypatch.setattr(_native, "kernel", rec.kernel)
    monkeypatch.setattr(dm, "_sm_count", lambda device: SMS)
    monkeypatch.setattr(dm, "_occupancy", {})
    monkeypatch.setattr(dm, "_tickets", {})
    monkeypatch.setattr(dm, "_stream", lambda device: 0)
    monkeypatch.setattr(cmoe, "_stream", lambda device: 0)
    # the device checks: CPU tensors stand for CUDA ones here (x padded
    # to the weight's Kp, as _prepare pads it)
    def prepare(x, w, name):
        return torch.nn.functional.pad(x.to(torch.bfloat16),
                                       (0, w.kp - w.k)).contiguous()
    monkeypatch.setattr(dm, "_prepare", prepare)
    monkeypatch.setattr(cmoe, "_prepare", prepare)
    monkeypatch.setattr(cmoe, "_require_cuda", lambda x, name: None)
    return rec


def _weight(k, n, qtype="sym_int4", layout="canonical", seed=0):
    """A [K, N] weight for the geometry tests, whose launches are stood in
    for: one quantized block row tiled down K, so the planes have the
    real shapes, dtypes and strides without quantizing K x N floats."""
    g = torch.Generator().manual_seed(seed)
    b = get_qtype(qtype).block_size
    w = quantize(torch.randn((b, n), generator=g) * 0.05, qtype)
    if layout == "int4":
        w = to_mxu_layout(w)
    nblk = -(-k // b)
    return QTensor(w.data.repeat(nblk, 1), w.scale.repeat(nblk, 1),
                   None if w.zero is None else w.zero.repeat(nblk, 1),
                   qtype, (k, n), w.layout)


@pytest.mark.parametrize("body,qtype,layout", [
    ("std", "sym_int4", "canonical"), ("std", "asym_int4", "canonical"),
    ("std", "sym_int8", "canonical"), ("std", "nf4", "canonical"),
    ("i4", "sym_int4", "int4")])
@pytest.mark.parametrize("m,k,n", [(128, 4096, 22016), (33, 4096, 4096),
                                   (100, 1000, 512), (96, 640, 260)])
def test_b2_bodies_share_one_entry_point(lib, body, qtype, layout, m, k, n):
    """std and i4 are one native call of dequant_gemm's entry, the weight
    kind picking the decode; each counts its own launches; the planes'
    loads, split, workspace and tickets follow the geometry functions."""
    w = _weight(k, n, qtype, layout)
    name = dm._GEMM[body]
    before = dict(LAUNCHES)
    y = dm._launch_gemm(name, torch.zeros(m, k), w)
    assert y.shape == (m, n) and y.dtype == torch.bfloat16
    assert LAUNCHES[name] == before[name] + 1
    other = dm._GEMM["i4" if body == "std" else "std"]
    assert LAUNCHES[other] == before[other]
    (libname, sym, args), = lib.launches()
    assert (libname, sym) == ("dequant_gemm", None)
    kp = w.kp
    split, per = dm._split_k(name, m, n, kp, dm._kind(w), 1,
                             torch.device("cpu"))
    kind = dm._KIND_I4 if layout == "int4" else dm._kind(w)
    assert args[8:16] == (m, kp, n, w.qt.block_size, kind, split, per,
                          int(n % 16 == 0))
    # the occupancy query names the variant: tokens from M, the kind
    q = [c for c in lib.calls if c[1] == "bigdl_dequant_gemm_blocks_per_sm"]
    assert q and q[0][2] == (m, kind)
    if split > 1:
        buf = dm._tickets[("cpu", None)]
        assert args[6] == buf.data_ptr()
        assert buf.numel() >= dm.wgmma_strips(n) and not buf.any()
        assert args[5] is not None
    else:
        assert args[5] is None and args[6] is None


def _stack(e, k, n, qtype="sym_int4"):
    ws = [_weight(k, n, qtype, seed=i) for i in range(e)]
    return QTensor(torch.stack([w.data for w in ws]),
                   torch.stack([w.scale for w in ws]),
                   None if ws[0].zero is None
                   else torch.stack([w.zero for w in ws]), qtype,
                   ws[0].shape)


@pytest.mark.parametrize("k,n", [(4096, 14336), (14336, 4096), (1000, 512),
                                 (640, 260)])
@pytest.mark.parametrize("qtype", ["sym_int4", "asym_int4"])
def test_b6_tiles_take_the_hopper_body(lib, k, n, qtype):
    """A quantized stack's tiles entry: the expert strides in the call,
    tickets for every (tile, strip) and a workspace of the whole buffer
    when K is split, the planes' loads from N and the strides."""
    e, tiles = 4, 3
    w = _stack(e, k, n, qtype)
    x = torch.zeros((tiles * cmoe.TOKEN_TILE, k), dtype=torch.bfloat16)
    te = torch.tensor([0, 2, 3], dtype=torch.int32)
    tr = torch.tensor([128, 40, 0], dtype=torch.int32)
    y = cmoe._launch(x, w, te, tr, max_tile_rows=128)
    assert y.shape == (tiles * cmoe.TOKEN_TILE, n)
    (libname, sym, args), = lib.launches()
    assert (libname, sym) == ("moe_dispatch", None)
    split, per = dm._split_k("moe_dispatch", 128, n, w.kp, dm._kind(w), 1,
                             torch.device("cpu"), tiles=tiles)
    data_es, scale_es = w.plane_strides()
    assert args[10:21] == (tiles * 128, w.kp, n, w.qt.block_size,
                           dm._kind(w), e, data_es, scale_es, split, per,
                           int(n % 16 == 0))
    q = [c for c in lib.calls if c[1] == "bigdl_moe_dispatch_blocks_per_sm"]
    assert q and q[0][2] == (dm._kind(w),)
    if split > 1:
        buf = dm._tickets[("cpu", None)]
        assert args[8] == buf.data_ptr()
        assert buf.numel() >= tiles * dm.wgmma_strips(n)
    else:
        assert args[7] is None and args[8] is None


def test_b6_dense_stack_keeps_its_body(lib):
    """A dense bf16 stack's tiles entry is the Hopper body's: kind bf16,
    block 16, its byte expert stride, the split of the body's occupancy
    query for that kind, tickets for every (tile, strip) and a workspace
    of the whole buffer when K is split, and TMA for 16-byte rows
    (cp.async for N % 8 != 0); one native call, counted as the dense
    body's launch."""
    e, tiles = 2, 2
    for k, n, tma in ((4096, 512, 1), (256, 260, 0)):
        lib.calls.clear()
        dm._occupancy.clear()
        w = torch.zeros((e, k, n), dtype=torch.bfloat16)
        x = torch.zeros((tiles * cmoe.TOKEN_TILE, k), dtype=torch.bfloat16)
        te = torch.tensor([0, 1], dtype=torch.int32)
        tr = torch.tensor([128, 7], dtype=torch.int32)
        before = dict(LAUNCHES)
        y = cmoe._launch(x, w, te, tr, max_tile_rows=128)
        assert y.shape == (tiles * 128, n) and y.dtype == torch.bfloat16
        assert LAUNCHES["ragged_expert_matmul_dense"] == \
            before["ragged_expert_matmul_dense"] + 1
        assert LAUNCHES["ragged_expert_matmul"] == \
            before["ragged_expert_matmul"]
        (libname, sym, args), = lib.launches()
        assert (libname, sym) == ("moe_dispatch", None)
        split, per = dm._split_k("moe_dispatch", 128, n, k, cmoe._KIND_BF16,
                                 1, torch.device("cpu"), tiles=tiles)
        assert args[10:21] == (tiles * 128, k, n, 16, cmoe._KIND_BF16, e,
                               k * n * 2, 0, split, per, tma)
        q = [c for c in lib.calls
             if c[1] == "bigdl_moe_dispatch_blocks_per_sm"]
        assert q and q[0][2] == (cmoe._KIND_BF16,)
        if split > 1:
            buf = dm._tickets[("cpu", None)]
            assert args[8] == buf.data_ptr()
            assert buf.numel() >= tiles * dm.wgmma_strips(n)
            assert args[7] is not None
        else:
            assert args[7] is None and args[8] is None
    # K 4096 over 2 x 2 strips splits (one wave holds it), K 256 does not
    assert dm._split_k("moe_dispatch", 128, 512, 4096, cmoe._KIND_BF16, 1,
                       torch.device("cpu"), tiles=2)[0] > 1


@pytest.mark.parametrize("n,addresses,way", [
    (14336, [0, 4096 * 14336 * 2], "tma"), (4096, [256, 1024], "tma"),
    (260, [0, 512], "cp.async"), (4100, [0, 256], "cp.async"),
    (4096, [8, 256], "cp.async"), (4096, [0, 4104], "cp.async")])
def test_dense_loads_need_16_byte_rows(n, addresses, way):
    """A dense stack's rows go by TMA when a row is a multiple of 16 bytes
    and the stack and its expert stride are 16-byte aligned."""
    assert cmoe.dense_loads(n, addresses) == way


def test_b6_at_b2_split_is_b2_geometry(monkeypatch, lib):
    """chip_smoke.py holds B6 at B2's split bit for bit: B2's split at
    M 128 is a valid split of B6's tiles entry at the same K."""
    k, n = 4096, 14336
    w = _stack(2, k, n)
    sp = dm._split_k("dequant_gemm", 128, n, w.kp, dm._kind(w), 1,
                     torch.device("cpu"))
    x = torch.zeros((2 * cmoe.TOKEN_TILE, k), dtype=torch.bfloat16)
    te = torch.tensor([0, 1], dtype=torch.int32)
    tr = torch.tensor([128, 60], dtype=torch.int32)
    cmoe._launch(x, w, te, tr, split=sp, max_tile_rows=128)
    (_, _, args), = lib.launches()
    assert args[18:20] == sp


def test_no_second_pass_and_one_header():
    """B2's two bodies and B6's quantized tiles include the Hopper header
    and launch no finalize kernel; the i4 body left the variants library."""
    import os
    csrc = _native.CSRC
    hdr = open(os.path.join(csrc, "dequant_wgmma.cuh")).read()
    assert "wgmma.mma_async" in hdr and "cp.async.bulk.tensor" in hdr
    assert "finalize" not in hdr and "atomicAdd(&a.tickets" in hdr
    gemm = open(os.path.join(csrc, "dequant_gemm.cu")).read()
    assert '#include "dequant_wgmma.cuh"' in gemm and "finalize" not in gemm
    moe = open(os.path.join(csrc, "moe_dispatch.cu")).read()
    assert '#include "dequant_wgmma.cuh"' in moe
    variants = open(os.path.join(csrc, "dequant_variants.cu")).read()
    assert "BODY_I4" not in variants
    assert "dequant_gemm_i4" not in dm._VARIANT_BODY
