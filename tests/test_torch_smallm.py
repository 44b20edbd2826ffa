"""Launch geometry of the small-M body (``csrc/dequant_smallm.cuh``): B1's
decode GEMVs (std, mxu, fold, mxuflat, mxu8) and B6's small-M entry, on
the CPU.

The CUDA kernels cannot run here, so these tests stand in for the native
library (``_native.kernel``) and the device checks, as
tests/test_torch_matmul.py's geometry tests do, and record what the
wrappers hand the library: the entry point, the variant's rows and words,
the K split, the workspace and the split-K tickets. One B1 call is one
native call (the split is summed in the same launch, no second kernel),
the ticket buffer covers every column strip (and token tile), and B6
picks its entry from the host-side bound on a tile's real rows alone.
The kernels' numbers are held against their plain versions on the card
by chip_smoke.py.
"""

import os

import pytest
import torch

from bigdl_tpu_torch import _native
from bigdl_tpu_torch.ops import moe_dispatch as moe
from bigdl_tpu_torch.ops.cuda import LAUNCHES
from bigdl_tpu_torch.ops.cuda import dequant_matmul as dm
from bigdl_tpu_torch.ops.cuda import moe_dispatch as cmoe
from bigdl_tpu_torch.ops.quant import QTensor, quantize, to_mxu_layout
from torch_threads import one_intra_op_thread  # noqa: F401

SMS = 132
OCC = 2


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
    # the device checks: CPU tensors stand for CUDA ones here
    monkeypatch.setattr(
        dm, "_prepare",
        lambda x, w, name: x.to(torch.bfloat16).contiguous())
    monkeypatch.setattr(cmoe, "_prepare",
                        lambda x, w, name: x.to(torch.bfloat16).contiguous())
    monkeypatch.setattr(cmoe, "_require_cuda", lambda x, name: None)
    return rec


def _weight(k, n, layout, qtype="sym_int4", seed=0):
    g = torch.Generator().manual_seed(seed)
    w = quantize(torch.randn((k, n), generator=g) * 0.05, qtype)
    return to_mxu_layout(w) if layout == "int4" else w


def _stack(e, k, n, qtype="sym_int4"):
    ws = [_weight(k, n, "canonical", qtype, seed=i) for i in range(e)]
    return QTensor(torch.stack([w.data for w in ws]),
                   torch.stack([w.scale for w in ws]),
                   None if ws[0].zero is None
                   else torch.stack([w.zero for w in ws]), qtype,
                   ws[0].shape)


# -- B1: std and mxu -------------------------------------------------------

@pytest.mark.parametrize("body", ["std", "mxu"])
@pytest.mark.parametrize("m", [1, 8, 9, 16, 17, 32])
@pytest.mark.parametrize("k,n", [(1024, 512), (512, 4096), (640, 260)])
def test_std_and_mxu_take_the_small_m_body(lib, body, m, k, n):
    """M 1-32: one native call on the small-M body (strips of 32 cw
    columns), its split summed in the same launch: tickets for every strip
    when K is split, none otherwise."""
    w = _weight(k, n, "int4" if body == "mxu" else "canonical")
    name = dm._GEMV[body]
    before = LAUNCHES[name]
    y = dm._launch(name, torch.zeros(m, k), w)
    assert y.shape == (m, n) and y.dtype == torch.bfloat16
    assert LAUNCHES[name] == before + 1
    (libname, sym, args), = lib.launches()
    cw = 4 if m <= 16 and n % 16 == 0 else \
        2 if m > 16 and n % 8 == 0 else 1
    strips = -(-n // (32 * cw))
    split, per = dm._split_k(name, m, n, k, dm._kind(w), cw,
                             torch.device("cpu"))
    if body == "std":
        assert (libname, sym) == ("dequant_gemv", None)
        tickets, shape = args[6], args[8:11]
    else:
        assert (libname, sym, args[0]) == ("dequant_variants", None, 0)
        tickets, shape = args[6], args[8:11]
    assert shape == (m, k, n)
    assert args[-4:-1] == (split, per, cw)
    # the split with the fewest waves a split, no empty split
    chunks = -(-k // 64)
    assert split == -(-chunks // -(-chunks // dm._balanced_split(
        strips, OCC * SMS, chunks)))
    assert (split - 1) * per < chunks <= split * per
    if split > 1:
        buf = dm._tickets[("cpu", None)]
        assert tickets == buf.data_ptr() and buf.numel() >= strips
        assert buf.dtype == torch.int32 and not buf.any()
    else:
        assert tickets is None and args[5] is None   # no workspace


@pytest.mark.parametrize("qtype,layout", [("sym_int4", "int4"),
                                          ("sym_int8", "canonical")])
@pytest.mark.parametrize("m", [1, 8, 9, 17, 32])
@pytest.mark.parametrize("k,n", [(4096, 22016), (1000, 512), (640, 260)])
def test_mxu8_is_one_small_m_launch(lib, monkeypatch, qtype, layout, m, k,
                                    n):
    """mxu8 is one native call of the variants library's body 3 with the
    bf16 x as it is (the kernel quantizes it: no ``quantize_x_q8`` off the
    CPU), the weight kind (int4 layout or sym_int8), the small-M words and
    split, and, when K is split, the device's workspace and tickets."""
    def no_q8(x2):
        raise AssertionError("quantize_x_q8 ran for a kernel launch")
    monkeypatch.setattr(dm, "quantize_x_q8", no_q8)
    monkeypatch.setattr(dm, "_workspaces", {})
    w = _weight(k, n, layout, qtype)
    name = dm._GEMV["mxu8"]
    before = LAUNCHES[name]
    # (the stood-in _prepare does not pad K to the weight's Kp)
    x = torch.nn.functional.pad(torch.randn(m, k), (0, w.kp - k))
    y = dm._launch(name, x, w)
    assert y.shape == (m, n) and y.dtype == torch.bfloat16
    assert LAUNCHES[name] == before + 1
    (libname, sym, args), = lib.launches()
    assert (libname, sym, args[0]) == ("dequant_variants", None, 3)
    kp = w.kp
    kind = dm._KIND_I4 if layout == "int4" else dm._KIND_SYM8
    cw = dm._cw(name, n, m)
    assert cw == (4 if m <= 16 and n % 16 == 0 else
                  2 if m > 16 and n % 8 == 0 else 1)
    split, per = dm._split_k(name, m, n, kp, kind, cw, torch.device("cpu"))
    assert args[8:] == (m, kp, n, 32, kind, split, per, cw, 0)
    q = [c for c in lib.calls
         if c[1] == "bigdl_dequant_variant_blocks_per_sm"]
    assert q and q[0][2] == (3, m, kind, cw)
    if split > 1:
        assert args[5] == dm._workspaces[("cpu", None)].data_ptr()
        assert dm._workspaces[("cpu", None)].numel() >= split * m * n
        assert args[6] == dm._tickets[("cpu", None)].data_ptr()
    else:
        assert args[5] is None and args[6] is None
    # x reaches the kernel as bf16, unquantized
    assert args[1] != 0


# (body, qtype, layout): fold over the canonical kinds it reads, mxuflat
# over the int4 layout
FOLD_MXUFLAT = [("fold", q, "canonical")
                for q in ("sym_int4", "nf4", "fp4", "nf3", "sym_int8")] + [
                    ("mxuflat", "sym_int4", "int4")]


@pytest.mark.parametrize("body,qtype,layout", FOLD_MXUFLAT)
@pytest.mark.parametrize("m", [1, 8, 9, 17, 32])
@pytest.mark.parametrize("k,n", [(4096, 5504), (1000, 512), (640, 260)])
def test_fold_and_mxuflat_take_the_small_m_body(lib, monkeypatch, body,
                                                 qtype, layout, m, k, n):
    """fold (sym_int4, nf4, fp4, nf3, sym_int8) and mxuflat (the int4
    layout) are one native call of the variants library's body id with the
    weight's kind, block and LUT, the small-M words and
    ``_balanced_split``'s split from that variant's occupancy query, and,
    when K is split, the device's workspace and tickets for every strip."""
    monkeypatch.setattr(dm, "_workspaces", {})
    w = _weight(k, n, layout, qtype)
    name = dm._GEMV[body]
    before = LAUNCHES[name]
    # (the stood-in _prepare does not pad K to the weight's Kp)
    x = torch.nn.functional.pad(torch.randn(m, k), (0, w.kp - k))
    y = dm._launch(name, x, w)
    assert y.shape == (m, n) and y.dtype == torch.bfloat16
    assert LAUNCHES[name] == before + 1
    (libname, sym, args), = lib.launches()
    body_id = dm._VARIANT_BODY[name]
    assert (libname, sym, args[0]) == ("dequant_variants", None, body_id)
    kind = dm._KIND_I4 if body == "mxuflat" else {
        "sym_int4": 0, "nf4": 2, "fp4": 2, "nf3": 2, "sym_int8": 3}[qtype]
    block = 64 if kind == 2 else 32
    kp = w.kp
    cw = 4 if m <= 16 and n % 16 == 0 else \
        2 if m > 16 and n % 8 == 0 else 1
    assert dm._cw(name, n, m) == cw
    strips, chunks = -(-n // (32 * cw)), -(-kp // 64)
    split, per = dm._split_k(name, m, n, kp, kind, cw, torch.device("cpu"))
    assert split == -(-chunks // -(-chunks // dm._balanced_split(
        strips, OCC * SMS, chunks)))
    assert (split - 1) * per < chunks <= split * per
    assert args[8:] == (m, kp, n, block, kind, split, per, cw, 0)
    assert (args[4] is not None) == (kind == 2)          # the codebook LUT
    q = [c for c in lib.calls
         if c[1] == "bigdl_dequant_variant_blocks_per_sm"]
    assert q and q[0][2] == (body_id, m, kind, cw)
    if split > 1:
        assert args[5] == dm._workspaces[("cpu", None)].data_ptr()
        assert dm._workspaces[("cpu", None)].numel() >= split * m * n
        buf = dm._tickets[("cpu", None)]
        assert args[6] == buf.data_ptr() and buf.numel() >= strips
        assert buf.dtype == torch.int32 and not buf.any()
    else:
        assert args[5] is None and args[6] is None


def test_workspace_buffer_is_kept_and_grown(monkeypatch):
    monkeypatch.setattr(dm, "_workspaces", {})
    cpu = torch.device("cpu")
    a = dm.workspace_buffer(cpu, 100)
    assert a.dtype == torch.float32 and a.numel() >= 100
    assert dm.workspace_buffer(cpu, 50) is a
    b = dm.workspace_buffer(cpu, 1000)
    assert b.numel() >= 1000 and dm.workspace_buffer(cpu, 10) is b


def test_small_m_occupancy_is_asked_per_row_tier(lib):
    """The occupancy query names the small-M variant: rows 8, 16 or 32
    (one query each), cw and the weight kind."""
    for m in (1, 5, 8, 9, 16, 17, 32):
        dm._split_k("dequant_gemv", m, 4096, 4096, 0, dm._cw(
            "dequant_gemv", 4096, m), torch.device("cpu"))
    queries = [c[2] for c in lib.calls]
    assert queries == [(1, 0, 4), (9, 0, 4), (17, 0, 2)]
    assert [dm.smallm_rows(m) for m in (1, 8, 9, 16, 17, 32)] == \
        [8, 8, 16, 16, 32, 32]


def test_no_second_pass_on_the_small_m_path():
    """Every B1 body (std; mxu, fold, mxuflat and mxu8 of the variants
    library) launches the small-M body and no split-K finalize kernel: the
    last block of a strip sums the splits. No other dequant body is left."""
    csrc = _native.CSRC
    body = open(os.path.join(csrc, "dequant_smallm.cuh")).read()
    assert "finalize" not in body and "atomicAdd(&tickets" in body
    gemv = open(os.path.join(csrc, "dequant_gemv.cu")).read()
    assert '#include "dequant_smallm.cuh"' in gemv
    assert "finalize" not in gemv and "dqmma::launch<" not in gemv
    variants = open(os.path.join(csrc, "dequant_variants.cu")).read()
    assert '#include "dequant_smallm.cuh"' in variants
    assert "finalize" not in variants and "dqmma::launch" not in variants
    assert "smallm::launch<NT, CW, K, FOLD, false, Q8>" in variants
    for b in ("BODY_MXU", "BODY_FOLD", "BODY_MXUFLAT", "BODY_MXU8"):
        assert f"case {b}:" in variants
    assert set(dm._GEMV.values()) <= dm._SMALLM
    assert not os.path.exists(os.path.join(csrc, "dequant_mma.cuh"))


@pytest.mark.parametrize("blocks,slots,chunks,split", [
    (172, 264, 64, 3), (32, 264, 64, 8), (250, 264, 64, 1),
    (1008, 264, 64, 1), (172, 396, 64, 2), (9, 528, 10, 1)])
def test_balanced_split_takes_whole_waves(blocks, slots, chunks, split):
    """The split whose waves a split are fewest (a short last wave idles
    SMs), the fewest splits within 5% of that, at most 8 chunks a split:
    e.g. gate_up's 172 strips on 264 slots take 3 splits (2 full waves)."""
    assert dm._balanced_split(blocks, slots, chunks) == split


def test_ticket_buffer_covers_the_strip_count(monkeypatch):
    monkeypatch.setattr(dm, "_tickets", {})
    cpu = torch.device("cpu")
    small = dm.ticket_buffer(cpu, 10)
    assert small.dtype == torch.int32 and small.numel() >= 10
    assert not small.any()
    assert dm.ticket_buffer(cpu, small.numel()) is small     # kept
    big = dm.ticket_buffer(cpu, small.numel() + 1)            # grown
    assert big.numel() > small.numel() and not big.any()
    assert dm.ticket_buffer(cpu, 3) is big


# -- B6: the small-M entry --------------------------------------------------

@pytest.mark.parametrize("rows,entry", [(1, "smallm"), (16, "smallm"),
                                        (32, "smallm"), (33, "tiles"),
                                        (128, "tiles"), (None, "tiles")])
def test_b6_entry_from_the_row_bound(rows, entry):
    """A quantized and a dense bf16 stack take the same entry: the small-M
    body at <= 32 rows, the Hopper body above."""
    w = _stack(2, 64, 32)
    assert cmoe.ragged_entry(w, rows) == entry
    dense = torch.zeros((2, 64, 32), dtype=torch.bfloat16)
    assert cmoe.ragged_entry(dense, rows) == entry


def test_b6_entry_refuses_an_empty_bound():
    with pytest.raises(ValueError, match="max_tile_rows"):
        cmoe.ragged_entry(_stack(2, 64, 32), 0)


@pytest.mark.parametrize("rows", [2, 16, 32, 40, None])
def test_b6_launch_picks_its_entry_from_the_bound_alone(lib, rows):
    """The entry follows max_tile_rows, not the device's tile_rows (here
    larger than the bound: the caller's contract, not read on the host):
    the small-M entry gets the bound, its words, a workspace of the staged
    rows and tickets for every (tile, strip) when K is split."""
    k, n, tiles = 512, 4096, 2
    w = _stack(2, k, n)
    x = torch.zeros((tiles * cmoe.TOKEN_TILE, k), dtype=torch.bfloat16)
    te = torch.tensor([0, 1], dtype=torch.int32)
    tr = torch.tensor([100, 0], dtype=torch.int32)
    y = cmoe._launch(x, w, te, tr, max_tile_rows=rows)
    assert y.shape == (tiles * cmoe.TOKEN_TILE, n)
    (libname, sym, args), = lib.launches()
    assert libname == "moe_dispatch"
    if rows is None or rows > cmoe.SMALLM_MAX_ROWS:
        assert sym is None                         # the 8-m-tile entry
        return
    assert sym == "bigdl_ragged_expert_matmul_smallm"
    cw = dm._cw("moe_dispatch_smallm", n, rows)
    split, per = dm._split_k("moe_dispatch_smallm", rows, n, k, 0, cw,
                             torch.device("cpu"), tiles=tiles)
    assert args[-5:-1] == (split, per, rows, cw)
    assert args[10:13] == (tiles * cmoe.TOKEN_TILE, k, n)
    if split > 1:
        buf = dm._tickets[("cpu", None)]
        assert args[8] == buf.data_ptr()
        assert buf.numel() >= tiles * -(-n // (32 * cw))
    else:
        assert args[7] is None and args[8] is None


@pytest.mark.parametrize("rows", [2, 8, 16, 17, 32])
@pytest.mark.parametrize("k,n", [(4096, 14336), (14336, 4096), (1008, 260)])
def test_b6_dense_decode_takes_the_small_m_entry(lib, rows, k, n):
    """A dense bf16 stack at <= 32 rows: the small-M entry with kind bf16,
    block 16, the stack's byte stride (no scale planes), 16-byte row loads
    (cw 2) where N % 8 == 0, else 8-byte, the split of the entry's
    occupancy query for that kind, and tickets for every (tile, strip) with
    a workspace of the staged rows when K is split; counted as the dense
    body's launch."""
    e, tiles = 4, 3
    w = torch.zeros((e, k, n), dtype=torch.bfloat16)
    x = torch.zeros((tiles * cmoe.TOKEN_TILE, k), dtype=torch.bfloat16)
    te = torch.tensor([0, 2, 3], dtype=torch.int32)
    tr = torch.tensor([rows, 1, 0], dtype=torch.int32)
    before = dict(LAUNCHES)
    y = cmoe._launch(x, w, te, tr, max_tile_rows=rows)
    assert y.shape == (tiles * cmoe.TOKEN_TILE, n)
    assert LAUNCHES["ragged_expert_matmul_dense"] == \
        before["ragged_expert_matmul_dense"] + 1
    (libname, sym, args), = lib.launches()
    assert (libname, sym) == ("moe_dispatch",
                              "bigdl_ragged_expert_matmul_smallm")
    cw = 2 if n % 8 == 0 else 1
    assert cmoe.dense_cw(n) == cw
    split, per = dm._split_k("moe_dispatch_smallm", rows, n, k,
                             cmoe._KIND_BF16, cw, torch.device("cpu"),
                             tiles=tiles)
    assert args[10:] == (tiles * 128, k, n, 16, cmoe._KIND_BF16, e,
                         k * n * 2, 0, split, per, rows, cw, 0)
    assert args[1] == args[2] == w.data_ptr() and args[3] is None
    q = [c for c in lib.calls
         if c[1] == "bigdl_moe_dispatch_smallm_blocks_per_sm"]
    assert q and q[0][2] == (rows, cmoe._KIND_BF16, cw)
    if split > 1:
        assert args[7] is not None
        buf = dm._tickets[("cpu", None)]
        assert args[8] == buf.data_ptr()
        assert buf.numel() >= tiles * -(-n // (32 * cw))
    else:
        assert args[7] is None and args[8] is None


def test_b6_dense_refuses_a_k_the_body_cannot_load():
    """A dense stack's K must be a whole number of the small-M body's
    16-row units (the JAX kernel's own dense tiles take K % 32)."""
    w = torch.zeros((2, 1000, 64), dtype=torch.bfloat16)
    x = torch.zeros((128, 1000), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="K % 16"):
        cmoe._prepare_dense(x, w.to("meta"), "ragged_expert_matmul")


@pytest.mark.parametrize("offset", [0, 1, 4, 8])
def test_b6_dense_x_reaches_the_kernel_16_byte_aligned(offset):
    """Both dense entries stage x with 16-byte loads (and their C entries
    refuse a misaligned x): a contiguous view at any offset arrives
    aligned, with its values."""
    k, n = 64, 32
    w = torch.zeros((2, k, n), dtype=torch.bfloat16)
    flat = torch.arange(128 * k + offset, dtype=torch.float32).to(
        torch.bfloat16)
    x = flat[offset:].view(128, k)
    assert x.is_contiguous()
    got = cmoe._prepare_dense(x, w, "ragged_expert_matmul")
    assert got.data_ptr() % 16 == 0
    assert torch.equal(got, x)


@pytest.mark.parametrize("n_tok,k",[(1, 2), (8, 2), (16, 2), (64, 2),
                                     (100, 2)])
def test_moe_mlp_ragged_passes_the_static_row_bound(monkeypatch, n_tok, k):
    """moe_mlp_ragged bounds a tile's real rows by the token-choice count
    N * k (at most a tile) for every B6 call, from shapes alone."""
    seen = []
    plain = cmoe.plain_ragged_expert_matmul

    def stand_in(x, w, te, tr, max_tile_rows=None):
        seen.append(max_tile_rows)
        return plain(x, w, te)
    monkeypatch.setattr(moe, "ragged_expert_matmul", stand_in)
    d, f, e = 64, 32, 4
    gen = torch.Generator().manual_seed(3)
    gate = _stack(e, d, f)
    up = _stack(e, d, f)
    down = _stack(e, f, d)
    xf = torch.randn((n_tok, d), generator=gen).to(torch.bfloat16)
    topi = torch.stack([torch.randperm(e, generator=gen)[:k]
                        for _ in range(n_tok)])
    topw = torch.full((n_tok, k), 1.0 / k)
    out = moe.moe_mlp_ragged(xf, topi, topw, gate, up, down,
                             torch.nn.functional.silu, e)
    assert out.shape == (n_tok, d)
    assert seen == [min(n_tok * k, cmoe.TOKEN_TILE)] * 3
