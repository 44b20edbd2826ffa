"""The one-launch prefill attention body B4 (``csrc/prefill_attention.cu``)
on the CPU.

The CUDA kernel cannot run here, so:
- the planner ``plan_prefill`` is held to its promises at the engine's
  prefill calls (one slot's private cache of S rows, S the prompt's
  bucket: a 128-token bucket against 128 rows, 256-token chunks at
  positions 0, 256, .., S - 256 against 256-2048 rows; Llama-2-7B's 32 kv
  heads and Mixtral's 8): as many live blocks as any plan gives, up to one
  on every SM, whether the position is known on the host or lives on the
  card (where the plan takes the cache's last chunk);
- the cut of each query tile's keys (``prefill_spans``, the kernel's
  formula) puts every visible (query, key) pair in exactly one span, keeps
  a tile of 256 keys or fewer whole, and stages no tile past the tile's
  last visible key's tile or the cache;
- the block geometry the planner assumes is the kernel's (its constants
  read from the source);
- blocks launch heaviest query tile first;
- a query tile's spans launch side by side, one thread-block cluster;
- the wrapper runs with the native library stood in for (as
  tests/test_torch_decode_hopper.py does) and makes one native launch a
  call with the plan's geometry (no workspace, no tickets);
- a torch model of the kernel's arithmetic (the block's rows, the spans,
  64-key tiles in an online base-2 softmax, the int8/int4 scales folded out
  of the products with P * v_scale rounded to bf16, the spans merged in
  order) is held against ``prefill_attention_pallas`` in interpret mode at
  every storage kind, MHA and GQA, hd 64 and 128, Sq 128 and 256, pos 0 and
  256, at per-row scales from 1e-3 to 1e2, within 3e-2 (the prefill
  tolerance of tests/test_torch_attention.py; its absolute part taken on
  each (query, head) row's own largest output, which those scales take
  from ~1e-3 to ~200): tests/test_torch_prefill_hopper_model_pos0.py and
  _pos256.py, one file a position so that xdist's ``--dist loadfile``
  spreads the slow cases (the model in tests/prefill_model.py).
  chip_smoke.py holds the kernel itself against the plain version on the
  card.
"""

import os
import re

import numpy as np
import pytest
import torch

from bigdl_tpu_torch import _native
from bigdl_tpu_torch.ops.cuda import LAUNCHES
from bigdl_tpu_torch.ops.cuda import decode_attention as da
from bigdl_tpu_torch.ops.cuda import prefill_attention as pa
from prefill_model import KINDS, SMS
from torch_threads import one_intra_op_thread  # noqa: F401

# the engine's B4 calls, (Sq, S, pos): a prompt's private cache is its
# bucket, S rows, for every chunk (serving/engine.py's _admission_step); a
# bucket of 128 is one 128-token call, a larger one takes 256-token chunks
# at 0, 256, .., S - 256
MAIN = [(128, 128, 0)] + [(256, s, p) for s in (256, 512, 1024, 2048)
                          for p in range(0, s, 256)]
GROUPS = [(32, 32), (32, 8)]         # Llama-2-7B, Mixtral-8x7B


# ---------------------------------------------------------------------------
# the planner and the cut


def _live(b, hkv, qt, nqt, nspan, sq, s, pos):
    return b * hkv * sum(len(pa.prefill_spans(t, qt, nspan, sq, s, pos))
                         for t in range(nqt))


def _most(b, hkv, qt, nqt, sq, s, pos):
    """The most live blocks any nspan gives, up to one an SM."""
    return min(SMS, max(_live(b, hkv, qt, nqt, n, sq, s, pos)
                        for n in range(1, pa.MAX_SPANS + 1)))


def test_block_geometry_is_the_kernels():
    """The planner's ROWS, KEY_TILE, MAX_SPANS and WHOLE_TILES are the
    kernel's kRows, kKT, kMaxSpans and kWholeTiles."""
    with open(os.path.join(_native.CSRC, "prefill_attention.cu")) as f:
        src = f.read()
    consts = {}
    # the namespace's constants (at the start of a line), in order
    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;]+);", src,
                                 re.M):
        consts[name] = eval(expr, {"__builtins__": {}}, dict(consts))
    assert (consts["kRows"], consts["kKT"], consts["kMaxSpans"],
            consts["kWholeTiles"]) == (pa.ROWS, pa.KEY_TILE, pa.MAX_SPANS,
                                       pa.WHOLE_TILES)


@pytest.mark.parametrize("known", [True, False])
@pytest.mark.parametrize("h,hkv", GROUPS)
@pytest.mark.parametrize("sq,s,pos", MAIN)
def test_plan_reaches_every_sm(sq, s, pos, h, hkv, known):
    """At each of the engine's calls the plan gives as many live blocks
    (those with keys) as any plan can, up to one on every SM, planned with
    the position or without it (the engine's position lives on the card);
    with the position, with no more blocks a tile than that needs. Where a
    span of the heaviest tile keeps more than WHOLE_TILES key tiles, that
    is every SM."""
    qt, nqt, nspan = pa.plan_prefill(1, h, hkv, sq, s, pos if known else None,
                                     SMS)
    assert qt * (h // hkv) == pa.ROWS and (nqt - 1) * qt < sq <= nqt * qt
    assert 1 <= nspan <= pa.MAX_SPANS
    most = _most(1, hkv, qt, nqt, sq, s, pos)
    assert _live(1, hkv, qt, nqt, nspan, sq, s, pos) >= most
    if min(pos + sq, s) > 2 * pa.WHOLE_TILES * pa.KEY_TILE:
        assert most == SMS
    if known and nspan > 1:
        assert _live(1, hkv, qt, nqt, nspan - 1, sq, s, pos) < most
    if not known:
        assert nspan == pa.plan_prefill(1, h, hkv, sq, s, s - sq, SMS)[2]


@pytest.mark.parametrize("nspan", range(1, pa.MAX_SPANS + 1))
@pytest.mark.parametrize("h,hkv", GROUPS)
@pytest.mark.parametrize("sq,s,pos", MAIN)
def test_plan_keeps_short_tiles_whole(sq, s, pos, h, hkv, nspan):
    """A query tile that sees 256 keys or fewer (every tile of a 128-token
    bucket or of a first 256-token chunk) is one span whatever nspan the
    plan gave: a second would cost more in q and merge than the SM it
    fills. A tile that sees more takes two or more where nspan allows, and
    no more than one a WHOLE_TILES key tiles.
    With the position known, a call whose tiles all stay whole is planned
    at one block a tile."""
    qt, nqt, _ = pa.plan_prefill(1, h, hkv, sq, s, pos, SMS)
    whole = pa.WHOLE_TILES * pa.KEY_TILE
    for t in range(nqt):
        nvis = min(pos + min((t + 1) * qt, sq), s)
        n = len(pa.prefill_spans(t, qt, nspan, sq, s, pos))
        if nvis <= whole or nspan == 1:
            assert n == 1
        else:       # whole tiles a span: the cut may leave the last empty
            assert 2 <= n <= min(nspan, -(-nvis // whole))
    if min(pos + sq, s) <= whole:
        assert pa.plan_prefill(1, h, hkv, sq, s, pos, SMS)[2] == 1


@pytest.mark.parametrize("b,h,hkv,sq,s", [(1, 32, 32, 256, 2048),
                                          (4, 32, 8, 256, 2048),
                                          (1, 8, 1, 128, 128)])
def test_plan_takes_the_most_live_blocks_it_can(b, h, hkv, sq, s):
    """Where no cut reaches every SM, or one already does at one span, the
    plan stops at the most live blocks the keys give."""
    qt, nqt, nspan = pa.plan_prefill(b, h, hkv, sq, s, 0, SMS)
    got = _live(b, hkv, qt, nqt, nspan, sq, s, 0)
    assert got >= _most(b, hkv, qt, nqt, sq, s, 0)
    assert all(_live(b, hkv, qt, nqt, n, sq, s, 0) < got
               for n in range(1, nspan))


@pytest.mark.parametrize("nspan", [1, 2, 3, pa.MAX_SPANS])
@pytest.mark.parametrize("h,hkv", GROUPS + [(12, 4), (16, 1)])
@pytest.mark.parametrize("sq,s,pos", MAIN + [(128, 384, 128), (256, 256, 3)])
def test_spans_cover_each_visible_pair_once(sq, s, pos, h, hkv, nspan):
    qt, nqt, _ = pa.plan_prefill(1, h, hkv, sq, s, pos, SMS)
    kt = pa.KEY_TILE
    for t in range(nqt):
        spans = pa.prefill_spans(t, qt, nspan, sq, s, pos)
        assert 1 <= len(spans) <= nspan
        last_q = min((t + 1) * qt, sq) - 1
        kend = min(pos + last_q + 1, s)      # keys the tile's last query sees
        covered = np.zeros(s, np.int64)
        for j0, j1 in spans:
            assert j0 % kt == 0 and j0 < j1 <= kend
            staged = j0 + -(-(j1 - j0) // kt) * kt
            # every staged tile holds keys of the span, inside the cache
            assert staged - kt < j1 and staged <= -(-kend // kt) * kt <= s
            covered[j0:j1] += 1
        assert spans[0][0] == 0 and spans[-1][1] == kend
        for i in range(t * qt, last_q + 1):
            vis = min(pos + i + 1, s)
            assert (covered[:vis] == 1).all()


def _block_order(b, hkv, nqt, nspan, whole=False):
    """(query tile, span, kv head, slot) of each block in launch order, as
    the kernel decodes blockIdx.x: the last query tile (the most keys)
    first, a tile's spans side by side (one cluster). Where every tile of
    the call is one span (`whole`), block i takes unit i and a block past
    the units is None (it leaves)."""
    order = []
    for i in range(nqt * nspan * hkv * b):
        unit = i if whole else i // nspan
        if unit >= nqt * hkv * b:
            order.append(None)
            continue
        order.append((nqt - 1 - unit // (hkv * b), 0 if whole else i % nspan,
                      unit // b % hkv, unit % b))
    return order


def _whole(b_pos, sq, s):
    """The kernel's test: no slot's chunk sees more than WHOLE_TILES key
    tiles, so every query tile of the call is one span."""
    return max(min(p + sq, s) for p in b_pos) <= pa.WHOLE_TILES * pa.KEY_TILE


@pytest.mark.parametrize("h,hkv", GROUPS)
@pytest.mark.parametrize("sq,s,pos", [m for m in MAIN
                                      if _whole([m[2]], m[0], m[1])])
def test_a_first_chunk_takes_the_first_blocks(sq, s, pos, h, hkv):
    """A first chunk (every tile sees 256 keys or fewer) under the plan for
    its cache's last chunk: the first blocks take each (tile, kv head)
    once, one span each, heavy tiles first, and the blocks past them
    leave, so the live blocks are not paired with leaving ones."""
    qt, nqt, nspan = pa.plan_prefill(1, h, hkv, sq, s, None, SMS)
    order = _block_order(1, hkv, nqt, nspan, whole=True)
    units = nqt * hkv
    live = [u for u in order if u is not None]
    assert len(order) == units * nspan and order[:units] == live
    assert len(set(live)) == units and all(u[1] == 0 for u in live)
    assert [u[0] for u in live] == sorted((u[0] for u in live), reverse=True)
    assert all(len(pa.prefill_spans(t, qt, nspan, sq, s, pos)) == 1
               for t in range(nqt))


@pytest.mark.parametrize("b,h,hkv,sq,s,pos", [(1, 32, 32, 256, 256, 0),
                                              (1, 32, 8, 256, 2048, 256),
                                              (2, 8, 2, 128, 384, 128)])
def test_heavy_tiles_launch_first(b, h, hkv, sq, s, pos):
    qt, nqt, nspan = pa.plan_prefill(b, h, hkv, sq, s, pos, SMS)
    order = _block_order(b, hkv, nqt, nspan)
    assert len(set(order)) == len(order) == nqt * nspan * hkv * b
    keys = [min(pos + min((t + 1) * qt, sq), s) for t, _, _, _ in order]
    assert keys == sorted(keys, reverse=True)
    assert [t for t, _, _, _ in order] == sorted(
        (t for t, _, _, _ in order), reverse=True)


@pytest.mark.parametrize("b,h,hkv,sq,s,nspan", [(1, 32, 32, 256, 2048, 2),
                                                (1, 32, 8, 128, 128, 4),
                                                (2, 8, 2, 256, 512, 3)])
def test_a_tiles_spans_are_one_cluster(b, h, hkv, sq, s, nspan):
    """The nspan blocks of a query tile sit side by side in launch order,
    ranks 0 .. nspan - 1 (the cluster that merges them), and every (tile,
    kv head, slot) has one such group."""
    _, nqt, _ = pa.plan_prefill(b, h, hkv, sq, s, None, SMS)
    order = _block_order(b, hkv, nqt, nspan)
    units = set()
    for i in range(0, len(order), nspan):
        group = order[i:i + nspan]
        assert [sp for _, sp, _, _ in group] == list(range(nspan))
        assert len({(t, kh, bi) for t, _, kh, bi in group}) == 1
        units.add(group[0][:1] + group[0][2:])
    assert len(units) == nqt * hkv * b


# ---------------------------------------------------------------------------
# the wrapper with the native library stood in for


class _Lib:
    """The native library: launches return 0; every call is recorded."""

    def __init__(self):
        self.calls = []

    def kernel(self, lib, sym=None):
        def fn(*args):
            self.calls.append((lib, sym, args))
            return 0
        return fn


@pytest.fixture
def lib(monkeypatch):
    rec = _Lib()
    monkeypatch.setattr(_native, "kernel", rec.kernel)
    monkeypatch.setattr(pa, "_sm_count", lambda device: SMS)
    monkeypatch.setattr(pa, "_stream", lambda device: 0)
    return rec


def _operands(b, sq, h, hkv, hd, s, kind):
    """q and zero K/V codes (and scales) of `kind`: the stand-in library
    reads none of them."""
    q = torch.zeros((b, sq, h, hd), dtype=torch.bfloat16)
    dt = {"bf16": torch.bfloat16, "fp8_e5m2": torch.float8_e5m2,
          "int8": torch.int8, "int4": torch.uint8}[kind]
    width = hd // 2 if kind == "int4" else hd
    kc, vc = (torch.zeros((b, s, hkv, width), dtype=dt) for _ in range(2))
    ks = vs = None
    if kind in ("int8", "int4"):
        ks, vs = (torch.ones((b, s, hkv)) for _ in range(2))
    return q, kc, vc, ks, vs


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("b,h,hkv,hd,sq,s", [(1, 32, 32, 128, 256, 2048),
                                             (1, 32, 8, 128, 256, 2048),
                                             (1, 32, 32, 128, 128, 128),
                                             (2, 8, 2, 64, 128, 384)])
def test_b4_launches_once_with_the_plan(lib, kind, b, h, hkv, hd, sq, s):
    q, kc, vc, ks, vs = _operands(b, sq, h, hkv, hd, s, kind)
    pos = torch.zeros((b,), dtype=torch.int32)
    name = da.counter("prefill_attention", kind)
    before = LAUNCHES[name]
    out = pa._launch(q, kc, vc, pos, hd ** -0.5, ks, vs)
    assert LAUNCHES[name] == before + 1
    assert out.shape == q.shape and out.dtype == torch.bfloat16
    (call,) = lib.calls
    assert call[0] == "prefill_attention" and call[1] is None
    args = call[2]
    # q k v ks vs pos out | B Sq S H Hkv hd kind nspan | scale stream
    assert len(args) == 17
    _, _, nspan = pa.plan_prefill(b, h, hkv, sq, s, None, SMS)
    assert args[7:15] == (b, sq, s, h, hkv, hd,
                          da.KV_KINDS[kc.dtype][1], nspan)
    assert args[:3] == (q.data_ptr(), kc.data_ptr(), vc.data_ptr())
    assert args[6] == out.data_ptr() and args[5] == pos.data_ptr()
    assert (args[3] is None) == (ks is None) and (args[4] is None) == (
        vs is None)


def test_b4_sweep_overrides_the_plan(lib):
    q, kc, vc, ks, vs = _operands(1, 256, 32, 8, 128, 2048, "int4")
    pa._launch(q, kc, vc, torch.zeros(1, dtype=torch.int32), 0.1, ks, vs,
               nspan=3)
    assert len(lib.calls) == 1 and lib.calls[0][2][14] == 3


def test_one_kernel_a_call_and_no_dequantized_tile():
    with open(os.path.join(_native.CSRC, "prefill_attention.cu")) as f:
        src = f.read()
    assert src.count("__global__") == 1
    assert src.count("cudaLaunchKernelEx") == 1 and "<<<" not in src
    # the spans of a tile merge in one cluster, not through global memory
    assert "cudaLaunchAttributeClusterDimension" in src
    assert "mapa.shared::cluster" in src and "barrier.cluster" in src
    assert "atomicAdd" not in src and "tickets" not in src
    for piece in ("tma_2d", "mbar_wait", "mma_bf16", "k_frag<KIND>",
                  "v_pair<KIND>", "kslot_dim<KIND>"):
        assert piece in src, piece
    assert "dequant_tile" not in src and "__syncthreads();\n        const" \
        not in src
