"""bigdl_tpu_torch's paged KV path against the JAX package: page pool and
radix tree, paged ops, paged attention (B5's plain version), the paged
forward and the paged engine.

- ``PagePool`` / ``RadixCache``: random operation sequences (hypothesis)
  give identical results, page ids, refcounts, free lists and snapshots
  in both copies.
- Paged ops write and read the same bytes as the JAX functions.
- ``plain_paged_attention`` agrees with ``sdp_attention_paged(
  backend="xla")`` and the Pallas kernel in interpret mode within 2e-2,
  the slab attention tests' tolerance.
- ``forward_paged`` logits match the JAX ``forward_paged`` within 3e-2
  and equal the port's slab ``forward`` bit for bit.
- The paged engine gives the JAX paged engine's greedy and seeded streams
  and the slab engine's, with and without prefix sharing (3 radix hits,
  96 tokens), releases pages on finish and rejects bad geometry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from bigdl_tpu.models import llama as jllama
from bigdl_tpu.ops import paged as jpaged
from bigdl_tpu.ops.attention import sdp_attention_paged as jax_sdp_paged
from bigdl_tpu.ops.pallas.paged_decode_attention import \
    paged_decode_attention_pallas
from bigdl_tpu.serving import pagepool as jpool
from bigdl_tpu.serving.engine import EngineConfig as JaxEngineConfig
from bigdl_tpu.serving.engine import LLMEngine as JaxLLMEngine
from bigdl_tpu.serving.engine import SamplingParams as JaxSamplingParams
from bigdl_tpu.utils.testing import TINY_LLAMA as JAX_TINY
from bigdl_tpu.utils.testing import tiny_random_model
from bigdl_tpu_torch import bridge
from bigdl_tpu_torch.models import llama as tllama
from bigdl_tpu_torch.ops import attention as tatt
from bigdl_tpu_torch.ops import paged as tpaged
from bigdl_tpu_torch.ops.cuda import paged_decode_attention as tb5
from bigdl_tpu_torch.serving import pagepool as tpool
from bigdl_tpu_torch.serving.engine import (EngineConfig, LLMEngine,
                                            SamplingParams)
from bigdl_tpu_torch.utils.testing import TINY_LLAMA, SyntheticCausalLM
from torch_threads import one_intra_op_thread  # noqa: F401


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.contiguous().view(torch.int16).numpy()


def _jbits(a) -> np.ndarray:
    return np.asarray(a).view(np.int16)


# ---------------------------------------------------------------------------
# PagePool / RadixCache: the same operations on both copies

PS = 4
BASES = [list(range(100, 140)),
         list(range(100, 108)) + list(range(200, 232)),
         list(range(300, 340))]

_op = st.one_of(
    st.tuples(st.just("alloc"), st.integers(0, 5)),
    st.tuples(st.just("incref"), st.integers(0, 15)),
    st.tuples(st.just("decref"), st.integers(0, 15)),
    st.tuples(st.just("insert"), st.integers(0, 2), st.integers(1, 30)),
    st.tuples(st.just("match"), st.integers(0, 2), st.integers(1, 30)),
    st.tuples(st.just("evict"), st.integers(0, 6)),
    st.tuples(st.just("drop"), st.integers(0, 2), st.integers(1, 30)),
    st.tuples(st.just("clear")),
)


def _apply(pool, radix, held, op):
    """One operation; returns its result or the exception it raised."""
    name = op[0]
    try:
        if name == "alloc":
            got = pool.alloc(op[1])
            held.extend(got or [])
            return got
        if name == "incref":
            return pool.incref(op[1] % pool.num_pages)
        if name == "decref":
            return pool.decref(op[1] % pool.num_pages)
        toks = BASES[op[1]][:op[2]] if len(op) > 2 else None
        if name == "insert":
            need = -(-len(toks) // PS)
            if len(held) < need:
                return "skip"
            return radix.insert(toks, held[-need:])
        if name == "match":
            return radix.match(toks)
        if name == "evict":
            return radix.evict(op[1])
        if name == "drop":
            return radix.drop(toks)
        return radix.clear()
    except (RuntimeError, AssertionError) as e:
        return (type(e).__name__, str(e))


@settings(max_examples=60, deadline=None)
@given(st.lists(_op, max_size=40))
def test_pool_and_radix_match_jax_copy(ops):
    jp, tp = jpool.PagePool(12, PS), tpool.PagePool(12, PS)
    jr, tr = jpool.RadixCache(jp), tpool.RadixCache(tp)
    jh, th = [], []
    for op in ops:
        assert _apply(tp, tr, th, op) == _apply(jp, jr, jh, op), op
        assert tp._ref == jp._ref and tp._free == jp._free
        assert tp.exhausted_total == jp.exhausted_total
        assert (tp.num_used, tp.num_free, tp.num_shared) == \
            (jp.num_used, jp.num_free, jp.num_shared)
        assert tr.snapshot() == jr.snapshot()


# ---------------------------------------------------------------------------
# paged ops, byte for byte


def _arena_pair(rng, layers, p, ps, hkv, hd):
    base = rng.standard_normal((layers, p, ps, hkv, hd)).astype(np.float32)
    return (jnp.asarray(base, jnp.bfloat16),
            torch.from_numpy(base).to(torch.bfloat16))


def test_paged_update_and_reads_match_jax():
    rng = np.random.default_rng(1)
    layers, p, ps, hkv, hd, np_ = 2, 9, 16, 2, 8, 4
    jk, tk = _arena_pair(rng, layers, p, ps, hkv, hd)
    jv, tv = _arena_pair(rng, layers, p, ps, hkv, hd)
    bt = np.zeros((3, np_), np.int32)
    bt[0] = [3, 7, 1, 0]            # two pages unallocated
    bt[1] = [2, 8, 5, 6]
    # row 2 idle (all null), pos past the table: writes go to page 0
    pos = np.array([30, 61, 70], np.int32)
    s_new = 3                        # row 0 crosses from table entry 1 to 2
    new_k = rng.standard_normal((3, s_new, hkv, hd)).astype(np.float32)
    new_v = rng.standard_normal((3, s_new, hkv, hd)).astype(np.float32)
    jk2, jv2 = jpaged.paged_update_layer(
        jk, jv, 1, jnp.asarray(new_k), jnp.asarray(new_v), jnp.asarray(pos),
        jnp.asarray(bt))
    tpaged.paged_update_layer(tk, tv, 1, torch.from_numpy(new_k),
                              torch.from_numpy(new_v), torch.from_numpy(pos),
                              torch.from_numpy(bt))
    # (only row 2 writes the null page here, so its bytes are defined too)
    np.testing.assert_array_equal(_bits(tk), _jbits(jk2))
    np.testing.assert_array_equal(_bits(tv), _jbits(jv2))
    rk, rv = tpaged.paged_read_layer(tk, tv, 1, torch.from_numpy(bt[:2]))
    jrk, jrv = jpaged.paged_read_layer(jk2, jv2, 1, jnp.asarray(bt[:2]))
    np.testing.assert_array_equal(_bits(rk), _jbits(jrk))
    np.testing.assert_array_equal(_bits(rv), _jbits(jrv))
    g = tpaged._gather_dense(tk[0], torch.from_numpy(bt))
    np.testing.assert_array_equal(
        _bits(g), _jbits(jpaged._gather_dense(jk2[0], jnp.asarray(bt))))


def test_cow_copy_and_gather_pages_match_jax():
    rng = np.random.default_rng(2)
    jk, tk = _arena_pair(rng, 2, 6, 16, 2, 8)
    jv, tv = _arena_pair(rng, 2, 6, 16, 2, 8)
    src = tk.clone()
    # a pair list that reads a page another pair writes (4 -> 1, 1 -> 5)
    # sees pre-copy bytes; (0, 0) pads
    srcs, dsts = np.array([4, 1, 0], np.int32), np.array([1, 5, 0], np.int32)
    jk2, jv2 = jpaged.cow_copy_pages(jk, jv, jnp.asarray(srcs),
                                     jnp.asarray(dsts))
    tpaged.cow_copy_pages(tk, tv, torch.from_numpy(srcs),
                          torch.from_numpy(dsts))
    np.testing.assert_array_equal(_bits(tk), _jbits(jk2))
    np.testing.assert_array_equal(_bits(tv), _jbits(jv2))
    assert torch.equal(tk[:, 5], src[:, 1]) and torch.equal(tk[:, 4],
                                                            src[:, 4])
    pages = np.array([3, 1, 4], np.int32)
    gk, gv = tpaged.gather_pages_dense(tk, tv, torch.from_numpy(pages))
    jgk, jgv = jpaged.gather_pages_dense(jk2, jv2, jnp.asarray(pages))
    assert gk.shape == (2, 1, 48, 2, 8)
    np.testing.assert_array_equal(_bits(gk), _jbits(jgk))
    np.testing.assert_array_equal(_bits(gv), _jbits(jgv))
    sizes = tpaged.paged_cache_bytes(tpaged.init_paged_cache(
        2, 6, 16, 2, 8, batch=3, device="cpu"))
    assert sizes == tpaged.paged_cache_nbytes(2, 6, 16, 2, 8) == \
        jpaged.paged_cache_nbytes(2, 6, 16, 2, 8)
    with pytest.raises(NotImplementedError):
        tpaged.init_paged_cache(1, 2, 16, 1, 8, 1, dtype=torch.float16,
                                device="cpu")


# ---------------------------------------------------------------------------
# paged decode attention (B5's plain version)


@pytest.mark.parametrize("h,hkv", [(8, 4), (8, 8)])
def test_plain_paged_attention_matches_xla_and_pallas_interpret(h, hkv):
    rng = np.random.default_rng(h + hkv)
    b, hd, ps, np_, p = 2, 64, 128, 2, 5
    q = rng.standard_normal((b, 1, h, hd)).astype(np.float32)
    ak = rng.standard_normal((p, ps, hkv, hd)).astype(np.float32)
    av = rng.standard_normal((p, ps, hkv, hd)).astype(np.float32)
    bt = np.stack([rng.permutation(np.arange(1, p))[:np_],
                   np.zeros(np_, np.int64)]).astype(np.int32)
    pos = np.array([200, np_ * ps + 9], np.int32)   # row 1 idle, past NP*ps
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, ak, av))
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, ak, av))
    tbt, tpos = torch.from_numpy(bt), torch.from_numpy(pos)
    scale = hd ** -0.5
    got = tb5.plain_paged_attention(tq, tk, tv, tbt, tpos, scale).float()
    assert got.shape == (b, 1, h, hd)
    xla = np.asarray(jax_sdp_paged(jq, jk, jv, jnp.asarray(bt),
                                   jnp.asarray(pos), backend="xla"),
                     np.float32)
    pal = np.asarray(paged_decode_attention_pallas(
        jq, jk, jv, jnp.asarray(bt), jnp.asarray(pos), scale,
        interpret=True), np.float32)
    np.testing.assert_allclose(got.numpy(), xla, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(got.numpy(), pal, rtol=2e-2, atol=2e-2)
    # the gate sends this geometry to B5, whose CPU path is the plain one
    assert tb5.paged_decode_attention_supported(tq, tk)
    assert torch.equal(tatt.sdp_attention_paged(tq, tk, tv, tbt, tpos),
                       tb5.paged_decode_attention(tq, tk, tv, tbt, tpos,
                                                  scale))


def test_paged_gate_and_fallback():
    q1 = torch.zeros(2, 1, 8, 64, dtype=torch.bfloat16)
    arena = torch.zeros(3, 128, 4, 64, dtype=torch.bfloat16)
    assert tb5.paged_decode_attention_supported(q1, arena)
    assert not tb5.paged_decode_attention_supported(
        torch.zeros(2, 4, 8, 64), arena)                     # Sq > 1
    assert not tb5.paged_attention_geometry_ok(
        q1, torch.zeros(3, 16, 4, 64, dtype=torch.bfloat16))  # ps % 128
    assert not tb5.paged_attention_geometry_ok(q1, arena.float())
    assert not tb5.paged_attention_geometry_ok(
        torch.zeros(2, 1, 8, 8), torch.zeros(3, 128, 4, 8,
                                             dtype=torch.bfloat16))
    # outside the gate: dense gather, then the slab dispatch
    rng = np.random.default_rng(0)
    ak = torch.from_numpy(rng.standard_normal((5, 16, 2, 8)).astype(
        np.float32)).to(torch.bfloat16)
    q = torch.from_numpy(rng.standard_normal((2, 1, 4, 8)).astype(
        np.float32)).to(torch.bfloat16)
    bt = torch.tensor([[1, 3], [4, 0]], dtype=torch.int32)
    pos = torch.tensor([20, 5], dtype=torch.int32)
    want = tatt.sdp_attention(q, tpaged._gather_dense(ak, bt),
                              tpaged._gather_dense(ak, bt), pos)
    assert torch.equal(tatt.sdp_attention_paged(q, ak, ak, bt, pos), want)


def test_meta_tensor_never_takes_the_plain_path():
    q = torch.zeros(1, 1, 8, 64, dtype=torch.bfloat16, device="meta")
    arena = torch.zeros(2, 128, 4, 64, dtype=torch.bfloat16, device="meta")
    bt = torch.zeros(1, 1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tb5.paged_decode_attention(q, arena, arena, bt, 0, 0.125)


# ---------------------------------------------------------------------------
# forward_paged


@pytest.fixture(scope="module")
def tiny_models():
    jm = tiny_random_model(seed=0)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jm.params),
                                  device="cpu")
    return jm, SyntheticCausalLM(tp, TINY_LLAMA)


def test_forward_paged_matches_jax_and_equals_slab(tiny_models):
    jm, tm = tiny_models
    rng = np.random.default_rng(4)
    b, ps, np_, p, max_seq = 2, 16, 4, 9, 64
    # the rows own disjoint pages, in a random order
    bt = rng.permutation(np.arange(1, p)).reshape(b, np_).astype(np.int32)
    jc = jllama.new_paged_cache(JAX_TINY, p, ps, b)
    tc = tllama.new_paged_cache(TINY_LLAMA, p, ps, b, device="cpu")
    sc = tllama.new_cache(TINY_LLAMA, b, max_seq, per_slot_pos=True,
                          device="cpu")
    tbt = torch.from_numpy(bt)
    for n in (20, 1, 1):
        toks = rng.integers(0, 256, (b, n)).astype(np.int32)
        jl, jc = jllama.forward_paged(jm.params, JAX_TINY, jnp.asarray(toks),
                                      jc, jnp.asarray(bt))
        tl, tc = tllama.forward_paged(tm.params, TINY_LLAMA,
                                      torch.from_numpy(toks), tc, tbt)
        sl, sc = tllama.forward(tm.params, TINY_LLAMA,
                                torch.from_numpy(toks), sc)
        assert tl.shape == (b, n, 256)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=3e-2,
                                   atol=3e-2)
        assert torch.equal(tl, sl)
    assert tc.pos.tolist() == sc.pos.tolist() == [22, 22]
    last, _ = tllama.forward_paged(tm.params, TINY_LLAMA,
                                   torch.zeros(b, 1, dtype=torch.int64),
                                   tc, tbt, last_only=True)
    assert last.shape == (b, 1, 256)


# ---------------------------------------------------------------------------
# engine


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


def _jax_engine(jm, **kw):
    return JaxLLMEngine(jm, JaxEngineConfig(prefix_cache_entries=0,
                                            **{**_ECFG, **kw}))


def _engine(tm, **kw):
    return LLMEngine(tm, EngineConfig(**{**_ECFG, **kw}), device="cpu")


def test_paged_engine_matches_jax_paged_greedy_and_sampled(tiny_models):
    jm, tm = tiny_models
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 250, 13).tolist() for _ in range(4)]
    kws = [dict(max_tokens=8) if i % 2 == 0 else
           dict(max_tokens=8, temperature=0.8, top_k=8, seed=i)
           for i in range(4)]
    want = _drive(_jax_engine(jm, kv_page_size=16, prefix_sharing="off"),
                  prompts, [JaxSamplingParams(**k) for k in kws])
    sps = [SamplingParams(**k) for k in kws]
    paged = _drive(_engine(tm, kv_page_size=16, prefix_sharing="off"),
                   prompts, sps)
    assert paged == want
    assert _drive(_engine(tm), prompts, sps) == paged


def test_prefix_sharing_matches_jax_and_hits(tiny_models):
    jm, tm = tiny_models
    pre = list(range(1, 33))                   # 2 full pages at ps=16
    prompts = [pre + [100 + i, 200 + i] for i in range(4)]
    kws = [dict(max_tokens=8)] * 3 + [dict(max_tokens=8, temperature=0.9,
                                           seed=5)]
    jeng = _jax_engine(jm, kv_page_size=16, prefix_sharing="on")
    want = _drive(jeng, prompts, [JaxSamplingParams(**k) for k in kws])
    eng = _engine(tm, kv_page_size=16, prefix_sharing="on")
    got = _drive(eng, prompts, [SamplingParams(**k) for k in kws])
    assert got == want
    assert _drive(_engine(tm), prompts,
                  [SamplingParams(**k) for k in kws]) == got
    snap = eng._paged_snapshot()
    assert snap["radix"]["hits"] == 3
    assert snap["radix"]["hit_tokens"] == 3 * 32
    assert snap["pool_exhausted_total"] == 0
    # every prompt's partial tail page was shared with the tree until its
    # first append: one copy-on-write per request
    assert snap["cow_pages_total"] == 4
    jsnap = jeng._paged_snapshot()
    for k in ("pages_used", "pages_shared", "pages_free", "radix"):
        assert snap[k] == jsnap[k], k
    assert eng._bt_np.tolist() == jeng._bt_np.tolist()


def test_finish_releases_pages_and_reset_clears_radix(tiny_models):
    _, tm = tiny_models
    eng = _engine(tm, kv_page_size=16, prefix_sharing="on")
    _drive(eng, [list(range(40, 60))], [SamplingParams(max_tokens=4)])
    # the slot released its row; only radix nodes still hold pages
    assert eng.pool.num_used == eng.radix.num_nodes > 0
    assert not eng._bt_np.any()
    eng.reset_prefix_cache()
    assert eng.radix.num_nodes == 0
    assert eng.pool.num_used == 0
    assert eng.pool.num_free == eng.pool.num_pages - 1
    off = _engine(tm, kv_page_size=16, prefix_sharing="off")
    _drive(off, [list(range(40, 60))], [SamplingParams(max_tokens=4)])
    assert off.radix is None and off.pool.num_used == 0


def test_pool_exhaustion_requeues_until_pages_free(tiny_models):
    """A 3-page arena fits one 2-page sequence at a time: the second
    request waits in the queue and runs after the first finishes."""
    _, tm = tiny_models
    eng = _engine(tm, kv_page_size=16, kv_pages=3, prefix_sharing="off")
    prompts = [list(range(1, 21)), list(range(30, 50))]
    out = _drive(eng, prompts, [SamplingParams(max_tokens=4)] * 2)
    assert all(len(t) == 4 for t in out.values())
    assert eng.pool.exhausted_total > 0 and eng.pool.num_used == 0


def test_engine_rejects_bad_paged_geometry(tiny_models, monkeypatch):
    _, tm = tiny_models
    with pytest.raises(ValueError, match="power of two"):
        _engine(tm, kv_page_size=48)
    with pytest.raises(ValueError, match="multiple"):
        _engine(tm, kv_page_size=32, max_seq=72)
    with pytest.raises(ValueError):
        _engine(tm, kv_page_size=16, kv_pages=1)
    with pytest.raises(ValueError):
        _engine(tm, kv_page_size=16, prefix_sharing="never")
    monkeypatch.setenv("BIGDL_TPU_TORCH_KV_PAGE_SIZE", "16")
    monkeypatch.setenv("BIGDL_TPU_TORCH_PREFIX_SHARING", "off")
    eng = _engine(tm)
    assert eng._paged and eng._page_size == 16 and eng.radix is None
    assert eng._num_pages == 4 * 4 + 1
    assert not _engine(tm, kv_page_size=0)._paged
    monkeypatch.setenv("BIGDL_TPU_TORCH_KV_PAGE_SIZE", "24")
    with pytest.raises(ValueError):
        _engine(tm)
