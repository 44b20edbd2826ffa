"""The port's serving engine features against the JAX engine: prompt
validation, the host sampler, penalties, logprobs, n / best_of, the
logits health check, aborts and preemption.

Both engines serve the same bytes: the JAX package's random sym_int4
tiny llama (2 layers, hidden 128, vocab 256; ``test_torch_engine.py``'s
GEOM) carried across by ``bridge.params_from_numpy``. The host sampler
(``_sample_host``) is held bit for bit against the JAX engine's on the
same float64 logits rows and counts. Engine streams are held token for
token; the two forwards differ by about a bf16 ulp, so the prompts are
rows on which no step's two best logits tie within that (PROMPTS: the
first rows of ``default_rng(5)`` at lengths 6, 11 and 14; with the rows of
``default_rng(3)`` or ``default_rng(4)`` the engines split on a tie in
several cases below), and logprob values agree within the
forward's logit tolerance, 3e-2. Cases ported from the JAX package's
``tests/test_serving_sampling.py`` run on the port alone where they state
a property of one engine.
"""

import dataclasses
import sys
import threading
import time

import jax
import numpy as np
import pytest

from bigdl_tpu.models import llama as jllama
from bigdl_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from bigdl_tpu.observability.metrics import MetricsRegistry as JaxRegistry
from bigdl_tpu.serving import engine as jengine
from bigdl_tpu.utils.testing import SyntheticCausalLM as JaxSyntheticLM
from bigdl_tpu.utils.testing import random_llama_params as jax_random_params
from bigdl_tpu_torch import bridge
from bigdl_tpu_torch.models.llama import LlamaConfig
from bigdl_tpu_torch.observability.metrics import MetricsRegistry
from bigdl_tpu_torch.serving import engine as tengine
from bigdl_tpu_torch.utils.testing import SyntheticCausalLM
from torch_threads import one_intra_op_thread  # noqa: F401

GEOM = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=2,
            num_key_value_heads=2, max_position_embeddings=256)
V = GEOM["vocab_size"]
MAX_SEQ = 128
LOGIT_TOL = 3e-2            # the forwards' logit tolerance


def _prompts():
    rng = np.random.default_rng(5)
    return [rng.integers(0, V, n).tolist() for n in (6, 11, 14)]


PROMPTS = _prompts()


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JaxLlamaConfig(**GEOM), LlamaConfig(**GEOM)
    jp = jllama.merge_projections(
        jax_random_params(jcfg, "sym_int4", seed=0), jcfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp),
                                  device="cpu")
    return JaxSyntheticLM(jp, jcfg), SyntheticCausalLM(tp, tcfg)


def _jax_engine(models, **kw):
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq", MAX_SEQ)
    return jengine.LLMEngine(models[0], jengine.EngineConfig(**kw))


def _port_engine(models, **kw):
    """A port engine on the CPU with a registry of its own."""
    kw.setdefault("max_batch", 4)
    kw.setdefault("max_seq", MAX_SEQ)
    return tengine.LLMEngine(models[1], tengine.EngineConfig(**kw),
                             device="cpu", registry=MetricsRegistry())


@pytest.fixture(scope="module")
def jeng(models):
    """One JAX engine for the stream comparisons (its jits compile once)."""
    return _jax_engine(models)


def _params(pkg, **kw):
    return (jengine if pkg == "jax" else tengine).SamplingParams(**kw)


def drive(eng, requests, steps=600):
    """Add (rid, prompt, params) requests, step until all finish; returns
    {rid: {index: tokens}}, {rid: {index: logprob entries}}, {rid:
    {index: finish reason}}."""
    for rid, prompt, sp in requests:
        eng.add_request(rid, prompt, sp)
    toks = {r: {} for r, _, _ in requests}
    lps = {r: {} for r, _, _ in requests}
    reasons = {r: {} for r, _, _ in requests}
    done = set()
    for _ in range(steps):
        eng.step()
        for rid in toks:
            for o in eng.get_outputs(rid):
                toks[rid].setdefault(o.index, []).extend(o.new_token_ids)
                if o.logprobs:
                    lps[rid].setdefault(o.index, []).extend(o.logprobs)
                if o.finish_reason is not None:
                    reasons[rid].setdefault(o.index, o.finish_reason)
                if o.finished:
                    done.add(rid)
        if len(done) == len(toks):
            return toks, lps, reasons
    raise AssertionError(f"requests never finished: {set(toks) - done}")


def both(models, jeng, kws, **ekw):
    """The same requests through the JAX engine and the port's."""
    out = []
    for pkg in ("jax", "port"):
        eng = (jeng if pkg == "jax" and not ekw else
               _jax_engine(models, **ekw) if pkg == "jax" else
               _port_engine(models, **ekw))
        reqs = [(f"{pkg}{i}", p, _params(pkg, **kw))
                for i, (p, kw) in enumerate(kws)]
        toks, lps, reasons = drive(eng, reqs)
        out.append(([toks[r] for r, _, _ in reqs],
                    [lps[r] for r, _, _ in reqs],
                    [reasons[r] for r, _, _ in reqs]))
        assert not eng.has_unfinished()
    return out


# -- C5: prompt and parameter validation -----------------------------------


@pytest.mark.parametrize("prompt,ok", [
    ([1, 2.5], False), ([1, "3"], False), ([-1], False), ([V], False),
    ([True, 2], True), ([np.int64(7), 3], True)])
def test_prompt_ids_validated_as_the_jax_engine_does(models, jeng, prompt,
                                                     ok):
    """C5: a float or string id is refused (an HTTP 400), never rounded
    or parsed into another prompt; bool and numpy ints pass, and both
    engines then serve the request."""
    teng = _port_engine(models)
    for pkg, eng in (("jax", jeng), ("port", teng)):
        sp = _params(pkg, max_tokens=2)
        if not ok:
            with pytest.raises(ValueError, match=r"ints in \[0, 256\)"):
                eng.add_request(f"c5-{pkg}", prompt, sp)
            continue
        toks, _, reasons = drive(eng, [(f"c5-{pkg}", prompt, sp)])
        assert len(toks[f"c5-{pkg}"][0]) == 2
        assert reasons[f"c5-{pkg}"] == {0: "length"}
    assert not teng.has_unfinished() and not jeng.has_unfinished()


@pytest.mark.parametrize("kw,match", [
    (dict(logprobs=V), "logprobs"), (dict(logprobs=-1), "logprobs"),
    (dict(n=0), "n must"), (dict(max_tokens=0), "max_tokens"),
    (dict(n=3, best_of=2), "best_of")])
def test_sampling_params_validated_as_the_jax_engine_does(models, jeng, kw,
                                                          match):
    teng = _port_engine(models)
    msgs = []
    for pkg, eng in (("jax", jeng), ("port", teng)):
        with pytest.raises(ValueError, match=match) as e:
            eng.add_request(f"bad-{pkg}", [1, 2, 3], _params(pkg, **kw))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    assert not teng.has_unfinished()


# -- the host sampler, bit for bit -----------------------------------------


HOST_CASES = {
    "greedy-logprobs0": dict(logprobs=0),
    "greedy-logprobs5": dict(logprobs=5),
    "greedy-repetition": dict(repetition_penalty=1.8),
    "greedy-presence-frequency": dict(presence_penalty=0.7,
                                      frequency_penalty=0.4, logprobs=2),
    "seeded-top-k": dict(temperature=0.8, top_k=12, seed=5, logprobs=3),
    "seeded-top-p": dict(temperature=1.1, top_p=0.6, seed=6,
                         repetition_penalty=1.3),
    "seeded-all": dict(temperature=0.7, top_k=40, top_p=0.9, seed=9,
                       repetition_penalty=1.2, presence_penalty=0.3,
                       frequency_penalty=0.2, logprobs=4),
}


@pytest.mark.parametrize("offset", [0, 3])
@pytest.mark.parametrize("case", sorted(HOST_CASES))
def test_host_sampler_equals_jax_bit_for_bit(models, jeng, case, offset):
    """_sample_host on the same float64 logits rows, over six steps from
    the same slot state: token, logprob, top list, cum_logprob and the
    penalty counts are equal exactly. offset > 0 is a preempt-resume
    (the prompt's tail is earlier output, the seeded stream keyed by the
    absolute position)."""
    teng = _port_engine(models)
    kw = HOST_CASES[case]
    prompt = PROMPTS[1] + PROMPTS[0][:offset]
    rng = np.random.default_rng(sum(map(ord, case)) + offset)
    slots = []
    for pkg, eng, mod in (("jax", jeng, jengine), ("port", teng, tengine)):
        s = mod._Slot()
        s.req = mod.Request(f"host-{pkg}", list(prompt),
                            _params(pkg, **kw), generated_offset=offset,
                            resumed_cum_logprob=-1.5 if offset else 0.0)
        eng._setup_slot_sampler(s)
        s.generated = []
        slots.append((eng, s))
    for _ in range(6):
        # rows with repeats and near-ties, as penalties and cuts meet them
        row = rng.standard_normal(V) * 2.0
        row[rng.integers(0, V, 8)] = row.max()
        got = [eng._sample_host(row.astype(np.float32), s)
               for eng, s in slots]
        (jt, jlp), (tt, tlp) = got
        assert tt == jt
        if jlp is None:
            assert tlp is None
        else:
            assert (tlp.token_id, tlp.logprob, tlp.top) == (
                jlp.token_id, jlp.logprob, jlp.top)
        for _, s in slots:
            s.generated.append(jt)
        js, ts = slots[0][1], slots[1][1]
        assert ts.cum_logprob == js.cum_logprob
        if js.counts is None:
            assert ts.counts is None
        else:
            np.testing.assert_array_equal(ts.counts, js.counts)
            np.testing.assert_array_equal(ts.counts_out, js.counts_out)


# -- engine streams against the JAX engine ---------------------------------


@pytest.mark.parametrize("kw", [
    dict(repetition_penalty=1.8), dict(presence_penalty=0.8),
    dict(frequency_penalty=0.6), dict(logprobs=3),
    dict(repetition_penalty=1.3, frequency_penalty=0.2, logprobs=2)],
    ids=["repetition", "presence", "frequency", "logprobs3", "mixed"])
def test_greedy_streams_with_penalties_and_logprobs_equal_jax(models, jeng,
                                                              kw):
    kws = [(p, dict(max_tokens=10, **kw)) for p in PROMPTS]
    (jt, jl, jr), (tt, tl, tr) = both(models, jeng, kws)
    assert tt == jt and tr == jr
    if "logprobs" not in kw:
        assert all(not d for d in tl)
        return
    for jd, td in zip(jl, tl):
        for je, te in zip(jd[0], td[0]):
            assert te.token_id == je.token_id
            assert abs(te.logprob - je.logprob) <= LOGIT_TOL
            assert len(te.top) == len(je.top) == kw["logprobs"]
            np.testing.assert_allclose([v for _, v in te.top],
                                       [v for _, v in je.top],
                                       atol=LOGIT_TOL)
            # greedy: the chosen token has the best logprob
            assert te.top[0][1] == pytest.approx(te.logprob, abs=1e-12)


def test_mixed_batch_streams_equal_jax(models, jeng):
    """Simple (device-sampled, greedy and seeded) and complex
    (host-sampled) slots in one batch: every stream equals the JAX
    engine's, and each seeded device stream is the one it draws alone."""
    kws = [(PROMPTS[0], dict(max_tokens=9)),
           (PROMPTS[1], dict(max_tokens=9, temperature=0.9, top_k=20,
                             seed=21)),
           (PROMPTS[2], dict(max_tokens=9, repetition_penalty=1.5,
                             logprobs=1)),
           (PROMPTS[0], dict(max_tokens=9, temperature=0.8, seed=4,
                             presence_penalty=0.4))]
    (jt, _, jr), (tt, _, tr) = both(models, jeng, kws)
    assert tt == jt and tr == jr
    alone, _, _ = drive(_port_engine(models),
                        [("alone", kws[1][0], _params("port", **kws[1][1]))])
    assert alone["alone"] == tt[1]


def test_n_and_best_of_equal_jax(models, jeng):
    """n=2 streams choices 0 and 1 (seed + i each); best_of=3, n=1 gives
    one choice, the JAX engine's winner."""
    kws = [(PROMPTS[1], dict(max_tokens=6, n=2, temperature=0.9, seed=11)),
           (PROMPTS[2], dict(max_tokens=6, n=1, best_of=3, temperature=1.2,
                             seed=7))]
    (jt, _, jr), (tt, _, tr) = both(models, jeng, kws)
    assert set(tt[0]) == {0, 1} and set(tt[1]) == {0}
    assert tt == jt and tr == jr
    assert tt[0][0] != tt[0][1]
    assert all(len(v) == 6 for d in tt for v in d.values())


# -- C6: the logits health check -------------------------------------------


@pytest.mark.parametrize("resident", ["on", "off"])
def test_nan_logits_row_is_quarantined_as_in_jax(models, resident,
                                                 monkeypatch):
    """Embedding row 7 set to NaN: the request whose prompt holds token 7
    finishes with "error" and the JAX engine's error dict after its first
    token (the prefill's; the first decode step's row is not finite), the
    quarantine counter counts it, and its neighbour's stream equals the
    JAX engine's; with the resident step on and off."""
    monkeypatch.setenv("BIGDL_TPU_TORCH_DECODE_RESIDENT", resident)
    jp = jax.tree.map(np.asarray, models[0].params)
    emb = np.array(jp["embed_tokens"])
    emb[7] = np.nan
    jp = dict(jp, embed_tokens=emb)
    tp = bridge.params_from_numpy(jp, device="cpu")
    jeng = jengine.LLMEngine(
        JaxSyntheticLM(jax.tree.map(jax.numpy.asarray, jp),
                       models[0].config),
        jengine.EngineConfig(max_batch=4, max_seq=MAX_SEQ),
        registry=JaxRegistry())           # keep the process-wide one clean
    reg = MetricsRegistry()
    teng = tengine.LLMEngine(
        SyntheticCausalLM(tp, models[1].config),
        tengine.EngineConfig(max_batch=4, max_seq=MAX_SEQ), device="cpu",
        registry=reg)
    got = {}
    for pkg, eng in (("jax", jeng), ("port", teng)):
        sp = _params(pkg, max_tokens=6)
        for rid, prompt in (("r0", [7, 1, 2, 3, 4]),
                            ("r1", list(range(9, 15)))):
            eng.add_request(rid, prompt, sp)
        outs = {"r0": [], "r1": []}
        while eng.has_unfinished():
            eng.step()
            for rid in outs:
                outs[rid] += [(o.new_token_ids, o.finished, o.finish_reason,
                               o.error) for o in eng.get_outputs(rid)]
        got[pkg] = outs
    assert got["port"] == got["jax"]
    r0, r1 = got["port"]["r0"], got["port"]["r1"]
    assert r0 == [([0], False, None, None),
                  ([], True, "error", {"reason": "nan_logits",
                                       "request_id": "r0"})]
    assert [t for o in r1 for t in o[0]] == [14, 14, 250, 143, 143, 143]
    assert r1[-1][2] == "length"
    summ = reg.summary()
    assert summ['bigdl_tpu_requests_quarantined_total{reason="nan_logits"}'] \
        == 1
    assert summ['bigdl_tpu_requests_quarantined_total{reason="crash_loop"}'] \
        == 0
    assert summ['bigdl_tpu_requests_finished_total{reason="error"}'] == 1
    assert (teng.resident_steps > 0) == (resident == "on")


# -- aborts ------------------------------------------------------------------


def _free_pages(eng):
    return eng.pool.num_free if eng.pool is not None else None


@pytest.mark.parametrize("where", ["queued", "admitting", "decoding",
                                   "fanout"])
@pytest.mark.parametrize("paged", [False, True], ids=["slab", "paged"])
def test_abort_finishes_and_frees(models, where, paged):
    """An abort finishes the request with reason "abort" wherever it is
    (queued, mid-admission, decoding, every child of a fan-out), frees
    its slots, and (paged, prefix sharing on) gives the pool back every
    page the request held: its reservation and its prompt's radix
    pages."""
    ekw = dict(max_batch=2, prefill_chunk=32)
    if paged:
        ekw.update(kv_page_size=16, prefix_sharing="on")
    eng = _port_engine(models, **ekw)
    if where == "queued":
        # both slots busy: the victim waits in the queue
        eng.add_request("a", PROMPTS[0], _params("port", max_tokens=40))
        eng.add_request("b", PROMPTS[1], _params("port", max_tokens=40))
        eng.add_request("v", PROMPTS[2], _params("port", max_tokens=4))
        for _ in range(4):
            eng.step()
        assert [r.request_id for r in eng.waiting] == ["v"]
    free0 = _free_pages(eng)
    if where == "admitting":
        eng.add_request("v", (PROMPTS[2] * 8)[:100],
                        _params("port", max_tokens=4))
        eng.step()                           # one 32-token chunk of four
        assert eng._admitting is not None
    elif where == "decoding":
        eng.add_request("v", PROMPTS[2], _params("port", max_tokens=40))
        for _ in range(3):
            eng.step()
        assert sum(s.active for s in eng.slots) == 1
    elif where == "fanout":
        eng.add_request("v", PROMPTS[2], _params(
            "port", max_tokens=40, n=2, temperature=0.8, seed=3))
        for _ in range(4):
            eng.step()
        assert sum(s.active for s in eng.slots) == 2
    if paged and where != "queued":
        assert _free_pages(eng) < free0
    outs = eng.get_outputs("v")
    eng.abort_request("v")
    eng.step()
    outs += eng.get_outputs("v")
    assert outs[-1].finished
    reasons = {o.index: o.finish_reason for o in outs
               if o.finish_reason is not None}
    assert reasons == ({0: "abort", 1: "abort"} if where == "fanout"
                       else {0: "abort"})
    assert eng._admitting is None and not eng.waiting
    assert not any(s.active and s.req.request_id.startswith("v")
                   for s in eng.slots)
    assert _free_pages(eng) == free0
    assert not eng._fanouts and not eng._children and not eng._abort
    while eng.has_unfinished():
        eng.step()


def test_threads_adding_and_aborting_lose_nothing(models):
    """Eight threads add and abort requests (and poll outputs) while
    one thread steps the engine, with a 10 us switch interval: every
    request ends in exactly one finished output, an aborted one with
    "abort" and none past it, the others with their max_tokens tokens."""
    eng = _port_engine(models, max_batch=2, preempt_after_steps=3)
    results, errors = {}, []
    stop = threading.Event()

    def stepper():
        try:
            while not stop.is_set():
                if not eng.step():
                    time.sleep(0.0005)
        except Exception as e:          # reported by the assert below
            errors.append(e)

    def client(c):
        try:
            for k in range(3):
                rid = f"t{c}.{k}"
                eng.add_request(rid, [c + 1, k + 1, 7],
                                _params("port", max_tokens=3))
                if (c + k) % 3 == 0:
                    eng.abort_request(rid)
                outs = []
                while not (outs and outs[-1].finished):
                    got = eng.get_outputs(rid)
                    outs += got
                    if not got:
                        time.sleep(0.0005)
                results[rid] = outs
        except Exception as e:
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        loop = threading.Thread(target=stepper)
        loop.start()
        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(8)]
        for t in clients:
            t.start()
        for t in clients:
            t.join(timeout=120)
        stop.set()
        loop.join(timeout=30)
    finally:
        sys.setswitchinterval(interval)
    assert not loop.is_alive() and not any(t.is_alive() for t in clients)
    assert not errors, errors
    assert len(results) == 24
    for rid, outs in results.items():
        c, k = map(int, rid[1:].split("."))
        assert [o.finished for o in outs].count(True) == 1
        toks = [t for o in outs for t in o.new_token_ids]
        if outs[-1].finish_reason == "length":
            assert len(toks) == 3
        else:
            assert outs[-1].finish_reason == "abort" and (c + k) % 3 == 0
    assert not eng.has_unfinished() and not eng._outputs


# -- preemption --------------------------------------------------------------


@pytest.fixture(scope="module")
def jeng_preempt(models):
    return _jax_engine(models, max_batch=1, preempt_after_steps=2)


@pytest.mark.parametrize("kw", [dict(), dict(temperature=1.0, seed=77),
                                dict(repetition_penalty=1.4, logprobs=1)],
                         ids=["greedy", "seeded", "host-sampled"])
def test_preemption_streams_equal_unpreempted_and_jax(models, jeng_preempt,
                                                      kw):
    """max_batch 1, preempt_after_steps 2: the long request is evicted
    by recompute while the short one runs; both finish, and the long
    stream equals an unpreempted run and the JAX engine's run with the
    same config (the seeded stream is keyed by the absolute position)."""
    reqs = [(PROMPTS[1], dict(max_tokens=16, **kw)),
            (PROMPTS[0], dict(max_tokens=3))]
    got = []
    for pkg, eng in (("jax", jeng_preempt),
                     ("port", _port_engine(models, max_batch=1,
                                           preempt_after_steps=2))):
        toks, _, reasons = drive(eng, [(f"{pkg}-{i}", p, _params(pkg, **k))
                                       for i, (p, k) in enumerate(reqs)])
        got.append(([toks[f"{pkg}-{i}"][0] for i in range(2)],
                    [reasons[f"{pkg}-{i}"][0] for i in range(2)]))
    assert eng.registry.summary()["bigdl_tpu_preemptions_total"] > 0
    assert not eng.has_unfinished()
    assert got[1] == got[0]
    assert [len(t) for t in got[1][0]] == [16, 3]
    ref, _, _ = drive(_port_engine(models, max_batch=1,
                                   preempt_after_steps=0),
                      [("ref", reqs[0][0], _params("port", **reqs[0][1]))])
    assert got[1][0][0] == ref["ref"][0]


def test_preemption_relieves_starvation(models):
    """The short request's first token comes before the long one ends."""
    eng = _port_engine(models, max_batch=1, preempt_after_steps=3)
    eng.add_request("long", PROMPTS[1], _params("port", max_tokens=30))
    eng.add_request("short", PROMPTS[0], _params("port", max_tokens=4))
    first_short, long_done = None, None
    for i in range(400):
        eng.step()
        if first_short is None and eng.get_outputs("short"):
            first_short = i
        if any(o.finished for o in eng.get_outputs("long")):
            long_done = i
            break
    assert first_short is not None and long_done is not None
    assert first_short < long_done
    assert eng.stats_snapshot()["requests"]["recent"]


def test_oversubscription_all_complete(models):
    """6 requests through 2 slots with aggressive preemption: every one
    completes with exactly max_tokens tokens."""
    eng = _port_engine(models, max_batch=2, preempt_after_steps=2)
    reqs = [(f"r{i}", [i + 1, i + 2, i + 3], _params("port", max_tokens=6))
            for i in range(6)]
    toks, _, reasons = drive(eng, reqs, steps=800)
    assert all(len(toks[r][0]) == 6 for r, _, _ in reqs)
    assert all(reasons[r] == {0: "length"} for r, _, _ in reqs)


# -- the JAX package's single-engine cases, on the port ---------------------


def test_repetition_penalty_changes_output(models):
    eng = _port_engine(models, max_batch=2)
    prompt = [3, 9, 3, 9, 3, 9, 3, 9]
    plain, _, _ = drive(eng, [("p", prompt, _params("port", max_tokens=16))])
    pen, _, _ = drive(eng, [("q", prompt, _params(
        "port", max_tokens=16, repetition_penalty=1.8))])
    plain, pen = plain["p"][0], pen["q"][0]
    assert plain != pen
    assert max(pen.count(t) for t in set(pen)) < max(
        plain.count(t) for t in set(plain))


def test_logprobs_returned_and_consistent(models):
    eng = _port_engine(models, max_batch=2)
    toks, lps, _ = drive(eng, [("lp", [1, 2, 3, 4], _params(
        "port", max_tokens=6, logprobs=3))])
    toks, lps = toks["lp"][0], lps["lp"][0]
    assert len(lps) == len(toks) == 6
    for entry, tok in zip(lps, toks):
        assert entry.token_id == tok and entry.logprob <= 0.0
        assert len(entry.top) == 3
        tops = [lp for _, lp in entry.top]
        assert tops == sorted(tops, reverse=True)
        assert entry.top[0][1] == pytest.approx(entry.logprob, abs=1e-9)


@pytest.mark.parametrize("kw", [dict(n=1, best_of=3, temperature=1.2,
                                     seed=7),
                                dict(temperature=0.9, seed=123)],
                         ids=["best_of", "seeded"])
def test_seeded_requests_repeat(models, kw):
    eng = _port_engine(models)
    a, _, _ = drive(eng, [("a", [5, 6, 7], _params("port", max_tokens=5,
                                                   **kw))])
    b, _, _ = drive(eng, [("b", [5, 6, 7], _params("port", max_tokens=5,
                                                   **kw))])
    assert a["a"] == b["b"] and set(a["a"]) == {0}


@pytest.mark.parametrize("kw", [dict(temperature=3.0, top_k=1),
                                dict(temperature=2.0, top_p=1e-6),
                                dict(temperature=1.0, top_p=0.0)],
                         ids=["top_k1", "top_p_epsilon", "top_p_zero"])
def test_degenerate_sampling_is_greedy(models, kw):
    eng = _port_engine(models, max_batch=2)
    g, _, _ = drive(eng, [("g", [2, 4, 6], _params("port", max_tokens=10))])
    s, _, _ = drive(eng, [("s", [2, 4, 6], _params("port", max_tokens=10,
                                                   **kw))])
    assert s["s"] == g["g"]


def test_seeded_output_independent_of_batch_composition(models):
    """A seeded request samples the same device stream alone or beside a
    host-sampled (penalties) request."""
    p = _params("port", max_tokens=12, temperature=0.9, top_k=8, seed=7)
    alone, _, _ = drive(_port_engine(models, max_batch=2),
                        [("a", [5, 6, 7], p)])
    eng = _port_engine(models, max_batch=2)
    eng.add_request("noise", [3, 9, 3, 9], _params(
        "port", max_tokens=60, repetition_penalty=1.3))
    for _ in range(3):
        eng.step()
    mixed, _, _ = drive(eng, [("b", [5, 6, 7], p)])
    assert mixed["b"] == alone["a"]


def test_ignore_eos(models):
    """ignore_eos decodes past the EOS id (the JAX engine's L3437)."""
    tcfg = models[1].config
    probe = _port_engine(models)
    first, _, _ = drive(probe, [("f", PROMPTS[0], _params(
        "port", max_tokens=4))])
    eos = first["f"][0][1]
    model = SyntheticCausalLM(models[1].params, tcfg, eos_token_id=eos)
    outs = {}
    for ignore in (False, True):
        eng = tengine.LLMEngine(model, tengine.EngineConfig(
            max_batch=2, max_seq=MAX_SEQ), device="cpu")
        toks, _, reasons = drive(eng, [("e", PROMPTS[0], _params(
            "port", max_tokens=4, ignore_eos=ignore))])
        outs[ignore] = (toks["e"][0], reasons["e"][0])
    assert outs[False] == (first["f"][0][:2], "stop")
    assert outs[True] == (first["f"][0], "length")


def test_metrics_and_stats_follow_the_engine(models):
    reg = MetricsRegistry()
    eng = tengine.LLMEngine(models[1], tengine.EngineConfig(
        max_batch=2, max_seq=MAX_SEQ, preempt_after_steps=2), device="cpu",
        registry=reg)
    drive(eng, [("m0", PROMPTS[1], _params("port", max_tokens=8)),
                ("m1", PROMPTS[0], _params("port", max_tokens=8)),
                ("m2", PROMPTS[2], _params("port", max_tokens=3))])
    summ = reg.summary()
    assert summ["bigdl_tpu_admissions_total"] >= 3
    assert summ["bigdl_tpu_tokens_generated_total"] == 19
    assert summ['bigdl_tpu_requests_finished_total{reason="length"}'] == 3
    assert summ["bigdl_tpu_preemptions_total"] == \
        summ["bigdl_tpu_stall_guard_trips_total"] > 0
    assert summ["bigdl_tpu_ttft_seconds"]["count"] == 3
    snap = eng.stats_snapshot()
    assert set(snap) == {"slots", "queue_depth", "admitting", "stall_steps",
                         "engine_steps", "paged", "metrics", "requests"}
    assert snap["slots"] == {"total": 2, "active": 0}
    assert len(snap["requests"]["recent"]) == 3
    assert dataclasses.asdict(tengine.SamplingParams()).keys() <= \
        dataclasses.asdict(jengine.SamplingParams()).keys()
