"""The port's resident decode step (``BIGDL_TPU_TORCH_DECODE_RESIDENT``)
against its eager step and the JAX package's ``decode_resident``:
counterparts of ``tests/test_decode_fastpath.py``'s resident cases.

On the CPU the resident step runs as a plain function (the card captures
the same function as a CUDA graph): the flag's parsing must equal the JAX
package's, errors included; engine, ``Generator`` and
``generate_on_device`` streams with the flag on must equal the port's with
it off token for token (same ops, tolerance none) and the JAX package's
with ``decode_resident="on"``; the engine makes one resident call a
pure-decode step and none while a penalty or logprobs slot is active. The
model is the tiny sym_int4 llama of ``test_torch_serving_sampling.py``
and its prompts, rows on which no step of the two forwards ties within a
bf16 ulp (the 6-token row is not tie-free through the Generator's pad
repair, nor are the 6-token cuts of the rows when sampled: those cases
leave them out). Seeded streams meet the same ulps at the top-k / top-p
edges: of sampler seeds 0-5 (rows 1 and 2 at seed s and s + 10) with
cuts, seeds 2 and 4 give equal streams at all four KV kinds (the others
split one row at fp8_e5m2 or int4), and every seed without cuts does;
the engine cases use seed 2 with cuts and seed 12 without. A NaN-logits
request fails with the JAX server's 500 body, and no
``torch.cuda.CUDAGraph`` is ever made on the CPU.
"""

import copy
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu import config as jconfig
from bigdl_tpu import generation as jgen
from bigdl_tpu.models import llama as jllama
from bigdl_tpu.observability.metrics import MetricsRegistry as JaxRegistry
from bigdl_tpu.serving import api_server as japi
from bigdl_tpu.serving import engine as jengine
from bigdl_tpu.utils.testing import SyntheticCausalLM as JaxSyntheticLM
from bigdl_tpu_torch import bridge, config as tconfig
from bigdl_tpu_torch import generation as tgen
from bigdl_tpu_torch.cuda_graph import StepGraph, addresses
from bigdl_tpu_torch.models import llama as tllama
from bigdl_tpu_torch.observability.metrics import MetricsRegistry
from bigdl_tpu_torch.ops import cuda as tcuda
from bigdl_tpu_torch.ops.cuda import dequant_matmul as tdq
from bigdl_tpu_torch.serving import api_server as tapi
from bigdl_tpu_torch.serving import engine as tengine
from bigdl_tpu_torch.utils.testing import SyntheticCausalLM
from test_torch_api_server import Running
from test_torch_serving_sampling import MAX_SEQ, PROMPTS, drive
from test_torch_serving_sampling import models  # noqa: F401 (fixture)
from torch_threads import one_intra_op_thread  # noqa: F401

ENV = "BIGDL_TPU_TORCH_DECODE_RESIDENT"
KV_KINDS = ("bf16", "fp8_e5m2", "int8", "int4")
NEW = 8
SAMPLED = dict(temperature=0.8, top_k=40, top_p=0.95, seed=1)
CUT = dict(temperature=0.8, top_k=40, top_p=0.95)


@pytest.fixture
def jax_resident():
    """The JAX package with ``decode_resident="on"``, restored after."""
    saved = jconfig.flags()
    jconfig.set_flags(decode_resident="on")
    yield
    jconfig.set_flags(**{"decode_resident": saved.decode_resident})


def _port_engine(models, **kw):
    return tengine.LLMEngine(models[1], tengine.EngineConfig(
        max_batch=4, max_seq=MAX_SEQ, **kw), device="cpu",
        registry=MetricsRegistry())


def _streams(eng, pkg, kws):
    reqs = [(f"r{i}", p, (jengine if pkg == "jax" else tengine)
             .SamplingParams(**kw)) for i, (p, kw) in enumerate(kws)]
    toks, _, reasons = drive(eng, reqs)
    return [toks[r] for r, _, _ in reqs], [reasons[r] for r, _, _ in reqs]


# -- the flag -----------------------------------------------------------------


@pytest.mark.parametrize("spec", [None, "", "auto", "on", "off", "1", "0",
                                  "true", "false", " On ", "FALSE", 1,
                                  "yes", "2", "resident"])
def test_flag_parsing_equals_jax(spec, monkeypatch):
    try:
        want = jconfig.resolve_decode_resident(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tconfig.resolve_decode_resident(spec)
        assert str(got.value) == str(e)
        monkeypatch.setenv(ENV, str(spec))
        with pytest.raises(ValueError):
            tconfig.flags()
        return
    assert tconfig.resolve_decode_resident(spec) == want
    if spec is not None:
        monkeypatch.setenv(ENV, str(spec))
        assert tconfig.flags().decode_resident == want
        assert tconfig.decode_resident_enabled() == (want != "off")


def test_flag_defaults_to_auto(monkeypatch):
    monkeypatch.delenv(ENV, raising=False)
    assert tconfig.flags().decode_resident == "auto" \
        == jconfig.RuntimeFlags().decode_resident
    assert tconfig.decode_resident_enabled()


# -- the engine ---------------------------------------------------------------


@pytest.mark.parametrize("kv", KV_KINDS)
def test_engine_resident_equals_eager_and_jax(models, kv, monkeypatch,
                                              jax_resident):
    """A greedy batch (the resident step's argmax) and a batch with a
    seeded row (its sampler): flag on == flag off == the JAX engine."""
    batches = [[(p, dict(max_tokens=NEW)) for p in PROMPTS],
               [(PROMPTS[0], dict(max_tokens=NEW)),
                (PROMPTS[1], dict(max_tokens=NEW, seed=2, **CUT)),
                (PROMPTS[2], dict(max_tokens=NEW, temperature=0.7,
                                  seed=12))]]
    jeng = jengine.LLMEngine(models[0], jengine.EngineConfig(
        max_batch=4, max_seq=MAX_SEQ, kv_cache_dtype=kv))
    for kws in batches:
        want = _streams(jeng, "jax", kws)
        runs = {}
        for mode in ("on", "off"):
            monkeypatch.setenv(ENV, mode)
            eng = _port_engine(models, kv_cache_dtype=kv)
            runs[mode] = _streams(eng, "port", kws)
            assert (eng.resident_steps > 0) == (mode == "on")
            assert eng.resident_graph_stats() == []
        assert runs["on"] == runs["off"] == want


def test_one_resident_call_per_pure_decode_step(models, monkeypatch):
    """Pure-decode steps of simple slots make one resident call each;
    while a penalty or a logprobs slot is active none is made."""
    monkeypatch.setenv(ENV, "on")
    calls = []
    real = tengine.decode_resident

    def counting(*a, **kw):
        calls.append(a[-1])
        return real(*a, **kw)

    monkeypatch.setattr(tengine, "decode_resident", counting)
    eng = _port_engine(models)
    sp = tengine.SamplingParams
    eng.add_request("g", PROMPTS[0], sp(max_tokens=40))
    eng.step()                             # admission + first decode
    calls.clear()
    for _ in range(5):
        eng.step()
    assert calls == [True] * 5             # all greedy: the argmax branch
    eng.add_request("s", PROMPTS[1], sp(max_tokens=40, temperature=0.9,
                                        seed=3))
    eng.step()
    calls.clear()
    for _ in range(3):
        eng.step()
    assert calls == [False] * 3            # a sampled row: the sampler
    for kw in (dict(repetition_penalty=1.3), dict(logprobs=2)):
        eng.add_request("c", PROMPTS[2], sp(max_tokens=4, **kw))
        calls.clear()
        while any(s.active and s.req.request_id == "c"
                  for s in eng.slots) or eng.waiting or eng._admitting:
            eng.step()
        assert calls == []
        eng.get_outputs("c")
        eng.step()
        assert len(calls) == 1
    monkeypatch.setenv(ENV, "off")
    calls.clear()
    eng.step()
    assert calls == []


def test_paged_engine_keeps_the_eager_step(models, monkeypatch):
    monkeypatch.setenv(ENV, "on")
    eng = _port_engine(models, kv_page_size=16)
    toks, _ = _streams(eng, "port", [(PROMPTS[1], dict(max_tokens=4))])
    assert len(toks[0][0]) == 4 and eng.resident_steps == 0


# -- the Generator ------------------------------------------------------------


@pytest.fixture(scope="module")
def gen_models(models):
    """(JAX params, port params, config pair) of the serving test model."""
    return models[0].params, models[1].params, (models[0].config,
                                                models[1].config)


@pytest.fixture(scope="module")
def jax_generate(gen_models):
    """The JAX Generator's generate over the test model, one Generator
    and one answer a (row, settings) for the module (each new setting
    compiles)."""
    jp, _, (jcfg, _) = gen_models
    jg = jgen.Generator(jp, jcfg, max_seq=MAX_SEQ)
    done = {}

    def generate(row, **kw):
        key = (row, tuple(sorted(kw.items())))
        if key not in done:
            saved = jconfig.flags().decode_resident
            jconfig.set_flags(decode_resident="on")
            try:
                done[key] = jg.generate(PROMPTS[row],
                                        jgen.GenerationConfig(**kw))
            finally:
                jconfig.set_flags(decode_resident=saved)
        return done[key]

    return generate


@pytest.mark.parametrize("case,row", [("greedy", 1), ("sampled", 2),
                                      ("eos", 1)])
def test_generator_resident_equals_eager_and_jax(gen_models, case, row,
                                                 monkeypatch, jax_generate):
    _, tp, (_, tcfg) = gen_models
    prompt = PROMPTS[row]
    kw = dict(max_new_tokens=10)
    if case == "sampled":
        kw.update(do_sample=True, **SAMPLED)
    if case == "eos":
        kw["eos_token_id"] = int(jax_generate(row, max_new_tokens=10)[0][3])
    want = jax_generate(row, **kw)
    calls = []
    real = tgen.step_resident
    monkeypatch.setattr(tgen, "step_resident",
                        lambda *a: calls.append(1) or real(*a))
    got = {}
    for mode in ("on", "off"):
        monkeypatch.setenv(ENV, mode)
        g = tgen.Generator(tp, tcfg, max_seq=MAX_SEQ)
        got[mode] = g.generate(prompt, tgen.GenerationConfig(**kw))
        assert g.graph_stats() == []
    np.testing.assert_array_equal(got["on"], got["off"])
    np.testing.assert_array_equal(got["on"], want)
    assert len(calls) == want.shape[1] - 1     # every step after the first
    if case == "eos":
        assert want.shape[1] == 4


def test_generator_gate_keeps_the_eager_step(gen_models, monkeypatch):
    """Penalties or check_logits keep the eager step (the JAX gate)."""
    _, tp, (_, tcfg) = gen_models
    monkeypatch.setenv(ENV, "on")
    calls = []
    real = tgen.step_resident
    monkeypatch.setattr(tgen, "step_resident",
                        lambda *a: calls.append(1) or real(*a))
    g = tgen.Generator(tp, tcfg, max_seq=MAX_SEQ)
    for kw in (dict(repetition_penalty=1.3), dict(check_logits=True)):
        g.generate(PROMPTS[1], tgen.GenerationConfig(max_new_tokens=4, **kw))
    assert calls == []


def test_interleaved_streams_of_one_generator(gen_models, monkeypatch):
    """Two streams of one Generator in flight at one batch size, stepped
    in turns: the second must not share the first's kept cache, and each
    stream equals its prompt's eager stream. A later call reuses the kept
    cache."""
    _, tp, (_, tcfg) = gen_models
    gen = tgen.GenerationConfig(max_new_tokens=8)
    monkeypatch.setenv(ENV, "off")
    eager = tgen.Generator(tp, tcfg, max_seq=MAX_SEQ)
    want = [eager.generate(PROMPTS[r], gen) for r in (1, 2)]
    monkeypatch.setenv(ENV, "on")
    g = tgen.Generator(tp, tcfg, max_seq=MAX_SEQ)
    streams = [g.stream(PROMPTS[r], gen) for r in (1, 2)]
    got = [np.stack(t, axis=1) for t in zip(*zip(*streams))]
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert not torch.is_inference_mode_enabled()
    assert list(g._kept) == [1] and not g._kept[1].busy
    kept = g._kept[1]
    np.testing.assert_array_equal(g.generate(PROMPTS[2], gen), want[1])
    assert g._kept[1] is kept


def test_generator_lends_a_kept_cache_to_one_call(gen_models):
    _, tp, (_, tcfg) = gen_models
    g = tgen.Generator(tp, tcfg, max_seq=MAX_SEQ)
    a = g._borrow(1)
    b = g._borrow(1)                       # a is busy: b is this call's
    assert a is not b and g._kept[1] is a and a.busy and b.busy
    a.busy = b.busy = False
    c = g._borrow(1)
    assert c is a
    c.busy = False
    for n in (2, 3):
        g._borrow(n).busy = False
    assert list(g._kept) == [2, 3] and len(g._kept) == tgen.KEEP_CACHES
    g.params = dict(tp, norm=tp["norm"].clone())   # the weights moved
    d = g._borrow(3)
    assert d is not g._kept.get(2) and d.addrs == addresses(g.params)


def test_kept_cache_keeps_the_last_graphs(gen_models):
    _, tp, (_, tcfg) = gen_models
    g = tgen.Generator(tp, tcfg, max_seq=MAX_SEQ)
    k = g._borrow(1)
    gens = [tgen.GenerationConfig(top_k=n) for n in (0, 5, 9)]
    first = k.step(g, 0.0, gens[0])
    assert k.step(g, 0.0, gens[0]) is first
    for gc in gens[1:]:
        k.step(g, 0.0, gc)
    assert len(k.steps) == tgen.KEEP_GRAPHS
    assert first not in k.steps.values()
    assert k.pool is None                  # a graph pool only on the card


def test_engine_graphs_follow_the_flags(models):
    eng = _port_engine(models)
    rs = tengine._ResidentStep(eng)
    f = tconfig.flags()
    g = rs.graph(True, f)
    assert rs.graph(True, f) is g and rs.graph(False, f) is not g
    f2 = dataclasses.replace(f, matmul_gemv="fold")
    assert rs.graph(True, f2) is not g and list(rs.graphs) == [True]


# -- generate_on_device -------------------------------------------------------


def _jax_on_device(jp, jcfg, ids, new, **kw):
    cache = jllama.new_cache(jcfg, ids.shape[0], MAX_SEQ)
    out, cache = jgen.generate_on_device(
        jp, jcfg, jllama.forward, jnp.asarray(ids, jnp.int32), cache, new,
        **kw)
    return np.asarray(out), int(cache.pos)


def _port_on_device(tp, tcfg, ids, new, **kw):
    cache = tllama.new_cache(tcfg, ids.shape[0], MAX_SEQ, device="cpu")
    out, cache = tgen.generate_on_device(tp, tcfg, tllama.forward, ids,
                                         cache, new, **kw)
    assert out.dtype == torch.int32 and out.shape == (ids.shape[0], new)
    return out.numpy(), int(cache.pos)


@pytest.mark.parametrize("case", ["greedy_bs3", "sampled", "eos",
                                  "penalties"])
def test_generate_on_device_equals_jax(gen_models, case):
    """Greedy at bs 3 (6-token cuts of the rows), seeded top-k / top-p
    sampling, an EOS stop, and sampling under all three penalties."""
    jp, tp, (jcfg, tcfg) = gen_models
    ids = np.asarray([PROMPTS[1]])
    kw = {}
    if case == "greedy_bs3":
        ids = np.asarray([p[:6] for p in PROMPTS])
    elif case == "sampled":
        kw = dict(SAMPLED)
    elif case == "eos":
        kw = dict(eos_token_id=174)      # the greedy stream's 4th token
    elif case == "penalties":
        kw = dict(temperature=0.8, seed=2, repetition_penalty=1.3,
                  presence_penalty=0.5, frequency_penalty=0.2)
    want, want_pos = _jax_on_device(jp, jcfg, ids, 10, **kw)
    got, pos = _port_on_device(tp, tcfg, ids, 10, **kw)
    np.testing.assert_array_equal(got, want)
    assert pos == want_pos == ids.shape[1] + 9
    if case == "eos":
        assert got[0, 3] == 174 and (got[0, 4:] == 0).all()


def test_generate_on_device_max_seq_error_equals_jax(gen_models):
    jp, tp, (jcfg, tcfg) = gen_models
    ids = np.asarray([PROMPTS[2]])
    with pytest.raises(ValueError) as want:
        _jax_on_device(jp, jcfg, ids, MAX_SEQ)
    with pytest.raises(ValueError) as got:
        _port_on_device(tp, tcfg, ids, MAX_SEQ)
    assert str(got.value) == str(want.value)


# -- C6 behind the server -----------------------------------------------------


@pytest.fixture(scope="module")
def nan_models(models):
    """The serving test model with embedding row 7 set to NaN: a prompt
    holding token 7 gives NaN logits from its first decode step on."""
    jp = jax.tree.map(np.asarray, models[0].params)
    jp = copy.copy(jp)
    emb = np.array(jp["embed_tokens"])
    emb[7] = np.nan
    jp["embed_tokens"] = emb
    tp = bridge.params_from_numpy(jp, device="cpu")
    return (JaxSyntheticLM(jax.tree.map(jnp.asarray, jp), models[0].config),
            SyntheticCausalLM(tp, models[1].config))


NAN_BODIES = ({"prompt": [7, 1, 2, 3, 4], "max_tokens": 6},
              {"prompt": PROMPTS[1], "max_tokens": 6})


@pytest.fixture(scope="module")
def jax_nan_answers(nan_models):
    """The JAX server's answers to NAN_BODIES, in order (the NaN request,
    then a healthy one), asked once for the module. The engine counts
    into a registry of its own: the process-wide one stays clean for
    the JAX package's own quarantine tests."""
    jax_ = Running(japi.OpenAIServer(jengine.LLMEngine(
        nan_models[0], jengine.EngineConfig(max_batch=4, max_seq=MAX_SEQ),
        registry=JaxRegistry())))
    try:
        return [jax_.post("/v1/completions", b) for b in NAN_BODIES]
    finally:
        jax_.close()


@pytest.mark.parametrize("mode", ["on", "off"])
def test_nan_request_is_a_500_on_both_servers(nan_models, mode,
                                              jax_nan_answers, monkeypatch):
    monkeypatch.setenv(ENV, mode)
    port = Running(tapi.OpenAIServer(tengine.LLMEngine(
        nan_models[1], tengine.EngineConfig(max_batch=4, max_seq=MAX_SEQ),
        device="cpu", registry=MetricsRegistry())))
    try:
        (code, out), (jcode, jout) = (port.post("/v1/completions",
                                                NAN_BODIES[0]),
                                      copy.deepcopy(jax_nan_answers[0]))
        assert code == jcode == 500
        for o in (out, jout):
            assert o["error"].pop("id").startswith("cmpl-")
            o["error"].pop("request_id")
        assert out == jout
        assert out["error"]["reason"] == "nan_logits"
        assert out["error"]["type"] == "engine_error"
        # a healthy neighbour still completes
        (code, out), (jcode, jout) = (port.post("/v1/completions",
                                                NAN_BODIES[1]),
                                      jax_nan_answers[1])
        assert code == jcode == 200
        assert out["choices"][0]["text"] == jout["choices"][0]["text"]
        text = port.get("/metrics")[1].decode()
        assert ('bigdl_tpu_requests_quarantined_total{reason="nan_logits"} '
                '1') in text
        assert 'bigdl_tpu_requests_quarantined_total{reason="crash_loop"} 0' \
            in text
    finally:
        port.close()


# -- graphs and their accounting, on the CPU ----------------------------------


def test_no_cuda_graph_is_made_on_the_cpu(models, gen_models, monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a CUDA graph on the CPU")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", refuse)
    monkeypatch.setattr(torch.cuda, "graph", refuse)
    monkeypatch.setenv(ENV, "on")
    eng = _port_engine(models)
    _streams(eng, "port", [(PROMPTS[1], dict(max_tokens=4)),
                           (PROMPTS[2], dict(max_tokens=4, **SAMPLED))])
    assert eng.resident_steps > 0
    _, tp, (_, tcfg) = gen_models
    g = tgen.Generator(tp, tcfg, max_seq=MAX_SEQ)
    g.generate(PROMPTS[1], tgen.GenerationConfig(max_new_tokens=4))
    _port_on_device(tp, tcfg, np.asarray([PROMPTS[1]]), 4)
    assert tcuda.replay_counts() == {}


def test_capture_launch_accounting():
    """A capture's launches leave LAUNCHES as they were and are added
    back on each replay; replays are counted by kind."""
    tcuda.reset_launch_counts()
    tcuda.LAUNCHES["dequant_gemv"] = 3
    with tcuda.capturing_launches() as got:
        tcuda.LAUNCHES["dequant_gemv"] += 2
        tcuda.LAUNCHES["decode_attention"] += 1
    assert got == {"dequant_gemv": 2, "decode_attention": 1}
    assert tcuda.launch_counts()["dequant_gemv"] == 3
    assert tcuda.launch_counts()["decode_attention"] == 0
    tcuda.replayed("engine_decode_resident", got)
    tcuda.replayed("engine_decode_resident", got)
    assert tcuda.launch_counts()["dequant_gemv"] == 7
    assert tcuda.launch_counts()["decode_attention"] == 2
    assert tcuda.replay_counts() == {"engine_decode_resident": 2}
    tcuda.reset_launch_counts()
    assert tcuda.replay_counts() == {} and not any(
        tcuda.launch_counts().values())


def test_step_graph_runs_eagerly_off_the_card():
    n = []
    g = StepGraph("x", lambda: n.append(1), torch.device("cpu"))
    g()
    g()
    assert n == [1, 1] and g.graph is None
    assert g.stats()["captured"] is False and g.stats()["replays"] == 0


def test_addresses_follow_the_tensors(models):
    tp = models[1].params
    a = addresses(tp)
    assert a == addresses(dict(tp)) and len(a) > 10
    moved = dict(tp, norm=tp["norm"].clone())
    assert addresses(moved) != a


def test_scratch_buffers_are_the_current_ones():
    dev = torch.device("cpu")
    t = tdq.ticket_buffer(dev, 8)
    w = tdq.workspace_buffer(dev, 16)
    assert [b.data_ptr() for b in tdq.scratch_buffers(dev)] == [
        t.data_ptr(), w.data_ptr()]
    bigger = tdq.workspace_buffer(dev, w.numel() + 1)
    assert tdq.scratch_buffers(dev)[1] is bigger


def test_metrics_render_the_quarantine_family_from_the_first_scrape(models):
    eng = _port_engine(models)
    text = eng.registry.render()
    assert "# TYPE bigdl_tpu_requests_quarantined_total counter" in text
    for r in ("nan_logits", "crash_loop"):
        assert (f'bigdl_tpu_requests_quarantined_total{{reason="{r}"}} 0'
                in text)
    assert json.loads(json.dumps(eng.stats_snapshot()))["slots"]["total"] == 4
