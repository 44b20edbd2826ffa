"""The port's OpenAI-compatible server against the JAX package's, on the
same tiny model.

Both servers run on the CPU on port 0 over the bridged sym_int4 tiny llama
of ``test_torch_serving_sampling.py`` (its GEOM and its tie-free PROMPTS:
greedy streams of the two engines are equal on those rows). Without a
tokenizer the servers take token-id prompts and answer space-joined ids.
Covered: /v1/models, completions streamed and not (ids, usage, the SSE
end), stop strings, chat with a stub tokenizer (n=2, logprobs=2: the same
JSON keys as the JAX server's), a client that disconnects mid-stream, 400
on a bad prompt (C5 through HTTP), 404 on an unported path, /health (ok,
and wedged with a frozen loop), /metrics and /v1/stats, the copied
metrics registry's text, and ``main``'s argument parsing with
``--tiny-random``.
"""

import json
import socket
import time
import urllib.error
import urllib.request

import numpy as np
import pytest

from bigdl_tpu.observability import metrics as jmetrics
from bigdl_tpu.serving import api_server as japi
from bigdl_tpu.serving import engine as jengine
from bigdl_tpu_torch.observability import metrics as tmetrics
from bigdl_tpu_torch.serving import api_server as tapi
from bigdl_tpu_torch.serving import engine as tengine
from test_torch_serving_sampling import MAX_SEQ, PROMPTS
from test_torch_serving_sampling import models  # noqa: F401 (fixture)
from torch_threads import one_intra_op_thread  # noqa: F401

PORTED_FAMILIES = (
    "bigdl_tpu_request_phase_seconds", "bigdl_tpu_ttft_seconds",
    "bigdl_tpu_tpot_seconds", "bigdl_tpu_slot_occupancy",
    "bigdl_tpu_queue_depth", "bigdl_tpu_admissions_total",
    "bigdl_tpu_preemptions_total", "bigdl_tpu_stall_guard_trips_total",
    "bigdl_tpu_requests_finished_total", "bigdl_tpu_engine_steps_total",
    "bigdl_tpu_tokens_generated_total", "bigdl_tpu_requests_cancelled_total")


class StubTokenizer:
    """One id a character (mod 256); decode joins the characters."""

    def __call__(self, text):
        return {"input_ids": [ord(c) % 256 for c in text]}

    def decode(self, ids, skip_special_tokens=True):
        return "".join(chr(32 + i % 90) for i in ids)


def _port_server(models, tokenizer=None, **kw):
    eng = tengine.LLMEngine(models[1], tengine.EngineConfig(
        max_batch=4, max_seq=MAX_SEQ), device="cpu")
    return tapi.OpenAIServer(eng, tokenizer, **kw)


def _jax_server(models, tokenizer=None):
    eng = jengine.LLMEngine(models[0], jengine.EngineConfig(
        max_batch=4, max_seq=MAX_SEQ))
    return japi.OpenAIServer(eng, tokenizer)


class Running:
    """A server serving on 127.0.0.1, port 0, in the background."""

    def __init__(self, server):
        self.server = server
        httpd = server.serve(port=0, background=True)
        self.base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def get(self, path):
        try:
            with urllib.request.urlopen(self.base + path, timeout=60) as r:
                return r.status, r.read()
        except urllib.error.HTTPError as e:
            return e.code, e.read()

    def post(self, path, body, raw=False):
        req = urllib.request.Request(
            self.base + path, data=json.dumps(body).encode(),
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                data = r.read()
                return r.status, (data if raw else json.loads(data))
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    def close(self):
        self.server.shutdown()


@pytest.fixture(scope="module")
def servers(models):
    port = Running(_port_server(models))
    jax_ = Running(_jax_server(models))
    yield port, jax_
    port.close()
    jax_.close()


@pytest.fixture(scope="module")
def chat_servers(models):
    port = Running(_port_server(models, StubTokenizer()))
    jax_ = Running(_jax_server(models, StubTokenizer()))
    yield port, jax_
    port.close()
    jax_.close()


def _ids(text):
    return [int(t) for t in text.split()]


def _sse(payload: bytes):
    lines = [ln for ln in payload.decode().splitlines()
             if ln.startswith("data: ")]
    chunks = [json.loads(ln[6:]) for ln in lines if ln != "data: [DONE]"]
    return chunks, lines[-1]


def test_models_endpoint_equals_jax(servers):
    (ps, pb), (js, jb) = (s.get("/v1/models") for s in servers)
    assert ps == js == 200
    assert json.loads(pb) == json.loads(jb) == {
        "object": "list", "data": [{"id": "bigdl-tpu-model",
                                    "object": "model"}]}


@pytest.mark.parametrize("i", range(len(PROMPTS)))
def test_completions_streamed_and_not_equal_jax(servers, i):
    port, jax_ = servers
    body = {"prompt": PROMPTS[i], "max_tokens": 8}
    code, out = port.post("/v1/completions", body)
    jcode, jout = jax_.post("/v1/completions", body)
    assert code == jcode == 200
    ids = _ids(out["choices"][0]["text"])
    assert ids == _ids(jout["choices"][0]["text"]) and len(ids) == 8
    assert out["usage"] == jout["usage"] == {
        "prompt_tokens": len(PROMPTS[i]), "completion_tokens": 8,
        "total_tokens": len(PROMPTS[i]) + 8}
    assert out["choices"][0]["finish_reason"] == \
        jout["choices"][0]["finish_reason"] == "length"
    assert set(out) == set(jout) and set(out["choices"][0]) == \
        set(jout["choices"][0])
    code, payload = port.post("/v1/completions", dict(body, stream=True),
                              raw=True)
    chunks, last = _sse(payload)
    assert code == 200 and last == "data: [DONE]"
    assert _ids("".join(c["choices"][0]["text"] for c in chunks)) == ids
    _, jpayload = jax_.post("/v1/completions", dict(body, stream=True),
                            raw=True)
    jchunks, _ = _sse(jpayload)
    assert [c["choices"][0]["text"] for c in chunks] == \
        [c["choices"][0]["text"] for c in jchunks]


def test_stop_strings_cut_text_and_stream(servers):
    """The JAX package's ``test_openai_server_stop_strings`` on the port:
    the text is cut at the stop, finish_reason is "stop", and nothing
    past the stop leaks into the stream."""
    port, jax_ = servers
    _, full = port.post("/v1/completions",
                        {"prompt": PROMPTS[0], "max_tokens": 8})
    full_text = full["choices"][0]["text"]
    stop = f" {_ids(full_text)[3]}"
    want = full_text[:full_text.index(stop)]
    body = {"prompt": PROMPTS[0], "max_tokens": 8, "stop": stop}
    for srv in servers:
        _, out = srv.post("/v1/completions", body)
        assert out["choices"][0]["text"] == want
        assert out["choices"][0]["finish_reason"] == "stop"
    _, payload = port.post("/v1/completions",
                           dict(body, stop=[stop], stream=True), raw=True)
    chunks, last = _sse(payload)
    streamed = "".join(c["choices"][0]["text"] for c in chunks)
    assert streamed == want and stop not in streamed
    assert last == "data: [DONE]"


def test_chat_n2_logprobs_same_keys_as_jax(chat_servers):
    body = {"messages": [{"role": "user", "content": "hi"}],
            "max_tokens": 4, "n": 2, "logprobs": True, "top_logprobs": 2,
            "temperature": 0.9, "seed": 3}
    (code, out), (jcode, jout) = (s.post("/v1/chat/completions", body)
                                  for s in chat_servers)
    assert code == jcode == 200
    assert set(out) == set(jout)
    assert out["object"] == "chat.completion"
    assert [c["index"] for c in out["choices"]] == \
        [c["index"] for c in jout["choices"]] == [0, 1]
    for c, jc in zip(out["choices"], jout["choices"]):
        assert set(c) == set(jc)
        assert set(c["message"]) == set(jc["message"])
        assert set(c["logprobs"]) == set(jc["logprobs"])
        assert [len(d) for d in c["logprobs"]["top_logprobs"]] == \
            [len(d) for d in jc["logprobs"]["top_logprobs"]] == [2] * 4
    assert out["usage"] == jout["usage"]
    assert out["usage"]["completion_tokens"] == 8
    # the same request streamed: chat chunks, ended by [DONE]
    code, payload = chat_servers[0].post(
        "/v1/chat/completions", dict(body, stream=True, logprobs=None),
        raw=True)
    chunks, last = _sse(payload)
    assert last == "data: [DONE]"
    assert {c["choices"][0]["index"] for c in chunks} == {0, 1}
    assert all(c["object"] == "chat.completion.chunk" for c in chunks)


def _cancelled(srv, path):
    return srv.server._cancelled.labels(path).value


@pytest.mark.parametrize("stream", [True, False], ids=["stream", "nonstream"])
def test_client_disconnect_aborts_the_request(servers, stream):
    """A client that hangs up mid-generation: the engine aborts the
    request (its span finishes with reason "abort") and
    bigdl_tpu_requests_cancelled_total{path} rises."""
    port = servers[0]
    eng = port.server.engine
    path = "stream" if stream else "nonstream"
    before = _cancelled(port, path)
    host, p = port.base[len("http://"):].split(":")
    body = json.dumps({"prompt": PROMPTS[1], "stream": stream,
                       "max_tokens": MAX_SEQ - len(PROMPTS[1]) - 2,
                       "ignore_eos": True}).encode()
    s = socket.create_connection((host, int(p)), timeout=30)
    s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
              b"Content-Type: application/json\r\n"
              + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    if stream:
        got = b""
        while b"data: " not in got:           # until the first delta
            chunk = s.recv(4096)
            assert chunk, "the server closed the stream"
            got += chunk
    else:
        deadline = time.time() + 30
        while not any(sl.active for sl in eng.slots):
            assert time.time() < deadline
            time.sleep(0.005)
    s.close()
    deadline = time.time() + 30
    while eng.has_unfinished() or _cancelled(port, path) == before:
        assert time.time() < deadline, "the request was not aborted"
        time.sleep(0.01)
    assert _cancelled(port, path) == before + 1
    recent = eng.stats_snapshot()["requests"]["recent"]
    assert recent[-1]["finish_reason"] == "abort"
    assert recent[-1]["n_generated"] < MAX_SEQ - len(PROMPTS[1]) - 2


@pytest.mark.parametrize("prompt", [[1, 2.5], [1, "3"], [256], [-2],
                                    "text without a tokenizer", []])
def test_bad_prompt_is_a_400_on_both(servers, prompt):
    for srv in servers:
        code, out = srv.post("/v1/completions",
                             {"prompt": prompt, "max_tokens": 2})
        assert code == 400 and "error" in out
    assert not servers[0].server.engine.has_unfinished()


@pytest.mark.parametrize("method,path", [
    ("GET", "/v1/memory"), ("GET", "/v1/debug/dump"), ("GET", "/v1/slo"),
    ("GET", "/v1/usage"), ("GET", "/v1/perf"), ("GET", "/v1/quality"),
    ("GET", "/v1/internal/spans"), ("POST", "/v1/embeddings"),
    ("POST", "/v1/internal/kv_handoff"), ("POST", "/v1/admin/migrate_out"),
    ("POST", "/v1/profiler/start")])
def test_unported_path_is_a_404(servers, method, path):
    port = servers[0]
    code, _ = (port.get(path) if method == "GET"
               else port.post(path, {"input": "x"}))
    assert code == 404


def test_health_ok_then_wedged_with_a_frozen_loop(models):
    srv = Running(_port_server(models, wedge_sec=0.2))
    try:
        code, body = srv.get("/health")
        assert code == 200 and json.loads(body) == {"status": "ok"}
        assert srv.get("/ping")[0] == 200
        srv.server.loop.stop()                      # the loop freezes
        srv.server.engine.add_request("stuck", PROMPTS[0],
                                      tengine.SamplingParams(max_tokens=2))
        time.sleep(0.3)
        code, body = srv.get("/health")
        assert code == 503 and json.loads(body)["status"] == "wedged"
    finally:
        srv.close()


def test_metrics_and_stats(servers):
    port = servers[0]
    port.post("/v1/completions", {"prompt": PROMPTS[0], "max_tokens": 3})
    code, body = port.get("/metrics")
    text = body.decode()
    assert code == 200
    for fam in PORTED_FAMILIES:
        assert f"# TYPE {fam} " in text, fam
    assert 'bigdl_tpu_requests_finished_total{reason="length"}' in text
    code, body = port.get("/v1/stats")
    snap = json.loads(body)
    assert code == 200
    assert set(snap) == {"slots", "queue_depth", "admitting", "stall_steps",
                         "engine_steps", "paged", "metrics", "requests",
                         "loop_errors"}
    assert snap["loop_errors"] == 0 and snap["engine_steps"] > 0
    assert snap["slots"]["total"] == 4 and snap["paged"] is None
    # the keys it shares with the JAX server's snapshot
    jsnap = json.loads(servers[1].get("/v1/stats")[1])
    assert set(snap) - {"loop_errors"} <= set(jsnap)


def test_metrics_registry_renders_the_jax_text():
    """The copied registry renders the same text and summary as the JAX
    package's for the same operations."""
    rng = np.random.default_rng(0)
    regs = [jmetrics.MetricsRegistry(), tmetrics.MetricsRegistry()]
    for r in regs:
        r.counter("a_total", "A counter.\nTwo lines.").inc(3)
        r.counter("b_total", "Labeled.", ["reason"])
        r.gauge("c", "A gauge.").set(-2.5)
        r.histogram("d_seconds", "Latency.", ["phase"])
        r.histogram("e", "Ratios.", buckets=jmetrics.RATIO_BUCKETS)
    ops = rng.integers(0, 4, 200)
    vals = rng.exponential(0.05, 200)
    for op, v in zip(ops, vals):
        for r in regs:
            if op == 0:
                r.counter("b_total", "Labeled.", ["reason"]).labels(
                    ["stop", 'a"b\\c'][int(v * 100) % 2]).inc()
            elif op == 1:
                r.histogram("d_seconds", "Latency.", ["phase"]).labels(
                    "prefill" if v > 0.05 else "decode").observe(v)
            elif op == 2:
                r.histogram("e", "Ratios.",
                            buckets=jmetrics.RATIO_BUCKETS).observe(v * 5)
            else:
                r.gauge("c", "A gauge.").inc(v)
    assert regs[1].render() == regs[0].render()
    assert regs[1].summary() == regs[0].summary()
    assert regs[1].snapshot() == regs[0].snapshot()
    with pytest.raises(ValueError):
        regs[1].gauge("a_total")


def test_main_parses_arguments_and_serves_tiny_random(capsys):
    args = tapi.build_parser().parse_args(
        ["--tiny-random", "--tiny-seed", "3", "--device", "cpu",
         "--max-batch", "2", "--max-seq", "4096", "--kv-page-size", "16",
         "--prefix-sharing", "on", "--port", "0"])
    assert (args.device, args.max_batch, args.kv_page_size,
            args.prefix_sharing, args.model) == ("cpu", 2, 16, "on", None)
    assert tapi.build_parser().parse_args([]).device == "cuda"
    srv = Running(tapi.build_server(args))
    try:
        eng = srv.server.engine
        # the tiny config's rope table caps the context
        assert eng.cfg_engine.max_seq == 256 and eng.pool is not None
        assert srv.server.tokenizer is None
        assert "token-id" in capsys.readouterr().err
        code, out = srv.post("/v1/completions",
                             {"prompt": [1, 2, 3], "max_tokens": 4})
        assert code == 200 and len(_ids(out["choices"][0]["text"])) == 4
    finally:
        srv.close()
    with pytest.raises(SystemExit):
        tapi.main(["--device", "cpu"])      # neither --model nor tiny
