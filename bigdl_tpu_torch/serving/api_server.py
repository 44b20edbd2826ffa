"""OpenAI-compatible HTTP server over the port's continuous-batching engine
(port of ``bigdl_tpu/serving/api_server.py``), on the stdlib
ThreadingHTTPServer: no dependency beyond the port.

Endpoints:
- GET /v1/models
- GET /health and /ping: ``ok``, or ``wedged`` (503) when work is pending
  and the engine's step heartbeat is older than ``wedge_sec``
- GET /metrics: Prometheus text of the engine's registry
- GET /v1/stats: the engine's ``stats_snapshot()`` and the loop's error
  count
- POST /v1/completions and /v1/chat/completions, streamed (SSE ending in
  ``data: [DONE]``) or not, with ``usage``, n choices, the OpenAI logprobs
  block, ``stop`` strings (cut text, nothing past the stop streamed), and
  an abort of the request when the client disconnects

A request the engine refuses (``ValueError``: a bad prompt or parameter)
answers 400; a non-streamed request the engine failed (finish reason
"error": its logits health check quarantined it) answers 500 with the
engine's ``error`` detail, as the JAX server does (a streamed one ends
with ``[DONE]`` after what it emitted); every other path answers 404. Not ported (each answers 404):
embeddings, KV handoff, migration, ``/v1/internal/*`` and ``/v1/admin/*``,
the profiler endpoints, ``/v1/memory``, ``/v1/debug/dump``, ``/v1/perf``,
``/v1/quality``, ``/v1/slo`` and ``/v1/usage``; drain and SIGTERM;
overload control, deadlines and tenants (``max_time_ms``, ``qos`` and
tenant headers are ignored); trace propagation.

Tokenization: pass a tokenizer (``transformers.AutoTokenizer``) at
construction. Without one, prompts are token-id lists and completions
return the ids as space-joined text.

    python -m bigdl_tpu_torch.serving.api_server --tiny-random --device cpu
    python -m bigdl_tpu_torch.serving.api_server --model DIR
"""

from __future__ import annotations

import argparse
import json
import select
import socket
import sys
import threading
import time
import traceback
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, List, Optional

from bigdl_tpu_torch.serving.engine import (EngineConfig, LLMEngine,
                                            SamplingParams)


def _socket_disconnected(sock) -> bool:
    """True when the client has closed its end (a readable socket whose
    MSG_PEEK reads EOF). Cancels non-streaming requests; the streaming
    path also learns it from a failed write."""
    try:
        r, _, _ = select.select([sock], [], [], 0)
        if not r:
            return False
        return sock.recv(1, socket.MSG_PEEK | socket.MSG_DONTWAIT) == b""
    except (BlockingIOError, InterruptedError):
        return False
    except OSError:
        return True


class _EngineLoop:
    """Background thread driving ``engine.step()``: the only thread that
    steps the engine, so every device call (and the kernels' scratch
    buffers) stays on it. A step that raises is counted in ``errors``
    (its traceback printed to stderr, the last kept in ``last_error``)
    and the loop goes on."""

    def __init__(self, engine: LLMEngine):
        self.engine = engine
        self.errors = 0
        self.last_error: Optional[str] = None
        self._wake = threading.Event()
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self):
        while not self._stop:
            try:
                did = self.engine.step()
            except Exception:   # a dead loop thread would hang every client
                self.errors += 1
                self.last_error = traceback.format_exc()
                print(self.last_error, file=sys.stderr, flush=True)
                did = False
            if not did:
                self._wake.wait(timeout=0.01)
                self._wake.clear()

    def notify(self):
        self._wake.set()

    def stop(self):
        self._stop = True
        self._wake.set()
        self._thread.join(timeout=10)


def _chat_to_prompt(messages: List[dict], tokenizer) -> Any:
    if tokenizer is not None and hasattr(tokenizer, "apply_chat_template"):
        try:
            return tokenizer.apply_chat_template(
                messages, tokenize=True, add_generation_prompt=True)
        except Exception:
            pass
    text = ""
    for m in messages:
        text += f"{m.get('role', 'user')}: {m.get('content', '')}\n"
    text += "assistant:"
    return text


class _IncrementalDetok:
    """Incremental detokenization: each delta comes from a sliding token
    window (``decode(ids[prefix:])`` minus ``decode(ids[prefix:read])``),
    so the stream is append-only even where a full re-decode would rewrite
    earlier text, and the work is linear in the generation's length."""

    def __init__(self, decode_fn):
        self._decode = decode_fn
        self.ids: list = []
        self.text = ""       # stable decoded text (what the stop scan sees)
        self._prefix = 0     # window start (token index)
        self._read = 0       # tokens already folded into .text

    def push(self, new_ids) -> str:
        self.ids.extend(new_ids)
        prefix_text = self._decode(self.ids[self._prefix:self._read])
        new_text = self._decode(self.ids[self._prefix:])
        if new_text.endswith("�"):
            return ""        # incomplete multi-byte char: hold the tail
        if len(new_text) <= len(prefix_text):
            return ""        # window shrank (cleanup): wait for more
        delta = new_text[len(prefix_text):]
        self._prefix = self._read
        self._read = len(self.ids)
        self.text += delta
        return delta

    def flush(self) -> str:
        """Final drain: emit the held-back tail even if it ends in U+FFFD,
        so the streamed text equals the non-streaming response."""
        prefix_text = self._decode(self.ids[self._prefix:self._read])
        new_text = self._decode(self.ids[self._prefix:])
        delta = new_text[len(prefix_text):]
        self._prefix = self._read = len(self.ids)
        self.text += delta
        return delta


class OpenAIServer:
    def __init__(self, engine: LLMEngine, tokenizer=None,
                 model_name: str = "bigdl-tpu-model",
                 wedge_sec: float = 10.0):
        self.engine = engine
        self.tokenizer = tokenizer
        self.model_name = model_name
        # /health: with unfinished work and no step() entered for this
        # long, the step loop is wedged and the replica answers 503
        self.wedge_sec = wedge_sec
        # client-disconnect cancellations by path: the streaming leg
        # learns of a dead client from a failed SSE write or the poll,
        # the non-streaming leg from the MSG_PEEK poll
        self._cancelled = engine.registry.counter(
            "bigdl_tpu_requests_cancelled_total",
            "requests aborted because the client disconnected",
            ["path"])
        self.loop = _EngineLoop(engine)
        self._httpd: Optional[ThreadingHTTPServer] = None

    # -- request handling ---------------------------------------------------

    def _encode(self, prompt) -> List[int]:
        if isinstance(prompt, list) and prompt and isinstance(prompt[0], int):
            return list(prompt)
        if self.tokenizer is None:
            raise ValueError("string prompts need a tokenizer; pass token "
                             "ids or construct the server with one")
        return list(self.tokenizer(prompt)["input_ids"])

    def _decode_text(self, ids: List[int]) -> str:
        if self.tokenizer is None:
            # space-joined, not JSON: streaming diffs the accumulated
            # decode, so the text must be append-only as ids grow
            return " ".join(str(i) for i in ids)
        return self.tokenizer.decode(ids, skip_special_tokens=True)

    def _params(self, body: dict) -> SamplingParams:
        lp = body.get("logprobs")
        if lp is True:                      # chat-style boolean form
            lp = int(body.get("top_logprobs", 0))
        return SamplingParams(
            max_tokens=int(body.get("max_tokens", 128)),
            temperature=float(body.get("temperature", 0.0)),
            top_k=int(body.get("top_k", 0)),
            top_p=float(body.get("top_p", 1.0)),
            repetition_penalty=float(body.get("repetition_penalty", 1.0)),
            presence_penalty=float(body.get("presence_penalty", 0.0)),
            frequency_penalty=float(body.get("frequency_penalty", 0.0)),
            n=int(body.get("n", 1)),
            best_of=(int(body["best_of"]) if body.get("best_of")
                     else None),
            logprobs=(int(lp) if lp is not None and lp is not False
                      else None),
            seed=(int(body["seed"]) if body.get("seed") is not None
                  else None),
            ignore_eos=bool(body.get("ignore_eos", False)),
        )

    def _run_request(self, token_ids, params, stream_cb=None,
                     stop_strs=(), disconnect_check=None,
                     cancel_cb=None, rid=None):
        """Returns (rid, {index: ids}, {index: logprob entries},
        {index: finish_reason}, {index: final text}, {index: error}).

        ``stream_cb(text_delta, index)`` when set: deltas of the
        incremental decode, held back by len(longest stop) - 1 chars so a
        stop string never leaks into the stream. ``stop_strs`` cut the
        output at the first match; when every choice has stopped the
        request is aborted. ``disconnect_check()`` is polled while
        waiting; when it reports the client gone, or a streaming write
        fails, the request is aborted and ``cancel_cb()`` fires once. With
        `rid` the request was already added to the engine."""
        if rid is None:
            rid = f"cmpl-{uuid.uuid4().hex[:16]}"
            self.engine.add_request(rid, token_ids, params)
            self.loop.notify()
        out_ids: dict = {}
        out_lps: dict = {}
        reasons: dict = {}
        errors: dict = {}     # index -> the engine's error dict
        texts: dict = {}      # index -> full decoded (possibly cut) text
        emitted: dict = {}    # index -> chars already streamed
        scanned: dict = {}    # index -> chars already stop-scanned
        detoks: dict = {}     # index -> _IncrementalDetok
        stopped: set = set()
        hold = max((len(s) for s in stop_strs), default=0)
        n_choices = max(params.n, 1)
        # streaming and stop scanning share one incremental detokenizer a
        # choice; a plain request decodes once at the end
        live_decode = bool(stop_strs) or stream_cb is not None
        cancelled = [False]

        def cancel_once():
            if not cancelled[0]:
                cancelled[0] = True
                if cancel_cb is not None:
                    try:
                        cancel_cb()
                    except Exception:
                        pass         # accounting must not alter the abort

        def emit(idx, upto):
            nonlocal stream_cb
            if stream_cb is None:
                return
            full = texts[idx]
            start = emitted.get(idx, 0)
            upto = min(upto, len(full))
            if upto > start:
                try:
                    stream_cb(full[start:upto], idx)
                    emitted[idx] = upto
                except OSError:
                    # client gone mid-stream: free the slot, then drain
                    # until the engine emits the abort finish
                    cancel_once()
                    self.engine.abort_request(rid)
                    self.loop.notify()
                    stream_cb = None

        def scan_stop(idx):
            """The earliest stop string in the unseen tail of the stable
            text: its cut position, or -1."""
            full = texts[idx]
            scan0 = max(0, scanned.get(idx, 0) - max(hold - 1, 0))
            cut = -1
            for s in stop_strs:
                p = full.find(s, scan0)
                if p != -1 and (cut == -1 or p < cut):
                    cut = p
            scanned[idx] = len(full)
            return cut

        def apply_stop(idx, cut, batch_len):
            texts[idx] = texts[idx][:cut]
            stopped.add(idx)
            reasons[idx] = "stop"
            emit(idx, cut)
            # drop the tokens whose text fell past the cut (usage bills
            # the visible completion): walk back this batch's tokens while
            # the stop still matches without them
            ids = out_ids[idx]
            keep = len(ids)
            lo = keep - batch_len
            while keep > lo:
                shorter = self._decode_text(ids[:keep - 1])
                if any(s in shorter for s in stop_strs):
                    keep -= 1
                else:
                    break
            del ids[keep:]
            if idx in out_lps:
                del out_lps[idx][keep:]
            if stopped >= set(range(n_choices)):
                self.engine.abort_request(rid)     # every choice done
                self.loop.notify()

        done = False
        aborted = False
        next_conn_check = time.time() + 0.25
        while not done:
            if disconnect_check is not None and not aborted \
                    and time.time() >= next_conn_check:
                next_conn_check = time.time() + 0.25
                try:
                    gone = disconnect_check()
                except Exception:
                    gone = True
                if gone:
                    aborted = True
                    cancel_once()
                    self.engine.abort_request(rid)
                    self.loop.notify()
            outs = self.engine.get_outputs(rid)
            if not outs:
                time.sleep(0.002)
                continue
            for o in outs:
                idx = o.index
                if idx not in stopped:
                    # a stopped choice freezes: ids past the stop would
                    # inflate usage and desync from the cut text
                    out_ids.setdefault(idx, []).extend(o.new_token_ids)
                    if o.logprobs:
                        out_lps.setdefault(idx, []).extend(o.logprobs)
                if live_decode and o.new_token_ids and idx not in stopped:
                    det = detoks.get(idx)
                    if det is None:
                        det = detoks[idx] = _IncrementalDetok(
                            self._decode_text)
                    det.push(o.new_token_ids)
                    texts[idx] = det.text
                    cut = scan_stop(idx) if stop_strs else -1
                    if cut != -1:
                        apply_stop(idx, cut, len(o.new_token_ids))
                    else:
                        emit(idx, len(det.text) - hold + 1
                             if hold else len(det.text))
                if o.finish_reason is not None:
                    reasons.setdefault(idx, o.finish_reason)
                if o.error is not None:
                    errors.setdefault(idx, o.error)
                if o.finished:
                    reasons.setdefault(idx, o.finish_reason or "stop")
                    done = True
        for idx, det in detoks.items():
            if idx in stopped:
                continue
            det.flush()                      # drain the held-back tail
            texts[idx] = det.text
            cut = scan_stop(idx) if stop_strs else -1
            if cut != -1:
                apply_stop(idx, cut, len(det.ids))
        for idx in list(texts):
            emit(idx, len(texts[idx]))       # flush the holdback
        for i in range(n_choices):
            out_ids.setdefault(i, [])
            texts.setdefault(i, self._decode_text(out_ids[i]))
            reasons.setdefault(i, reasons.get(0, "stop"))
        # the fan-out closer carries no tokens under its own index; drop
        # any empty phantom choice beyond n
        out_ids = {i: v for i, v in out_ids.items() if i < n_choices}
        texts = {i: v for i, v in texts.items() if i < n_choices}
        return rid, out_ids, out_lps, reasons, texts, errors

    # -- http ---------------------------------------------------------------

    def make_handler(server):
        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):   # quiet
                pass

            def _json(self, code: int, obj: dict):
                body = json.dumps(obj).encode()
                try:
                    self.send_response(code)
                    self.send_header("Content-Type", "application/json")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except OSError:
                    pass    # the client left (a cancelled request)

            def do_GET(self):
                if self.path == "/v1/models":
                    self._json(200, {"object": "list", "data": [
                        {"id": server.model_name, "object": "model"}]})
                elif self.path in ("/health", "/ping"):
                    # the process answering HTTP proves nothing about the
                    # engine thread: work pending and a stale heartbeat
                    # mean the step loop is wedged
                    age = server.engine.step_heartbeat_age()
                    if server.engine.has_unfinished() \
                            and age > server.wedge_sec:
                        self._json(503, {"status": "wedged",
                                         "heartbeat_age_sec":
                                         round(age, 3)})
                    else:
                        self._json(200, {"status": "ok"})
                elif self.path == "/metrics":
                    body = server.engine.registry.render().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type",
                        "text/plain; version=0.0.4; charset=utf-8")
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                elif self.path == "/v1/stats":
                    snap = server.engine.stats_snapshot()
                    snap["loop_errors"] = server.loop.errors
                    self._json(200, snap)
                else:
                    self._json(404, {"error": "not found"})

            def do_POST(self):
                n = int(self.headers.get("Content-Length", 0))
                raw = self.rfile.read(n) if n else b"{}"
                try:
                    body = json.loads(raw or b"{}")
                except json.JSONDecodeError:
                    return self._json(400, {"error": "bad json"})
                try:
                    if self.path == "/v1/completions":
                        return self._completions(body, chat=False)
                    if self.path == "/v1/chat/completions":
                        return self._completions(body, chat=True)
                except ValueError as e:
                    return self._json(400, {"error": str(e)})
                self._json(404, {"error": "not found"})

            def _completions(self, body: dict, chat: bool):
                if chat:
                    prompt = _chat_to_prompt(body.get("messages", []),
                                             server.tokenizer)
                else:
                    prompt = body.get("prompt", "")
                ids = server._encode(prompt)
                params = server._params(body)
                stops = body.get("stop") or ()
                if isinstance(stops, str):
                    stops = (stops,)
                stops = tuple(s for s in stops if s)
                created = int(time.time())
                # add before the stream branch commits its 200 header, so
                # a refused request is a clean 400
                rid = f"cmpl-{uuid.uuid4().hex[:16]}"
                server.engine.add_request(rid, ids, params)
                server.loop.notify()

                if body.get("stream"):
                    self.send_response(200)
                    self.send_header("Content-Type", "text/event-stream")
                    self.send_header("Cache-Control", "no-cache")
                    self.end_headers()

                    def cb(text, index):
                        delta = ({"role": "assistant", "content": text}
                                 if chat else None)
                        chunk = {
                            "id": "chunk", "object":
                                ("chat.completion.chunk" if chat
                                 else "text_completion"),
                            "created": created, "model": server.model_name,
                            "choices": [{
                                "index": index,
                                **({"delta": delta} if chat
                                   else {"text": text}),
                                "finish_reason": None}],
                        }
                        self.wfile.write(
                            b"data: " + json.dumps(chunk).encode() + b"\n\n")
                        self.wfile.flush()

                    server._run_request(
                        ids, params, stream_cb=cb, stop_strs=stops,
                        disconnect_check=lambda:
                            _socket_disconnected(self.connection),
                        cancel_cb=lambda: server._cancelled.labels(
                            "stream").inc(),
                        rid=rid)
                    try:
                        self.wfile.write(b"data: [DONE]\n\n")
                        self.wfile.flush()
                    except OSError:
                        pass    # client left after the last delta
                    return

                rid, out_ids, out_lps, reasons, texts, errors = \
                    server._run_request(
                        ids, params, stop_strs=stops,
                        disconnect_check=lambda: _socket_disconnected(
                            self.connection),
                        cancel_cb=lambda: server._cancelled.labels(
                            "nonstream").inc(),
                        rid=rid)
                if any(r == "error" for r in reasons.values()):
                    # a quarantined request is a server error with the
                    # engine's structured diagnosis
                    detail = next(iter(errors.values()), {})
                    return self._json(500, {"error": {
                        "message": "request failed in the engine",
                        "type": "engine_error", "code": 500,
                        "id": rid, **detail}})
                choices = []
                total_completion = 0
                for idx in sorted(out_ids):
                    toks = out_ids[idx]
                    total_completion += len(toks)
                    text = texts.get(idx, server._decode_text(toks))
                    choice = ({"index": idx, "message":
                               {"role": "assistant", "content": text},
                               "finish_reason": reasons.get(idx, "stop")}
                              if chat else
                              {"index": idx, "text": text,
                               "finish_reason": reasons.get(idx, "stop")})
                    lps = out_lps.get(idx)
                    if lps is not None and params.logprobs is not None:
                        # OpenAI completions logprobs block (token-id
                        # keyed when no tokenizer is attached)
                        def tname(t):
                            return (server._decode_text([t])
                                    if server.tokenizer else str(t))
                        choice["logprobs"] = {
                            "tokens": [tname(e.token_id) for e in lps],
                            "token_logprobs": [e.logprob for e in lps],
                            "top_logprobs": [
                                {tname(t): lp for t, lp in e.top}
                                for e in lps],
                        }
                    choices.append(choice)
                self._json(200, {
                    "id": rid,
                    "object": "chat.completion" if chat
                    else "text_completion",
                    "created": created,
                    "model": server.model_name,
                    "choices": choices,
                    "usage": {
                        "prompt_tokens": len(ids),
                        "completion_tokens": total_completion,
                        "total_tokens": len(ids) + total_completion},
                })

        return Handler

    def serve(self, host: str = "127.0.0.1", port: int = 8000,
              background: bool = False) -> ThreadingHTTPServer:
        self._httpd = ThreadingHTTPServer((host, port), self.make_handler())
        if background:
            threading.Thread(target=self._httpd.serve_forever,
                             daemon=True).start()
        else:
            self._httpd.serve_forever()
        return self._httpd

    def shutdown(self):
        if self._httpd is not None:
            self._httpd.shutdown()
            self._httpd.server_close()
        self.loop.stop()


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m bigdl_tpu_torch.serving.api_server",
        description="OpenAI-compatible server over the port's engine")
    ap.add_argument("--model", default=None,
                    help="HF checkpoint or save_low_bit directory")
    ap.add_argument("--load-in-low-bit", default="sym_int4")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8000)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=2048)
    ap.add_argument("--tiny-random", action="store_true",
                    help="serve a seeded tiny random llama instead of a "
                         "checkpoint")
    ap.add_argument("--tiny-seed", type=int, default=0)
    ap.add_argument("--wedge-sec", type=float, default=10.0,
                    help="/health reports wedged past this step-loop "
                         "heartbeat age with work pending")
    ap.add_argument("--kv-page-size", type=int, default=None,
                    help="positions per KV page (power of two; 0 = "
                         "per-slot slab; default "
                         "$BIGDL_TPU_TORCH_KV_PAGE_SIZE or slab)")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="paged-KV arena size in pages (0 = auto-size "
                         "to max_batch*max_seq; default "
                         "$BIGDL_TPU_TORCH_KV_PAGES)")
    ap.add_argument("--prefix-sharing", default=None,
                    choices=["auto", "on", "off"],
                    help="radix-tree prompt-prefix page sharing for the "
                         "paged KV cache (default "
                         "$BIGDL_TPU_TORCH_PREFIX_SHARING or auto)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the weights and the KV cache")
    return ap


def _load_tokenizer(path: str):
    """The checkpoint's tokenizer where ``transformers`` imports and the
    directory holds one; None otherwise."""
    try:
        from transformers import AutoTokenizer
    except Exception:
        return None
    try:
        return AutoTokenizer.from_pretrained(path)
    except Exception:
        return None


def build_server(args: argparse.Namespace) -> OpenAIServer:
    """The model, engine and server that ``main`` serves."""
    tokenizer = None
    if args.tiny_random:
        from bigdl_tpu_torch.utils.testing import tiny_random_model

        model = tiny_random_model(seed=args.tiny_seed, device=args.device)
        # the synthetic config's rope table caps the usable context
        args.max_seq = min(args.max_seq,
                           model.config.max_position_embeddings)
    else:
        if not args.model:
            raise ValueError("--model is required (or pass --tiny-random)")
        from bigdl_tpu_torch.transformers.model import AutoModelForCausalLM

        model = AutoModelForCausalLM.from_pretrained(
            args.model, load_in_low_bit=args.load_in_low_bit,
            max_seq=args.max_seq, device=args.device)
        tokenizer = _load_tokenizer(args.model)
    if tokenizer is None:
        print("no tokenizer: prompts are token-id lists and completions "
              "are space-joined ids", file=sys.stderr, flush=True)
    engine = LLMEngine(model, EngineConfig(
        max_batch=args.max_batch, max_seq=args.max_seq,
        kv_page_size=args.kv_page_size, kv_pages=args.kv_pages,
        prefix_sharing=args.prefix_sharing), device=args.device)
    return OpenAIServer(engine, tokenizer, wedge_sec=args.wedge_sec)


def main(argv: Optional[List[str]] = None) -> None:
    ap = build_parser()
    args = ap.parse_args(argv)
    try:
        server = build_server(args)
    except ValueError as e:
        ap.error(str(e))
    print(f"serving on http://{args.host}:{args.port}/v1", flush=True)
    try:
        server.serve(args.host, args.port)
    finally:
        server.loop.stop()


if __name__ == "__main__":
    main()
