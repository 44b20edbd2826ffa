"""Per-request lifecycle tracing for the serving path (a copy of
``RequestSpan`` / ``RequestTracer`` from ``bigdl_tpu/observability/
tracing.py``; the port imports nothing of the JAX package).

Each request the engine touches gets a ``RequestSpan`` recording the
timestamps the serving metrics are computed from:

    t_enqueued  -> t_admitted          queue wait
                   (bigdl_tpu_request_phase_seconds{phase="queue"})
    t_admitted  -> t_first_token       prefill latency ({phase="prefill"})
    t_arrival   -> t_first_token       TTFT (bigdl_tpu_ttft_seconds)
    t_first_token -> t_finished        decode phase ({phase="decode"})

plus discrete events (``enqueue``, ``admit``, ``first_token``,
``preempt``, ``finish``) with their own timestamps. Spans live in the
tracer's in-memory ring buffer, which ``GET /v1/stats`` serves. The JAX
tracer's JSONL event-log sink (and its rotation) and the distributed-trace
fields are not ported: nothing in the port writes or reads them.

Stdlib-only by design (see observability/metrics.py).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Dict, List, Optional, Tuple


@dataclasses.dataclass
class RequestSpan:
    """Lifecycle timestamps for one engine-level request (n/best_of
    fan-out children are separate sequences and get separate spans)."""
    request_id: str
    prompt_len: int = 0
    t_arrival: float = 0.0
    t_enqueued: float = 0.0          # re-set on preemption (re-queue)
    t_admitted: Optional[float] = None
    t_first_token: Optional[float] = None
    t_finished: Optional[float] = None
    finish_reason: Optional[str] = None
    n_generated: int = 0
    n_preemptions: int = 0
    events: List[Tuple[float, str]] = dataclasses.field(
        default_factory=list)

    # -- derived durations (None until the span reaches that point) --------

    @property
    def queue_wait_s(self) -> Optional[float]:
        if self.t_admitted is None:
            return None
        return self.t_admitted - self.t_enqueued

    @property
    def prefill_s(self) -> Optional[float]:
        if self.t_admitted is None or self.t_first_token is None:
            return None
        return self.t_first_token - self.t_admitted

    @property
    def ttft_s(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.t_arrival

    @property
    def decode_s(self) -> Optional[float]:
        if self.t_first_token is None or self.t_finished is None:
            return None
        return self.t_finished - self.t_first_token

    @property
    def tpot_s(self) -> Optional[float]:
        d = self.decode_s
        if d is None or self.n_generated <= 1:
            return None
        return d / (self.n_generated - 1)

    def to_dict(self) -> dict:
        out = {
            "request_id": self.request_id,
            "prompt_len": self.prompt_len,
            "t_arrival": self.t_arrival,
            "n_generated": self.n_generated,
            "n_preemptions": self.n_preemptions,
            "finish_reason": self.finish_reason,
        }
        for k in ("queue_wait_s", "prefill_s", "ttft_s", "decode_s",
                  "tpot_s"):
            v = getattr(self, k)
            if v is not None:
                out[k] = round(v, 6)
        out["events"] = [(round(t, 6), kind) for t, kind in self.events]
        return out


class RequestTracer:
    """Thread-safe span store: active spans by request id plus a ring
    buffer of finished spans."""

    def __init__(self, capacity: int = 256):
        self._lock = threading.Lock()
        self._active: Dict[str, RequestSpan] = {}
        self._finished: "collections.deque[RequestSpan]" = \
            collections.deque(maxlen=capacity)

    # -- lifecycle ----------------------------------------------------------

    def start(self, request_id: str, prompt_len: int = 0,
              t_arrival: Optional[float] = None) -> RequestSpan:
        now = time.time()
        span = RequestSpan(request_id, prompt_len,
                           t_arrival=t_arrival or now,
                           t_enqueued=t_arrival or now)
        span.events.append((span.t_arrival, "enqueue"))
        with self._lock:
            self._active[request_id] = span
        return span

    def get(self, request_id: str) -> Optional[RequestSpan]:
        with self._lock:
            return self._active.get(request_id)

    def admitted(self, request_id: str) -> Optional[RequestSpan]:
        now = time.time()
        span = self.get(request_id)
        if span is not None:
            span.t_admitted = now
            span.events.append((now, "admit"))
        return span

    def first_token(self, request_id: str) -> Optional[RequestSpan]:
        now = time.time()
        span = self.get(request_id)
        if span is not None and span.t_first_token is None:
            span.t_first_token = now
            span.events.append((now, "first_token"))
        return span

    def preempted(self, request_id: str) -> Optional[RequestSpan]:
        """Victim evicted back to the queue: the next admit's queue wait
        counts from NOW, not from arrival."""
        now = time.time()
        span = self.get(request_id)
        if span is not None:
            span.n_preemptions += 1
            span.t_enqueued = now
            span.t_admitted = None
            span.events.append((now, "preempt"))
        return span

    def finish(self, request_id: str, reason: str,
               n_generated: int = 0) -> Optional[RequestSpan]:
        now = time.time()
        with self._lock:
            span = self._active.pop(request_id, None)
        if span is not None:
            span.t_finished = now
            span.finish_reason = reason
            span.n_generated = n_generated
            span.events.append((now, "finish"))
            with self._lock:
                self._finished.append(span)
        return span

    # -- introspection ------------------------------------------------------

    def snapshot(self, recent: int = 32) -> dict:
        with self._lock:
            active = [s.to_dict() for s in self._active.values()]
            done = [s.to_dict() for s in
                    list(self._finished)[-max(recent, 0):]]
        return {"active": active, "recent": done}
