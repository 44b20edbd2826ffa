"""Continuous-batching serving engine, port of
``bigdl_tpu/serving/engine.py::LLMEngine`` (slab and paged KV modes, every
KV storage kind).

Kept: the public surface of ``SamplingParams`` (max_tokens, temperature,
top_k, top_p, stop_token_ids, ignore_eos, the repetition / presence /
frequency penalties, n, best_of, logprobs, seed), ``LogprobEntry``,
``RequestOutput`` (with its choice index, logprobs and error) and
``EngineConfig`` (max_batch, max_seq, prefill_bucket, prefill_chunk,
preempt_after_steps, kv_page_size, kv_pages, prefix_sharing,
kv_cache_dtype, kv_quantized), and ``add_request`` / ``abort_request`` /
``step`` / ``get_outputs`` / ``has_unfinished`` / ``step_heartbeat_age`` /
``stats_snapshot`` / ``generate`` / ``reset_prefix_cache``. Inside:

- KV storage (``kv_cache_dtype``): bf16, fp8_e5m2, or int8 / int4 codes
  with f32 scale planes that move wherever their codes move (splice,
  prefix seeding, copy-on-write); int8/int4 need a family with
  ``SUPPORTS_SCALED_KV``;
- slab mode: one batched KV cache [L, max_batch, max_seq, Hkv, hd] with a
  per-slot position vector; a slot is a sequence's home until it finishes
  or is preempted;
- paged mode (``kv_page_size`` > 0): one [L, P, page_size, Hkv, hd] arena
  per K/V plane, host block tables [max_batch, max_seq / page_size] with
  a device mirror refreshed only when a row changed, a refcounted page
  pool, and (``prefix_sharing`` on or auto) a radix tree that shares
  full-page prompt prefixes copy-on-write across requests;
- FCFS admission with chunked prefill into a private 1-row slab cache (at
  most one chunk per step, so a long prompt cannot stall running
  streams), spliced into the batched cache or the arena when the prompt
  is done; a paged admission first takes every page the sequence can
  ever need (all or nothing) and seeds its prefix from shared pages;
- one batched decode over all slots per step (idle slots decode garbage
  that is never read, as in the reference);
- two samplers, split per slot as the JAX engine splits them. A slot with
  no penalties and no logprobs is "simple": the batched device sampler
  (greedy argmax, or temperature / top-k / top-p by gumbel-max with noise
  from ``fold_in(PRNGKey(seed), position)``, the JAX engine's threefry
  stream, ``ops/random.py``) serves it. The other slots' logits rows come
  to the host in one copy a step and go through the JAX engine's numpy
  sampler (penalties over prompt and output counts, the log-softmax
  before temperature, top-k / top-p, ``default_rng((seed, position))``
  for seeded rows and one persistent generator for the others);
- n / best_of fan-out into child sequences ``rid#i`` (seed + i), ranked by
  mean logprob when best_of > n; aborts of queued, admitting, decoding
  and fanned-out requests; the stall guard's preemption by recompute (the
  latest-arrived slot goes back to the queue, its tokens become prompt);
- the resident decode step (``decode_resident``, the JAX engine's one
  dispatch a step): when ``BIGDL_TPU_TORCH_DECODE_RESIDENT`` is not
  ``off``, the engine is not paged and every active slot is simple, the
  forward, the health check and the sampler run as one function over
  static [max_batch] buffers, captured as a CUDA graph on the card (one
  a sampler kind: all greedy or not) and replayed each such step, with
  the step's inputs copied in (one copy when every row is greedy, three
  when one samples) and one device-to-host copy of its tokens and health
  bits; on the CPU the same function runs eagerly. Other steps run the
  eager step;
- the per-step logits health check (``logits_health_check``): a decode
  row whose logits are not all finite quarantines its slot before the
  step emits anything; the request finishes with reason "error" and the
  JAX engine's ``error`` dict, counted in
  ``bigdl_tpu_requests_quarantined_total{reason}``;
- the JAX engine's serving metrics (``observability/metrics.py``) and
  request spans (``observability/tracing.py``). ``get_outputs`` and the
  queue are guarded by one lock: HTTP threads read outputs and add
  requests while one thread steps the engine.

Not ported yet: deadlines and overload control (``max_time_ms``, QoS,
tenants), the host prefix cache, fault handling (retries, crash-loop
quarantine, the flight recorder and postmortems), migration and the rest
of observability.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.config import (flags, resolve_kv_page_size,
                                    resolve_kv_pages, resolve_prefix_sharing)
from bigdl_tpu_torch.cuda_graph import GraphPool, StepGraph
from bigdl_tpu_torch.observability.metrics import (MetricsRegistry,
                                                   default_registry)
from bigdl_tpu_torch.observability.tracing import RequestTracer
from bigdl_tpu_torch.ops import random as rnd
from bigdl_tpu_torch.ops.kvcache import (SCALED_KV_DTYPES, KVCache,
                                         raw_view, resolve_kv_cache_dtype)
from bigdl_tpu_torch.ops.paged import (NULL_PAGE, cow_copy_pages,
                                       gather_pages_dense, paged_cache_bytes)
from bigdl_tpu_torch.serving.pagepool import PagePool, RadixCache


@dataclasses.dataclass
class SamplingParams:
    max_tokens: int = 128
    temperature: float = 0.0       # 0 = greedy
    top_k: int = 0
    top_p: float = 1.0
    stop_token_ids: Tuple[int, ...] = ()
    ignore_eos: bool = False
    # llama.cpp-form repetition penalty + OpenAI-form count penalties;
    # 1.0 / 0.0 = off
    repetition_penalty: float = 1.0
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    # parallel sampling: best_of sequences (default n), the n best by mean
    # logprob returned; n > 1 streams with choice indices, best_of > n
    # buffers until every candidate finishes
    n: int = 1
    best_of: Optional[int] = None
    # per-token logprobs: 0 = the chosen token's only, k > 0 also the top-k
    # alternatives a step; None = off
    logprobs: Optional[int] = None
    seed: Optional[int] = None

    @property
    def needs_counts(self) -> bool:
        return (self.repetition_penalty != 1.0
                or self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0)


@dataclasses.dataclass
class Request:
    request_id: str
    prompt_token_ids: List[int]
    params: SamplingParams
    arrival: float = dataclasses.field(default_factory=time.time)
    # preempt-resume: tokens already generated (and streamed) before this
    # re-admission; they are part of prompt_token_ids now and count
    # against max_tokens without being emitted again
    generated_offset: int = 0
    resumed_cum_logprob: float = 0.0


@dataclasses.dataclass
class LogprobEntry:
    """One emitted token's logprob record."""
    token_id: int
    logprob: float
    top: List[Tuple[int, float]] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class RequestOutput:
    request_id: str
    new_token_ids: List[int]
    finished: bool
    finish_reason: Optional[str] = None
    index: int = 0                    # choice index (n > 1 fan-out)
    logprobs: Optional[List[LogprobEntry]] = None
    # structured failure detail of a finish reason "error": the JAX
    # engine's {"reason": ..., "request_id": ...} of a quarantine
    error: Optional[dict] = None


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    max_seq: int = 2048
    prefill_bucket: int = 16       # smallest prefill width
    # a step() runs at most this many prompt tokens of prefill before the
    # batched decode (rounded down to a power of two)
    prefill_chunk: int = 256
    # stall guard: when requests have waited this many consecutive steps
    # with every slot busy, the latest-arrived running sequence is evicted
    # to the back of the queue (its tokens so far become prompt,
    # recomputed on readmission). 0 disables.
    preempt_after_steps: int = 64
    # -- paged KV (ops/paged.py + serving/pagepool.py). None defers to
    # $BIGDL_TPU_TORCH_KV_PAGE_SIZE / _KV_PAGES / _PREFIX_SHARING.
    # token positions per arena page: 0 keeps the slab; otherwise a power
    # of two dividing max_seq
    kv_page_size: Optional[int] = None
    # total arena pages; 0 sizes it to max_batch * max_seq / page_size + 1
    # (the slab's worst case plus the null page). Fewer oversubscribes:
    # admission then relies on prefix sharing deduplicating pages.
    kv_pages: Optional[int] = None
    # "auto" / "on" share full-page prompt prefixes copy-on-write across
    # requests through a radix tree; "off" keeps every page private
    prefix_sharing: Optional[str] = None
    # KV storage: "bf16", "fp8_e5m2", "int8" or "int4" (None defers to
    # kv_quantized, then to $BIGDL_TPU_TORCH_KV_CACHE_DTYPE, default bf16)
    kv_cache_dtype: Optional[str] = None
    # deprecated: True stores fp8_e5m2 where kv_cache_dtype is None or
    # "bf16" (the JAX engine's precedence); a non-bf16 kv_cache_dtype wins
    kv_quantized: bool = False
    # per-step NaN/Inf logits health check: a non-finite decode row
    # quarantines exactly that slot (reason "nan_logits") while every
    # other slot keeps decoding. Costs one [B] bool copy a decode step
    # (the resident step returns it with its tokens); False disables.
    logits_health_check: bool = True


class _Slot:
    __slots__ = ("req", "generated", "last_token", "active", "counts",
                 "counts_out", "rng", "cum_logprob", "n_logprobs",
                 "dev_seed")

    def __init__(self):
        self.req: Optional[Request] = None
        self.generated: List[int] = []
        self.last_token = 0
        self.active = False
        # [V] int32 penalty counts: `counts` over prompt + output
        # (repetition penalty), `counts_out` over output only
        # (presence / frequency)
        self.counts: Optional[np.ndarray] = None
        self.counts_out: Optional[np.ndarray] = None
        self.rng: Optional[np.random.Generator] = None
        self.cum_logprob = 0.0          # over generated tokens
        self.n_logprobs = -1            # -1: no logprobs tracked
        self.dev_seed = 0               # device sampler stream (31 bits)


@dataclasses.dataclass
class _Fanout:
    """Parent bookkeeping of n / best_of parallel sampling: child requests
    ``rid#i`` run as independent sequences; outputs route back under the
    parent id with choice indices."""
    parent_id: str
    n: int
    best_of: int
    # best_of > n: each child's stream is buffered until all finish, then
    # the n best (by mean logprob) are emitted; n == best_of streams
    buffered: Dict[int, List[RequestOutput]] = dataclasses.field(
        default_factory=dict)
    scores: Dict[int, float] = dataclasses.field(default_factory=dict)
    lengths: Dict[int, int] = dataclasses.field(default_factory=dict)
    done: int = 0


@dataclasses.dataclass
class _Admission:
    """A sequence mid-(chunked)-prefill and its private 1-row cache. In
    paged mode it also holds the radix pages seeding its prefix and its
    fresh pages (one slot reference each, taken at admission start); the
    slot's block-table row is written only at completion, so until then
    it stays all-null and other slots' decodes cannot write through it."""
    req: Request
    slot_idx: int
    consumed: int
    cache1: KVCache
    chunk: int
    shared_pages: Optional[List[int]] = None
    new_pages: Optional[List[int]] = None


def engine_kv_cache_dtype(ce: EngineConfig, default: str) -> str:
    """The KV storage an engine config asks for, with the JAX engine's
    precedence: a ``kv_cache_dtype`` other than bf16 wins; otherwise
    ``kv_quantized=True`` gives fp8_e5m2; otherwise ``kv_cache_dtype``,
    or `default` (the flag) where it is None."""
    if ce.kv_cache_dtype is not None:
        spec = resolve_kv_cache_dtype(ce.kv_cache_dtype)
        if spec != "bf16" or not ce.kv_quantized:
            return spec
    if ce.kv_quantized:
        return resolve_kv_cache_dtype(True)
    return resolve_kv_cache_dtype(default)


def sample_rows(lg: torch.Tensor, temps: torch.Tensor, top_ks: torch.Tensor,
                top_ps: torch.Tensor, seeds, poss) -> torch.Tensor:
    """Batched sampler (``_device_sample_rows``): rows with temperature
    <= 0 take the argmax of their logits; the others mask by top-k, then
    top-p on the post-top-k distribution, and draw by gumbel-max with
    noise keyed by ``fold_in(PRNGKey(seed), pos)``, one key per row, all
    rows in one pass. lg [B, V] f32; temps/top_ps f32 [B], top_ks int [B]
    on lg's device; seeds (31-bit) and poss [B] ints. Returns int64 [B]."""
    lg = lg.to(torch.float32)
    b, v = lg.shape
    greedy = temps <= 0.0
    t = lg / torch.clamp(temps, min=1e-6)[:, None]
    k = torch.where(greedy | (top_ks <= 0), torch.full_like(top_ks, v),
                    top_ks)
    sd = torch.sort(t, dim=-1, descending=True).values
    kth = torch.gather(sd, 1, torch.clamp(k - 1, 0, v - 1).long()[:, None])
    t = torch.where(t < kth, torch.full_like(t, float("-inf")), t)
    p = torch.where(greedy, torch.ones_like(top_ps), top_ps)[:, None]
    sd = torch.sort(t, dim=-1, descending=True).values
    probs = torch.softmax(sd, dim=-1)
    # keep the smallest sorted prefix whose mass reaches p; p >= 1 keeps
    # everything and the top token always survives
    keep = ((torch.cumsum(probs, dim=-1) - probs) < p) | (p >= 1.0)
    keep[:, 0] = True
    cutoff = torch.amin(torch.where(keep, sd, torch.full_like(sd,
                                                              float("inf"))),
                        dim=-1)
    t = torch.where(t < cutoff[:, None], torch.full_like(t, float("-inf")),
                    t)

    def col(x):
        return torch.as_tensor(x, dtype=torch.int64).to(lg.device).reshape(
            b, 1)

    key = rnd.fold_in(rnd.prng_key(col(seeds)), col(poss))
    z = torch.where(greedy[:, None], lg, t + rnd.gumbel(key, v))
    return torch.argmax(z, dim=-1)


def decode_resident(family, params, cfg, cache: KVCache,
                    tokens: torch.Tensor, temps: torch.Tensor,
                    top_ks: torch.Tensor, top_ps: torch.Tensor,
                    seeds: torch.Tensor, poss: torch.Tensor,
                    out: torch.Tensor, all_greedy: bool) -> None:
    """The resident decode step (``decode_resident`` of the JAX engine):
    the family's slab forward of tokens [B] at ``cache.pos``, the per-row
    health check ``isfinite(logits).all(-1)``, then the argmax
    (`all_greedy`) or ``sample_rows`` over the sampler buffers (temps /
    top_ps f32 [B], top_ks / seeds / poss int64 [B]). Writes the tokens to
    ``out[0]`` and the health bits (1 = finite) to ``out[1]`` (int64
    [2, B]) and advances ``cache.pos`` by one in place. It reads and
    writes only these tensors, so one call can be captured as a CUDA
    graph and replayed."""
    logits, _ = family.forward(params, cfg, tokens[:, None], cache)
    lg = logits[:, -1, :]
    toks = (torch.argmax(lg, dim=-1) if all_greedy
            else sample_rows(lg, temps, top_ks, top_ps, seeds, poss))
    out[0].copy_(toks)
    out[1].copy_(torch.isfinite(lg).all(dim=-1))
    cache.pos.add_(1)


class _ResidentStep:
    """The engine's resident step: its static buffers on the engine's
    device and one ``StepGraph`` a sampler kind (all greedy or not), both
    in one memory pool (they never replay at the same time). The graphs
    read the engine's weights and cache, which keep their addresses for
    the engine's life; they are dropped when the flags change, since
    those pick the kernels a step launches."""

    def __init__(self, eng: "LLMEngine"):
        b, dev = eng.cfg_engine.max_batch, eng.device
        self.eng = eng
        # tokens, top_ks, seeds, poss / temps, top_ps / tokens, finite
        self.ints = torch.zeros((4, b), dtype=torch.int64, device=dev)
        self.floats = torch.zeros((2, b), dtype=torch.float32, device=dev)
        self.out = torch.zeros((2, b), dtype=torch.int64, device=dev)
        self.pool = GraphPool(dev) if dev.type == "cuda" else None
        self.graphs: Dict[bool, StepGraph] = {}
        self._flags = None

    def graph(self, all_greedy: bool, f) -> StepGraph:
        if f != self._flags:
            self.graphs.clear()
            self._flags = f
        g = self.graphs.get(all_greedy)
        if g is None:
            eng = self.eng
            ints, fl, out = self.ints, self.floats, self.out

            def fn():
                decode_resident(eng.family, eng.params, eng.cfg, eng.cache,
                                ints[0], fl[0], ints[1], fl[1], ints[2],
                                ints[3], out, all_greedy)

            g = self.graphs[all_greedy] = StepGraph(
                "engine_decode_resident", fn, eng.device,
                keep=(ints, fl, out), pool=self.pool)
        return g

    def stats(self) -> List[dict]:
        return [dict(g.stats(), all_greedy=k)
                for k, g in self.graphs.items() if g.graph is not None]


class LLMEngine:
    """Synchronous continuous-batching engine over one model: anything
    with ``.params``, ``.config``, ``.hf_config`` and ``.family``, the
    model module whose ``check_supported`` / ``forward`` / ``new_cache``
    (and, for paged KV, ``forward_paged`` / ``new_paged_cache`` with
    ``SUPPORTS_PAGED_KV``) the engine calls. Drive it with add_request() +
    step(), or generate(). One thread steps it; others may add, abort and
    read outputs. Metrics go to `registry` (the process-wide one unless
    given), request spans to ``self.tracer``."""

    def __init__(self, model: Any, config: Optional[EngineConfig] = None,
                 device="cuda", registry: Optional[MetricsRegistry] = None):
        self.cfg_engine = ce = config or EngineConfig()
        self.params = model.params
        self.cfg = model.config
        self.device = torch.device(device)
        self.family = model.family
        self.family.check_supported(self.cfg)
        eos = (getattr(model, "hf_config", None) or {}).get("eos_token_id")
        self.eos_token_id = eos[0] if isinstance(eos, list) else eos
        # explicit EngineConfig values validate loudly here; None defers
        # to the environment (config.flags)
        env = flags()
        page_size = resolve_kv_page_size(
            ce.kv_page_size if ce.kv_page_size is not None
            else env.kv_page_size)
        n_pages = resolve_kv_pages(
            ce.kv_pages if ce.kv_pages is not None else env.kv_pages)
        sharing = resolve_prefix_sharing(
            ce.prefix_sharing if ce.prefix_sharing is not None
            else env.prefix_sharing)
        self.kv_cache_dtype = engine_kv_cache_dtype(ce, env.kv_cache_dtype)
        if (self.kv_cache_dtype in SCALED_KV_DTYPES
                and not getattr(self.family, "SUPPORTS_SCALED_KV", False)):
            raise ValueError(
                f"kv_cache_dtype={self.kv_cache_dtype!r} needs a family "
                f"that threads scale planes through its forward; "
                f"{getattr(self.family, '__name__', self.family)!r} does "
                "not (SUPPORTS_SCALED_KV)")
        self._paged = page_size > 0
        self._page_size = page_size
        self.pool: Optional[PagePool] = None
        self.radix: Optional[RadixCache] = None
        self.cow_pages_total = 0
        if self._paged:
            if not getattr(self.family, "SUPPORTS_PAGED_KV", False):
                raise ValueError(
                    f"kv_page_size={page_size} needs a family with a paged "
                    f"forward (SUPPORTS_PAGED_KV); "
                    f"{getattr(self.family, '__name__', self.family)!r} "
                    "has none")
            if ce.max_seq % page_size:
                raise ValueError(f"max_seq {ce.max_seq} must be a multiple "
                                 f"of kv_page_size {page_size}")
            self._pages_per_seq = ce.max_seq // page_size
            self._num_pages = n_pages or ce.max_batch * self._pages_per_seq + 1
            self.cache = self.family.new_paged_cache(
                self.cfg, self._num_pages, page_size, ce.max_batch,
                device=self.device, kv_cache_dtype=self.kv_cache_dtype)
            self.pool = PagePool(self._num_pages, page_size)
            if sharing != "off":
                self.radix = RadixCache(self.pool)
            # host-authoritative block tables (0 = null page); the device
            # mirror is refreshed by _bt() only after a row changed, so a
            # steady decode step copies no page state to the card
            self._bt_np = np.zeros((ce.max_batch, self._pages_per_seq),
                                   np.int32)
            self._bt_dev: Optional[torch.Tensor] = None
            self._bt_dirty = True
            self._kv_bytes_per_page = (paged_cache_bytes(self.cache)["total"]
                                       // self._num_pages)
        else:
            self.cache = self.family.new_cache(
                self.cfg, ce.max_batch, ce.max_seq, per_slot_pos=True,
                device=self.device, kv_cache_dtype=self.kv_cache_dtype)
        self.slots = [_Slot() for _ in range(ce.max_batch)]
        # admission pops the front, preemption appends to the back; HTTP
        # threads append under _lock (see add_request)
        self.waiting: "collections.deque[Request]" = collections.deque()
        self._outputs: Dict[str, List[RequestOutput]] = {}
        self._abort: set = set()
        self._lock = threading.Lock()
        # n / best_of fan-out: child request id -> (parent id, choice index)
        self._children: Dict[str, Tuple[str, int]] = {}
        self._fanouts: Dict[str, _Fanout] = {}
        self._stall_steps = 0       # consecutive steps with a starved queue
        self._step_idx = 0          # lifetime step() counter
        self._last_step_ts = time.monotonic()   # step-loop heartbeat
        # chunk width: a power of two, so chunks tile the private cache
        self._chunk = 1 << (max(1, ce.prefill_chunk).bit_length() - 1)
        self._admitting: Optional[_Admission] = None
        # the resident step's buffers and graphs, made at its first use;
        # resident_steps counts the steps it served
        self._resident: Optional[_ResidentStep] = None
        self.resident_steps = 0
        self.registry = registry if registry is not None \
            else default_registry()
        self.tracer = RequestTracer()
        self._init_metrics()

    def _init_metrics(self) -> None:
        """The JAX engine's families (names and help strings) for the
        ported subset; get-or-create, so engines can share a registry."""
        m = self.registry
        self._m_phase = m.histogram(
            "bigdl_tpu_request_phase_seconds",
            "Per-request phase latency (queue wait, prefill, decode).",
            labelnames=("phase",))
        for ph in ("queue", "prefill", "decode"):   # render from scrape 1
            self._m_phase.labels(ph)
        self._m_ttft = m.histogram(
            "bigdl_tpu_ttft_seconds",
            "Time to first token: arrival to first sampled token.")
        self._m_tpot = m.histogram(
            "bigdl_tpu_tpot_seconds",
            "Time per output token: batched decode step wall time "
            "(every active stream advances one token per step).")
        self._m_occupancy = m.gauge(
            "bigdl_tpu_slot_occupancy", "Active decode slots.")
        self._m_queue_depth = m.gauge(
            "bigdl_tpu_queue_depth",
            "Requests waiting for admission (slot + CP lanes).")
        self._m_admissions = m.counter(
            "bigdl_tpu_admissions_total",
            "Completed admissions (prefill finished, slot running).")
        self._m_preemptions = m.counter(
            "bigdl_tpu_preemptions_total",
            "Sequences evicted to the queue by the starvation guard.")
        self._m_stall_trips = m.counter(
            "bigdl_tpu_stall_guard_trips_total",
            "Times the stall guard reached preempt_after_steps.")
        self._m_finished = m.counter(
            "bigdl_tpu_requests_finished_total",
            "Finished sequences by reason.", labelnames=("reason",))
        self._m_steps = m.counter(
            "bigdl_tpu_engine_steps_total",
            "step() iterations that did work.")
        self._m_tokens = m.counter(
            "bigdl_tpu_tokens_generated_total",
            "Tokens emitted to clients.")
        self._m_quarantined = m.counter(
            "bigdl_tpu_requests_quarantined_total",
            "Requests failed by blast-radius isolation, by reason.",
            labelnames=("reason",))
        for r in ("nan_logits", "crash_loop"):   # render from scrape 1
            self._m_quarantined.labels(r)

    # -- public surface -------------------------------------------------------

    def add_request(self, request_id: str, prompt_token_ids,
                    params: Optional[SamplingParams] = None) -> None:
        params = params or SamplingParams()
        ids = list(prompt_token_ids)
        if len(ids) + 1 > self.cfg_engine.max_seq:
            raise ValueError(f"prompt length {len(ids)} exceeds engine "
                             f"max_seq {self.cfg_engine.max_seq}")
        if not ids:
            raise ValueError("empty prompt")
        # client input is validated here (HTTP clients send raw ids): a
        # float or a string is refused, never rounded or parsed into
        # another prompt; bool passes, as an int
        v = self.cfg.vocab_size
        if any(not isinstance(t, (int, np.integer)) or t < 0 or t >= v
               for t in ids):
            raise ValueError(f"prompt token ids must be ints in [0, {v})")
        if params.logprobs is not None and not 0 <= params.logprobs < v:
            raise ValueError(f"logprobs must be in [0, {v})")
        if params.n < 1:
            raise ValueError("n must be >= 1")
        if params.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        best_of = params.best_of or params.n
        if best_of < params.n:
            raise ValueError(f"best_of ({best_of}) < n ({params.n})")
        ids = [int(t) for t in ids]
        reqs = []
        if best_of > 1:
            # fan out into independent child sequences (seed + i each)
            self._fanouts[request_id] = _Fanout(request_id, params.n,
                                                best_of)
            for i in range(best_of):
                cid = f"{request_id}#{i}"
                self._children[cid] = (request_id, i)
                reqs.append(Request(cid, list(ids), dataclasses.replace(
                    params, n=1, best_of=None,
                    seed=None if params.seed is None else params.seed + i)))
        else:
            reqs.append(Request(request_id, ids, params))
        for r in reqs:
            self.tracer.start(r.request_id, prompt_len=len(ids),
                              t_arrival=r.arrival)
        with self._lock:
            self._outputs[request_id] = []
            self.waiting.extend(reqs)

    def abort_request(self, request_id: str) -> None:
        """Finish a request with reason "abort" wherever it is: queued,
        mid-admission (its pages go back to the pool), decoding, or every
        unfinished child of a fan-out. Takes effect at the next step."""
        fo = self._fanouts.get(request_id)
        if fo is not None:
            for i in range(fo.best_of):
                if i not in fo.scores:       # skip finished children
                    self._abort.add(f"{request_id}#{i}")
            return
        self._abort.add(request_id)

    def step_heartbeat_age(self) -> float:
        """Seconds since the last step() entered. A driving loop calls
        step() continuously, so a large age with unfinished work means the
        step loop is wedged (the server's /health reads it)."""
        return time.monotonic() - self._last_step_ts

    def has_unfinished(self) -> bool:
        return (len(self.waiting) > 0 or self._admitting is not None
                or any(s.active for s in self.slots))

    def reset_prefix_cache(self) -> None:
        """Drop every radix node; pages no live slot maps go free."""
        if self.radix is not None:
            self.radix.clear()

    def get_outputs(self, request_id: str) -> List[RequestOutput]:
        with self._lock:
            out = self._outputs.get(request_id, [])
            if any(o.finished for o in out):
                # request complete: drop the entry (unread finished
                # entries of aborted streams must not accumulate)
                self._outputs.pop(request_id, None)
            elif out:
                self._outputs[request_id] = []
        return out

    def stats_snapshot(self) -> dict:
        """JSON-ready engine state for ``GET /v1/stats``: occupancy, queue,
        admission and stall state, paged pool state, metric summaries and
        recent request spans. Reads host state only."""
        return {
            "slots": {"total": len(self.slots),
                      "active": sum(1 for s in self.slots if s.active)},
            "queue_depth": len(self.waiting),
            "admitting": self._admitting is not None,
            "stall_steps": self._stall_steps,
            "engine_steps": self._step_idx,
            "paged": self._paged_snapshot() if self._paged else None,
            "metrics": self.registry.summary(),
            "requests": self.tracer.snapshot(),
        }

    @torch.no_grad()
    def step(self) -> bool:
        """Apply aborts and the stall guard, advance admission by at most
        one prefill chunk, then run one batched decode step. Returns True
        if any work was done."""
        self._step_idx += 1
        self._last_step_ts = time.monotonic()
        for i, s in enumerate(self.slots):
            if s.active and s.req.request_id in self._abort:
                self._abort.discard(s.req.request_id)
                self._finish(i, "abort")
        if self._abort and self.waiting:
            self._sweep_queued_aborts()
        # stall guard: requests queued while every slot grinds a long
        # generation eventually preempt the newest running sequence
        ce = self.cfg_engine
        if (ce.preempt_after_steps > 0 and self.waiting
                and self._admitting is None
                and all(s.active for s in self.slots)):
            self._stall_steps += 1
            if self._stall_steps >= ce.preempt_after_steps:
                self._m_stall_trips.inc()
                self._preempt()
                self._stall_steps = 0
        else:
            self._stall_steps = 0

        self._admission_step()
        active = [i for i, s in enumerate(self.slots) if s.active]
        if not active:
            did = self._admitting is not None
            if did:
                self._m_steps.inc()
            self._update_gauges()
            return did
        t0 = time.perf_counter()
        # the resident step serves a step whose every active slot the
        # device sampler covers (the JAX engine's gate; a paged engine
        # keeps the eager step)
        f = flags()
        if (f.decode_resident != "off" and not self._paged
                and all(self._simple(self.slots[i]) for i in active)):
            toks, finite = self._resident_step(active, f)
            host: Dict[int, np.ndarray] = {}
        else:
            toks, finite, host = self._eager_step(active,
                                                  ce.logits_health_check)
        # per-slot logits health check: a NaN/Inf row fails ONE request
        # (quarantine, structured error) before anything of this step is
        # emitted, while the rest of the batch keeps decoding
        if ce.logits_health_check:
            sick = [i for i in active if not finite[i]]
            if sick:
                for i in sick:
                    self._quarantine_slot(i, "nan_logits")
                active = [i for i in active if i not in sick]
            if not active:
                self._m_steps.inc()
                self._update_gauges()
                return True
        for i in active:
            s = self.slots[i]
            if i in host:
                tok, lp = self._sample_host(host[i], s)
            else:
                tok, lp = toks[i], None
            s.last_token = tok
            s.generated.append(tok)
            self._emit(s, lp)
            self._check_done(i)
        self._m_tpot.observe(time.perf_counter() - t0)
        self._m_steps.inc()
        self._update_gauges()
        return True

    def resident_graph_stats(self) -> List[dict]:
        """Each resident-step graph's capture ms, pool bytes, replays and
        launches a replay (empty before the first resident step, and on
        the CPU, where no graph is made)."""
        return [] if self._resident is None else self._resident.stats()

    def generate(self, prompts: List[List[int]],
                 params: Optional[SamplingParams] = None) -> List[List[int]]:
        """Blocking batch generation; returns each prompt's new tokens."""
        ids = [f"gen-{i}" for i in range(len(prompts))]
        for rid, p in zip(ids, prompts):
            self.add_request(rid, p, params)
        done: Dict[str, List[int]] = {rid: [] for rid in ids}
        finished: set = set()
        while len(finished) < len(ids):
            self.step()
            for rid in ids:
                for out in self.get_outputs(rid):
                    done[rid].extend(out.new_token_ids)
                    if out.finished:
                        finished.add(rid)
        return [done[rid] for rid in ids]

    # -- internals ------------------------------------------------------------

    def _eager_step(self, active: List[int], check: bool
                    ) -> Tuple[List[int], Optional[List[int]],
                               Dict[int, np.ndarray]]:
        """The eager decode step: the forward, the device sampler's tokens
        for the simple slots and (`check`) the health bits, copied back
        together, and each host-sampled row's logits. Returns (tokens over
        all max_batch rows, or [] when no slot is simple; health bits or
        None; {row: f32 logits})."""
        lg = self._eager_decode(active)
        simple = [i for i in active if self._simple(self.slots[i])]
        complex_rows = [i for i in active if i not in simple]
        rows = []
        if simple and all(self.slots[i].req.params.temperature <= 0.0
                          for i in simple):
            rows.append(torch.argmax(lg, dim=-1))
        elif simple:
            # every batch holding a simple slot samples it on the device,
            # so a seeded stream does not depend on its neighbours
            rows.append(sample_rows(lg, *(t.to(self.device) for t in
                                          self._sample_params(simple))))
        if check:
            rows.append(torch.isfinite(lg).all(dim=-1).to(torch.int64))
        back = torch.stack(rows).tolist() if rows else []
        host: Dict[int, np.ndarray] = {}
        if complex_rows:
            # one copy a step for every host-sampled row
            host = dict(zip(complex_rows, lg[complex_rows].cpu().numpy()))
        return (back[0] if simple else [], back[-1] if check else None,
                host)

    def _eager_decode(self, active: List[int]) -> torch.Tensor:
        """One batched decode forward of the active slots' last tokens,
        launch by launch; returns the f32 logits [max_batch, V]. The
        cache's position vector advances in place (the resident step's
        graphs read that tensor)."""
        tokens = self._last_tokens(active).to(self.device)[:, None]
        if self._paged:
            # copy-on-write barrier first (shared write pages get private
            # copies), then one decode through the block tables
            self._cow_step(active)
            logits, _ = self.family.forward_paged(
                self.params, self.cfg, tokens, self.cache, self._bt(),
                last_only=True)
        else:
            logits, _ = self.family.forward(self.params, self.cfg, tokens,
                                            self.cache)
        self.cache.pos.add_(1)
        return logits[:, -1, :]

    def _last_tokens(self, active: List[int]) -> torch.Tensor:
        """int64 [max_batch] on the host: each active slot's last token,
        0 in the idle rows."""
        tokens = torch.zeros((self.cfg_engine.max_batch,), dtype=torch.int64)
        for i in active:
            tokens[i] = self.slots[i].last_token
        return tokens

    def _resident_step(self, active: List[int], f
                       ) -> Tuple[List[int], List[int]]:
        """The resident step over every slot under flags `f`: the step's
        inputs copied to the device (the tokens; the sampler's int and
        float rows too unless every active slot is greedy),
        ``decode_resident`` (a graph replay on the card), one copy of its
        tokens and health bits back. Returns both as lists over all
        max_batch rows."""
        if self._resident is None:
            self._resident = _ResidentStep(self)
        rs = self._resident
        all_greedy = all(self.slots[i].req.params.temperature <= 0.0
                         for i in active)
        tokens = self._last_tokens(active)
        if all_greedy:
            rs.ints[0].copy_(tokens)
        else:
            temps, top_ks, top_ps, seeds, poss = self._sample_params(active)
            rs.ints.copy_(torch.stack([tokens, top_ks, seeds, poss]))
            rs.floats.copy_(torch.stack([temps, top_ps]))
        rs.graph(all_greedy, f)()
        self.resident_steps += 1
        out = rs.out.cpu().tolist()
        return out[0], out[1]

    def _bucket(self, n: int) -> int:
        b = self.cfg_engine.prefill_bucket
        while b < n:
            b *= 2
        return min(b, self.cfg_engine.max_seq)

    def _abort_queued(self, req: Request) -> None:
        """A request aborted before its admission finished: the client is
        owed a finished output or its poll loop never ends."""
        self._abort.discard(req.request_id)
        self._push_output(req.request_id, RequestOutput(
            req.request_id, [], True, "abort"))
        self._obs_finish(req.request_id, "abort")

    def _sweep_queued_aborts(self) -> None:
        """Aborted requests leave the queue now, not when they reach its
        front."""
        with self._lock:
            gone = [r for r in self.waiting if r.request_id in self._abort]
            if gone:
                keep = [r for r in self.waiting
                        if r.request_id not in self._abort]
                self.waiting.clear()
                self.waiting.extend(keep)
        for r in gone:
            self._abort_queued(r)

    def _admission_step(self) -> None:
        a = self._admitting
        if a is None:
            free = next((i for i, s in enumerate(self.slots)
                         if not s.active), None)
            if free is None:
                return
            req = None
            while req is None and self.waiting:
                req = self.waiting.popleft()
                if req.request_id in self._abort:
                    self._abort_queued(req)
                    req = None
            if req is None:
                return
            # the private cache is a chunk multiple >= the bucket, so no
            # chunk write straddles its end; _insert clips to max_seq
            bucket = self._bucket(len(req.prompt_token_ids))
            chunk = min(self._chunk, bucket)
            alloc = -(-bucket // chunk) * chunk
            consumed, shared, new = 0, None, None
            if self._paged:
                # pages first: radix match + worst-case grab, or requeue
                adm = self._paged_admit(req, chunk)
                if adm is None:
                    return
                consumed, shared, new = adm
            cache1 = self.family.new_cache(
                self.cfg, 1, alloc, device=self.device,
                kv_cache_dtype=self.kv_cache_dtype)
            if consumed:
                self._seed_pages(cache1, shared, consumed)
            a = self._admitting = _Admission(req, free, consumed, cache1,
                                             chunk, shared, new)
            self.tracer.admitted(req.request_id)

        if a.req.request_id in self._abort:
            # aborted mid-admission: the reserved pages go back first
            self._release_admission_pages(a)
            self._admitting = None
            self._abort_queued(a.req)
            return
        plen = len(a.req.prompt_token_ids)
        part = a.req.prompt_token_ids[a.consumed:a.consumed + a.chunk]
        padded = torch.zeros((1, a.chunk), dtype=torch.int64)
        padded[0, :len(part)] = torch.tensor(part, dtype=torch.int64)
        try:
            logits, a.cache1 = self.family.forward(
                self.params, self.cfg, padded.to(self.device), a.cache1)
        except BaseException:
            # give the reserved pages back and requeue the request before
            # the failure propagates; the pool stays consistent
            self._release_admission_pages(a)
            self._admitting = None
            self.waiting.appendleft(a.req)
            raise
        start = a.consumed
        a.consumed += a.chunk
        if a.consumed < plen:
            return
        if self._paged:
            self._paged_insert(a, plen)
        else:
            self._insert(a.cache1, a.slot_idx, plen)
        s = self.slots[a.slot_idx]
        s.req = a.req
        s.generated = []
        self._setup_slot_sampler(s)
        first, lp = self._sample_admission(logits[:, plen - 1 - start], s)
        s.generated = [first]
        s.last_token = first
        s.active = True
        self._obs_admission_complete(a.req.request_id)
        self._emit(s, lp)
        self._check_done(a.slot_idx)
        self._admitting = None

    @staticmethod
    def _planes(cache) -> List[torch.Tensor]:
        """A cache's code planes and, for int8/int4, its scale planes, in
        one order (fp8 as bytes, which every indexing op takes)."""
        return [raw_view(p) for p in (cache.k, cache.v, cache.k_scale,
                                      cache.v_scale) if p is not None]

    def _insert(self, cache1: KVCache, slot: int, plen: int) -> None:
        """Splice a finished admission's K/V (and scales) into the batched
        cache."""
        n = min(cache1.k.shape[2], self.cache.k.shape[2])
        for dst, src in zip(self._planes(self.cache), self._planes(cache1)):
            dst[:, slot, :n] = src[:, 0, :n]
        self.cache.pos[slot] = plen


    # -- paged KV bookkeeping (kv_page_size > 0) ----------------------------

    def _bt(self) -> torch.Tensor:
        """Device mirror of the host block tables, refreshed only when a
        row changed."""
        if self._bt_dirty:
            self._bt_dev = torch.tensor(self._bt_np, dtype=torch.int32,
                                        device=self.device)
            self._bt_dirty = False
        return self._bt_dev

    def _paged_admit(self, req: Request, chunk: int):
        """Page-side half of admission start: radix longest-prefix match,
        then an all-or-nothing grab of every page the sequence can ever
        need (prompt + max_tokens, capped at max_seq), so decode never
        allocates and a running sequence cannot deadlock against an
        admission. Returns ``(consumed, shared_pages, new_pages)``, or None
        after requeueing the request (pool exhausted even after evicting
        idle radix leaves)."""
        ce = self.cfg_engine
        prompt = req.prompt_token_ids
        plen = len(prompt)
        ps = self._page_size
        consumed = 0
        shared: List[int] = []
        if self.radix is not None:
            matched, pages = self.radix.match(prompt)
            # the seeded length stays aligned to both the prefill chunk
            # and the page size (powers of two: lcm == max), and the last
            # prompt token must run to produce logits
            align = max(chunk, ps)
            consumed = min(matched, plen - 1)
            consumed -= consumed % align
            shared = pages[:consumed // ps]
        want = min(plen + req.params.max_tokens, ce.max_seq)
        n_new = -(-want // ps) - len(shared)
        new = self.pool.alloc(n_new)
        if new is None and self.radix is not None:
            # reclaim idle radix leaves (LRU first; a page a live slot
            # maps is never a candidate) and retry once
            self.radix.evict(n_new - self.pool.num_free)
            new = self.pool.alloc(n_new)
        if new is None:
            self.waiting.appendleft(req)
            return None
        for p in shared:
            self.pool.incref(p)          # the slot's own reference
        return consumed, shared, new

    def _seed_pages(self, cache1: KVCache, pages: List[int],
                    consumed: int) -> None:
        """Copy the shared prefix pages into positions [0, consumed) of a
        fresh private cache, which then prefills from `consumed`."""
        c = self.cache
        dense = gather_pages_dense(
            c.k, c.v, torch.tensor(pages, dtype=torch.int64,
                                   device=self.device),
            c.k_scale, c.v_scale)
        for dst, src in zip(self._planes(cache1), dense):
            dst[:, :, :consumed] = raw_view(src)
        cache1.pos.fill_(consumed)

    def _paged_insert(self, a: _Admission, plen: int) -> None:
        """Completion half of a paged admission: write the slot's block
        table row (shared prefix pages first, then the private pages),
        scatter the private cache's rows into their pages, and publish the
        prompt's pages, its partial tail page included (the future
        copy-on-write target), to the radix tree."""
        idx = a.slot_idx
        ps = self._page_size
        shared = a.shared_pages or []
        row = list(shared) + list(a.new_pages or [])
        self._bt_np[idx, :] = NULL_PAGE
        self._bt_np[idx, :len(row)] = row
        self._bt_dirty = True
        # positions already resident in shared pages are not rewritten (a
        # concurrent reader stays byte-identical), and chunk padding past
        # the allocated pages has nowhere to live: both go to the null page
        cap = min(a.cache1.k.shape[2], self.cfg_engine.max_seq)
        write_row = np.zeros((self._pages_per_seq,), np.int64)
        write_row[:len(row)] = row
        write_row[:len(shared)] = NULL_PAGE
        t = np.arange(cap)
        phys = torch.from_numpy(write_row[t // ps]).to(self.device)
        off = torch.from_numpy(t % ps).to(self.device)
        for dst, src in zip(self._planes(self.cache),
                            self._planes(a.cache1)):
            dst[:, phys, off] = src[:, 0, :cap]
        self.cache.pos[idx] = plen
        if self.radix is not None:
            n_prompt_pages = -(-plen // ps)
            self.radix.insert(a.req.prompt_token_ids,
                              [int(p) for p in self._bt_np[idx,
                                                           :n_prompt_pages]])

    def _cow_step(self, active: List[int]) -> None:
        """Copy-on-write barrier before a paged decode: an active slot
        whose write page (the page holding the position this step appends
        to) is shared gets a private copy first, all copies in one
        gather-then-scatter."""
        if self.pool.num_shared == 0:
            return
        ps = self._page_size
        pairs: List[Tuple[int, int, int, int]] = []
        for i in active:
            s = self.slots[i]
            wpos = len(s.req.prompt_token_ids) + len(s.generated) - 1
            lp = wpos // ps
            if lp >= self._pages_per_seq:
                continue          # at capacity; the append masks out
            page = int(self._bt_np[i, lp])
            if page == NULL_PAGE or self.pool.refcount(page) <= 1:
                continue
            fresh = self.pool.alloc(1)
            if fresh is None and self.radix is not None:
                self.radix.evict(1)
                fresh = self.pool.alloc(1)
            if fresh is None:
                # pool dry: surrender the prompt's radix path instead. A
                # shared write page is always the prompt's partial tail,
                # referenced by this slot and its radix node only (match
                # never returns partial pages), so the drop makes it
                # private and the append proceeds in place
                if self.radix is not None:
                    self.radix.drop(s.req.prompt_token_ids)
                continue
            pairs.append((i, lp, page, fresh[0]))
        if not pairs:
            return
        srcs = torch.tensor([p[2] for p in pairs], dtype=torch.int64,
                            device=self.device)
        dsts = torch.tensor([p[3] for p in pairs], dtype=torch.int64,
                            device=self.device)
        c = self.cache
        cow_copy_pages(c.k, c.v, srcs, dsts, c.k_scale, c.v_scale)
        for i, lp, src, dst in pairs:
            self._bt_np[i, lp] = dst
            self.pool.decref(src)
        self._bt_dirty = True
        self.cow_pages_total += len(pairs)

    def _release_slot_pages(self, idx: int) -> None:
        """Drop a finished slot's block-table references. Pages the radix
        tree still references stay resident for future prefix hits; the
        rest free at once."""
        if not self._paged:
            return
        row = self._bt_np[idx]
        for p in row[row != NULL_PAGE]:
            self.pool.decref(int(p))
        row[:] = NULL_PAGE
        self._bt_dirty = True

    def _release_admission_pages(self, a: _Admission) -> None:
        """A failed admission gives back the pages reserved at its start
        (its block-table row was never written)."""
        if not self._paged:
            return
        for p in (a.shared_pages or []) + (a.new_pages or []):
            self.pool.decref(p)
        a.shared_pages = None
        a.new_pages = None

    def _paged_snapshot(self) -> dict:
        """Page pool and radix state (JSON-ready)."""
        d = {
            "page_size": self._page_size,
            "num_pages": self._num_pages,
            "pages_used": self.pool.num_used,
            "pages_shared": self.pool.num_shared,
            "pages_free": self.pool.num_free,
            "pool_exhausted_total": self.pool.exhausted_total,
            "cow_pages_total": self.cow_pages_total,
            "kv_bytes_per_page": self._kv_bytes_per_page,
        }
        if self.radix is not None:
            d["radix"] = self.radix.snapshot()
        return d


    # -- samplers -------------------------------------------------------------

    @staticmethod
    def _simple(s: _Slot) -> bool:
        """No penalty counts and no logprobs: the device sampler covers it
        (any temperature / top-k / top-p / seed)."""
        return s.counts is None and s.n_logprobs < 0

    def _setup_slot_sampler(self, s: _Slot) -> None:
        """Per-request sampler state at admission: penalty counts over the
        prompt, the host generator, the device stream's seed, and whether
        logprobs are tracked (asked for, or needed to rank best_of)."""
        p = s.req.params
        # unseeded: one persistent host stream; seeded: re-derived per
        # token from (seed, absolute position) in _sample_host, so a
        # preempt-resume replays an uninterrupted run
        s.rng = np.random.default_rng() if p.seed is None else None
        s.dev_seed = (int(p.seed) & 0x7FFFFFFF if p.seed is not None
                      else int(np.random.default_rng().integers(1 << 31)))
        s.cum_logprob = s.req.resumed_cum_logprob
        # rank scores are read only when best_of oversamples (> n)
        link = self._children.get(s.req.request_id)
        need_rank = False
        if link is not None:
            fo = self._fanouts.get(link[0])
            need_rank = fo is not None and fo.best_of > fo.n
        s.n_logprobs = (-1 if p.logprobs is None and not need_rank
                        else (p.logprobs or 0))
        if p.needs_counts:
            v = self.cfg.vocab_size
            s.counts = np.zeros((v,), np.int32)
            np.add.at(s.counts, np.asarray(s.req.prompt_token_ids,
                                           np.int64), 1)
            s.counts_out = np.zeros((v,), np.int32)
            if s.req.generated_offset:
                # preempt-resume: the prompt's tail is earlier output
                np.add.at(s.counts_out, np.asarray(
                    s.req.prompt_token_ids[-s.req.generated_offset:],
                    np.int64), 1)
        else:
            s.counts = None
            s.counts_out = None

    def _sample_params(self, idxs: List[int]):
        """The device sampler's per-row inputs over all max_batch rows, on
        the host: temps, top_ks, top_ps, seeds, poss (f32 / int64 [B]);
        rows outside `idxs` are greedy. A row's position is its absolute
        output position (generated_offset + generated), so a seeded stream
        survives preemption."""
        b = self.cfg_engine.max_batch
        temps = torch.zeros((b,), dtype=torch.float32)
        top_ks = torch.zeros((b,), dtype=torch.int64)
        top_ps = torch.ones((b,), dtype=torch.float32)
        seeds = torch.zeros((b,), dtype=torch.int64)
        poss = torch.zeros((b,), dtype=torch.int64)
        for i in idxs:
            s = self.slots[i]
            p = s.req.params
            temps[i], top_ks[i], top_ps[i] = p.temperature, p.top_k, p.top_p
            seeds[i] = s.dev_seed
            poss[i] = s.req.generated_offset + len(s.generated)
        return temps, top_ks, top_ps, seeds, poss

    def _sample_admission(self, lg: torch.Tensor, s: _Slot
                          ) -> Tuple[int, Optional[LogprobEntry]]:
        """First token after an admission prefill (lg [1, V] on the
        device). A simple slot draws from the same device stream as its
        decode steps, at position generated_offset."""
        if self._simple(s):
            p = s.req.params
            dev = self.device
            tok = sample_rows(
                lg, torch.tensor([p.temperature], device=dev),
                torch.tensor([p.top_k], device=dev),
                torch.tensor([p.top_p], device=dev), [s.dev_seed],
                [s.req.generated_offset])
            return int(tok[0]), None
        return self._sample_host(lg[0].cpu().numpy(), s)

    def _sample_host(self, logits: np.ndarray, s: _Slot
                     ) -> Tuple[int, Optional[LogprobEntry]]:
        """Sample one token for a slot on the host (the JAX engine's
        ``_sample_host``): penalties -> (logprobs) -> temperature / top-k /
        top-p, on float64 logits."""
        p = s.req.params
        lg = np.asarray(logits, np.float64)
        if s.counts is not None:
            if p.repetition_penalty != 1.0:
                pen = np.where(lg > 0, lg / p.repetition_penalty,
                               lg * p.repetition_penalty)
                lg = np.where(s.counts > 0, pen, lg)
            if p.frequency_penalty != 0.0 or p.presence_penalty != 0.0:
                # output-token counts only (count-penalty semantics)
                lg = (lg - s.counts_out * p.frequency_penalty
                      - (s.counts_out > 0) * p.presence_penalty)

        entry = None
        if s.n_logprobs >= 0:
            # the distribution after penalties, before temperature (also
            # the best_of rank score)
            ls = lg - (np.max(lg) + np.log(
                np.sum(np.exp(lg - np.max(lg)))))
        if p.temperature <= 0.0:
            tok = int(np.argmax(lg))
        else:
            t = lg / p.temperature
            if p.top_k > 0:
                kth = np.sort(t)[-p.top_k]
                t = np.where(t < kth, -np.inf, t)
            if p.top_p < 1.0:
                order = np.argsort(t)[::-1]
                probs = np.exp(t[order] - np.max(t))
                probs /= probs.sum()
                cum = np.cumsum(probs)
                cut = int(np.searchsorted(cum, p.top_p)) + 1
                mask = np.full_like(t, -np.inf)
                mask[order[:cut]] = t[order[:cut]]
                t = mask
            probs = np.exp(t - np.max(t[np.isfinite(t)]))
            probs = np.where(np.isfinite(t), probs, 0.0)
            probs /= probs.sum()
            if s.rng is not None:
                rng = s.rng
            else:
                # stateless seeded draw keyed by absolute token position
                pos = s.req.generated_offset + len(s.generated)
                rng = np.random.default_rng((p.seed, pos))
            tok = int(rng.choice(len(probs), p=probs))

        if s.n_logprobs >= 0:
            s.cum_logprob += float(ls[tok])
            top: List[Tuple[int, float]] = []
            if s.n_logprobs > 0:
                idx = np.argpartition(ls, -s.n_logprobs)[-s.n_logprobs:]
                idx = idx[np.argsort(ls[idx])[::-1]]
                top = [(int(i), float(ls[i])) for i in idx]
            entry = LogprobEntry(tok, float(ls[tok]), top)
        if s.counts is not None:
            s.counts[tok] += 1
            s.counts_out[tok] += 1
        return tok, entry

    # -- outputs, finishing, preemption --------------------------------------

    def _push_output(self, rid: str, out: RequestOutput,
                     score: Optional[float] = None,
                     length: int = 0) -> None:
        """Deliver an output, routing n / best_of children to their
        parent. Streaming children (best_of == n) pass through with their
        choice index; their finishes are demoted to finished=False (a
        choice ending is not the request ending) and one synthetic
        finished output closes the parent when the last child lands.
        Oversampled children (best_of > n) are buffered until every
        candidate finishes, then the n best by mean logprob are emitted as
        choices 0..n-1."""
        link = self._children.get(rid)
        if link is None:
            with self._lock:
                self._outputs.setdefault(rid, []).append(out)
            return
        pid, idx = link
        fo = self._fanouts[pid]
        out = dataclasses.replace(out, request_id=pid, index=idx)
        stream = fo.best_of == fo.n
        if out.finished:
            fo.done += 1
            fo.scores[idx] = score if score is not None else -np.inf
            fo.lengths[idx] = length
            if stream:
                out = dataclasses.replace(out, finished=False)
        if stream:
            with self._lock:
                self._outputs.setdefault(pid, []).append(out)
        else:
            fo.buffered.setdefault(idx, []).append(out)
        if fo.done == fo.best_of:
            self._finish_fanout(fo)

    def _finish_fanout(self, fo: _Fanout) -> None:
        outs: List[RequestOutput] = []
        if fo.best_of > fo.n:
            mean = {i: fo.scores[i] / max(fo.lengths.get(i, 1), 1)
                    for i in fo.scores}
            ranked = sorted(mean, key=lambda i: mean[i], reverse=True)
            for new_idx, child_idx in enumerate(ranked[:fo.n]):
                for o in fo.buffered.get(child_idx, []):
                    # only the closer below finishes the parent
                    outs.append(dataclasses.replace(
                        o, index=new_idx, finished=False))
        # the closer carries no finish_reason: the choices' own reasons
        # were delivered already, and one here would overwrite choice 0's
        outs.append(RequestOutput(fo.parent_id, [], True, None))
        with self._lock:
            self._outputs.setdefault(fo.parent_id, []).extend(outs)
        for i in range(fo.best_of):
            self._children.pop(f"{fo.parent_id}#{i}", None)
            self._abort.discard(f"{fo.parent_id}#{i}")
        self._fanouts.pop(fo.parent_id, None)

    def _emit(self, s: _Slot, lp: Optional[LogprobEntry] = None) -> None:
        want_lp = s.req.params.logprobs is not None and lp is not None
        self._push_output(
            s.req.request_id,
            RequestOutput(s.req.request_id, [s.last_token], False,
                          logprobs=[lp] if want_lp else None))
        self._m_tokens.inc()

    def _check_done(self, idx: int) -> bool:
        s = self.slots[idx]
        p = s.req.params
        tok = s.last_token
        reason = None
        if (not p.ignore_eos and self.eos_token_id is not None
                and tok == self.eos_token_id):
            reason = "stop"
        elif tok in p.stop_token_ids:
            reason = "stop"
        elif s.req.generated_offset + len(s.generated) >= p.max_tokens:
            reason = "length"
        elif (len(s.req.prompt_token_ids) + len(s.generated) + 1
              >= self.cfg_engine.max_seq):
            reason = "length"
        if reason is None:
            return False
        self._finish(idx, reason)
        return True

    def _finish(self, idx: int, reason: str,
                error: Optional[dict] = None) -> None:
        s = self.slots[idx]
        if s.req is None:
            return
        gen_len = s.req.generated_offset + len(s.generated)
        if reason in ("abort", "error") and self.radix is not None:
            # a cancelled client's prompt pages are dead weight; a
            # poisoned request's must never seed a future admission
            self.radix.drop(s.req.prompt_token_ids)
        self._push_output(
            s.req.request_id,
            RequestOutput(s.req.request_id, [], True, reason, error=error),
            score=s.cum_logprob, length=gen_len)
        self._obs_finish(s.req.request_id, reason, n_generated=gen_len)
        self._reset_slot(idx)

    def _quarantine_slot(self, idx: int, reason: str) -> None:
        """Blast-radius isolation: fail ONE resident request with a
        structured error while every other slot keeps decoding."""
        rid = self.slots[idx].req.request_id
        self._m_quarantined.labels(reason).inc()
        self._finish(idx, "error", error=self._quarantine_error(reason, rid))

    @staticmethod
    def _quarantine_error(reason: str, rid: str) -> dict:
        return {"reason": reason, "request_id": rid}

    def _reset_slot(self, idx: int) -> None:
        """Empty a slot: release its pages (paged) and reset its position
        so the idle row stops deepening."""
        s = self.slots[idx]
        s.req = None
        s.active = False
        s.generated = []
        s.counts = None
        s.counts_out = None
        self._release_slot_pages(idx)
        self.cache.pos[idx] = 0

    def _preempt(self) -> None:
        """Starvation relief: evict the latest-arrived running sequence by
        recompute. Its tokens so far become the prompt of a resumed
        request at the back of the queue, so the starved requests admit
        into the freed slot first. Nothing already streamed is emitted
        again."""
        victim = max((i for i, s in enumerate(self.slots) if s.active),
                     key=lambda i: self.slots[i].req.arrival, default=None)
        if victim is None:
            return
        s = self.slots[victim]
        req = s.req
        resumed = dataclasses.replace(
            req,
            prompt_token_ids=list(req.prompt_token_ids) + list(s.generated),
            generated_offset=req.generated_offset + len(s.generated),
            resumed_cum_logprob=s.cum_logprob)
        self._reset_slot(victim)
        with self._lock:
            self.waiting.append(resumed)
        self._m_preemptions.inc()
        self.tracer.preempted(resumed.request_id)

    # -- observability --------------------------------------------------------

    def _obs_admission_complete(self, rid: str) -> None:
        """First token of an admission sampled: the queue and prefill
        phases close, and TTFT is recorded (first admission only: a
        preempt-resume streamed its first token already)."""
        span = self.tracer.get(rid)
        now = time.time()
        just_first = span is not None and span.t_first_token is None
        if span is not None and span.t_admitted is not None:
            qw = span.queue_wait_s
            if qw is not None and qw >= 0:
                self._m_phase.labels("queue").observe(qw)
            self._m_phase.labels("prefill").observe(
                max(now - span.t_admitted, 0.0))
        self.tracer.first_token(rid)
        if just_first and span.ttft_s is not None:
            self._m_ttft.observe(span.ttft_s)
        self._m_admissions.inc()

    def _obs_finish(self, rid: str, reason: str,
                    n_generated: int = 0) -> None:
        span = self.tracer.finish(rid, reason, n_generated=n_generated)
        if span is not None:
            d = span.decode_s
            if d is not None and d >= 0:
                self._m_phase.labels("decode").observe(d)
        self._m_finished.labels(reason).inc()

    def _update_gauges(self) -> None:
        self._m_occupancy.set(sum(1 for s in self.slots if s.active))
        self._m_queue_depth.set(len(self.waiting))
