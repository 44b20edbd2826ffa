"""Offline token generation: a prefill at a power-of-two bucket, then one
decode step a token, sampling on the device (counterpart of
``bigdl_tpu/generation.py``).

``Generator.stream`` keeps the JAX package's step order, so greedy streams
equal its ``Generator``'s and seeded streams draw the same bits
(``ops/random.py``): the prompt is right-padded into its bucket and
prefilled; with padding, the position is reset to ``s - 1`` and the last
real token runs through decode to give the first logits (the pad repair);
each step splits the key, samples (penalties through ``token_counts``),
masks finished rows to 0 and tracks EOS on the device. Only the emitted
token comes back to the host each step.

Where the JAX package's jitted code divides by a constant (temperature,
repetition penalty), XLA multiplies by the constant's f32 reciprocal; the
port does the same, so the quotients are bit-identical.

The resident step (``step_resident`` of the JAX ``Generator``): when
``BIGDL_TPU_TORCH_DECODE_RESIDENT`` is not ``off`` and the generation has
no penalties and no ``check_logits``, each decode step is one function
(forward, sampling under the step's subkey, the EOS mask) over static
buffers, captured as a CUDA graph on the card and replayed once a step.
The key chain stays on the host; each step's subkey is copied into a
static device buffer before the replay, so sampled bits do not change.
The Generator keeps the KV caches of its last two batch sizes, with
graphs for the last two sampling settings (and EOS) over each, and lends
a kept cache to one call at a time: a second call in flight at the same
batch size gets a cache and a graph of its own for that call.
``generate_on_device`` (the JAX package's whole loop as one program)
prefills eagerly and then
replays one captured step ``max_new_tokens - 1`` times into a device
[B, T] buffer, its subkeys precomputed into a device tensor that a
device-side step counter indexes; the host syncs once at the end. On the
CPU both run the same functions eagerly.

Not ported: beam search (A12), fault hooks (A16) and multimodal prefill
(``visual``, A13); each raises naming its item.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.config import decode_resident_enabled, flags
from bigdl_tpu_torch.cuda_graph import GraphPool, StepGraph, addresses
from bigdl_tpu_torch.models import llama as llama_mod
from bigdl_tpu_torch.ops import random as rnd
from bigdl_tpu_torch.ops.kvcache import KVCache, resolve_kv_cache_dtype

# the Generator's resident step keeps at most this many KV caches (one a
# batch size) and this many graphs over each (one a sampling setting)
KEEP_CACHES = 2
KEEP_GRAPHS = 2


@dataclasses.dataclass
class GenerationConfig:
    max_new_tokens: int = 32
    temperature: float = 1.0
    top_k: int = 0            # 0 = disabled
    top_p: float = 1.0        # 1.0 = disabled
    do_sample: bool = False
    eos_token_id: Optional[int] = None
    seed: int = 0
    # llama.cpp-style repetition penalty over prompt + output: logits of
    # seen tokens divide (if > 0) / multiply (if < 0) by it. 1.0 = off.
    repetition_penalty: float = 1.0
    # OpenAI-style count penalties over output tokens only:
    # logit -= count * frequency_penalty + (count > 0) * presence_penalty
    presence_penalty: float = 0.0
    frequency_penalty: float = 0.0
    # raise FloatingPointError on NaN/Inf logits (a host check a step)
    check_logits: bool = False

    @property
    def needs_token_counts(self) -> bool:
        return (self.repetition_penalty != 1.0
                or self.presence_penalty != 0.0
                or self.frequency_penalty != 0.0)


def _recip(c: float) -> float:
    """The f32 reciprocal XLA multiplies by where jitted code divides by
    the constant `c`."""
    return float(np.float32(1.0) / np.float32(c))


def token_counts(tokens: torch.Tensor, vocab_size: int,
                 length=None) -> torch.Tensor:
    """Per-row occurrence counts int32 [B, V] of tokens [B, S]; positions
    at or past `length` ([B] or a scalar) do not count."""
    b, s = tokens.shape
    dev = tokens.device
    if length is None:
        add = torch.ones((b, s), dtype=torch.int32, device=dev)
    else:
        ln = torch.as_tensor(length, dtype=torch.int32,
                             device=dev).reshape(-1, 1).expand(b, 1)
        add = (torch.arange(s, dtype=torch.int32, device=dev)[None, :]
               < ln).to(torch.int32)
    return torch.zeros((b, vocab_size), dtype=torch.int32,
                       device=dev).scatter_add_(1, tokens.long(), add)


def apply_penalties(logits: torch.Tensor, rep_counts: torch.Tensor,
                    out_counts: torch.Tensor,
                    repetition_penalty: float = 1.0,
                    presence_penalty: float = 0.0,
                    frequency_penalty: float = 0.0) -> torch.Tensor:
    """Repetition penalty over prompt + output counts, then presence and
    frequency penalties over output counts; logits [B, V] f32."""
    if repetition_penalty != 1.0:
        seen = rep_counts > 0
        penalized = torch.where(logits > 0,
                                logits * _recip(repetition_penalty),
                                logits * repetition_penalty)
        logits = torch.where(seen, penalized, logits)
    if presence_penalty != 0.0 or frequency_penalty != 0.0:
        logits = (logits
                  - out_counts.to(logits.dtype) * frequency_penalty
                  - (out_counts > 0).to(logits.dtype) * presence_penalty)
    return logits


def filter_logits(logits: torch.Tensor, top_k: int = 0,
                  top_p: float = 1.0) -> torch.Tensor:
    """top-k, then top-p filtering over the last axis (-inf outside the
    set); the top token always survives."""
    ninf = torch.full((), float("-inf"), dtype=logits.dtype,
                      device=logits.device)
    if top_k > 0:
        kth = torch.sort(logits, dim=-1).values[..., -top_k][..., None]
        logits = torch.where(logits < kth, ninf, logits)
    if top_p < 1.0:
        desc = torch.flip(torch.sort(logits, dim=-1).values, dims=(-1,))
        e = torch.exp(desc - desc.amax(dim=-1, keepdim=True))
        cum = torch.cumsum(e / e.sum(dim=-1, keepdim=True), dim=-1)
        idx = (cum < top_p).sum(dim=-1, keepdim=True)
        # every prefix short of top_p: a gather past the end, which keeps
        # every token in the JAX package (its fill value is NaN)
        cutoff = torch.where(idx < desc.shape[-1],
                             torch.gather(desc, -1, idx.clamp(
                                 max=desc.shape[-1] - 1)), ninf)
        logits = torch.where(logits < cutoff, ninf, logits)
    return logits


def sample_token(logits: torch.Tensor, key, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Greedy (temperature <= 0) or temperature / top-k / top-p sampling
    of logits [B, V] f32 under `key`. Returns int32 [B]."""
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    lg = filter_logits(logits * _recip(temperature), top_k, top_p)
    return rnd.categorical(key, lg).to(torch.int32)


@dataclasses.dataclass
class GenerationStats:
    """First-token time and the time of each later token (s)."""
    first_token_s: float = 0.0
    rest_token_s: List[float] = dataclasses.field(default_factory=list)

    @property
    def rest_cost_mean(self) -> float:
        return float(np.mean(self.rest_token_s)) if self.rest_token_s else 0.0


def step_resident(family, params, cfg, cache: KVCache, tok: torch.Tensor,
                  key: torch.Tensor, finished: torch.Tensor,
                  temperature: float, top_k: int, top_p: float,
                  eos: Optional[int]) -> None:
    """The Generator's resident step (``step_resident`` of the JAX
    package): the family's forward of tok int64 [B] at ``cache.pos``, then
    ``sample_token`` under the subkey in `key` (int64 [2] on the device),
    then the EOS mask (rows already `finished` emit 0; `finished` [B] bool
    grows in place). Writes the token to `tok` and advances ``cache.pos``
    by one in place, so one call can be captured and replayed."""
    logits, _ = family.forward(params, cfg, tok[:, None], cache)
    nxt = sample_token(logits[:, -1, :], (key[0], key[1]), temperature,
                       top_k, top_p).long()
    if eos is not None:
        nxt = torch.where(finished, torch.zeros_like(nxt), nxt)
        finished.logical_or_(nxt == eos)
    tok.copy_(nxt)
    cache.pos.add_(1)


def generate_on_device(params: Dict[str, Any], cfg, forward_fn, input_ids,
                       cache: KVCache, max_new_tokens: int,
                       temperature: float = 0.0, top_k: int = 0,
                       top_p: float = 1.0,
                       eos_token_id: Optional[int] = None, seed: int = 0,
                       repetition_penalty: float = 1.0,
                       presence_penalty: float = 0.0,
                       frequency_penalty: float = 0.0):
    """The whole generation with one host sync (``generate_on_device`` of
    the JAX package): a prefill of input_ids [B, S] through
    ``forward_fn(params, cfg, tokens, cache)``, the first token sampled
    from its last position, then ``max_new_tokens - 1`` decode steps, each
    sampling under the next subkey of ``split`` from ``PRNGKey(seed)``,
    with the repetition penalty over prompt + output counts and the
    presence / frequency penalties over output counts on the device. Rows
    past their EOS emit 0 (shapes stay static; no early stop). Returns
    (int32 tokens [B, max_new_tokens] on the cache's device, cache).

    On the card the decode step is captured as a CUDA graph after its
    first, eager run and replayed (``BIGDL_TPU_TORCH_DECODE_RESIDENT``
    ``off`` runs it eagerly every time); on the CPU it runs eagerly."""
    dev = cache.k.device
    ids = torch.as_tensor(input_ids).to(dev, torch.int64)
    b, s = ids.shape
    if s + max_new_tokens > cache.max_seq:
        raise ValueError(
            f"prompt ({s}) + max_new_tokens ({max_new_tokens}) exceeds "
            f"cache max_seq {cache.max_seq}")
    with torch.inference_mode():
        return _generate_on_device(
            params, cfg, forward_fn, ids, cache, max_new_tokens, temperature,
            top_k, top_p, eos_token_id, seed, repetition_penalty,
            presence_penalty, frequency_penalty)


def _generate_on_device(params, cfg, forward_fn, ids, cache, t_new, temp,
                        top_k, top_p, eos, seed, rep_pen, pres, freq):
    dev = ids.device
    b = ids.shape[0]
    penal = rep_pen != 1.0 or pres != 0.0 or freq != 0.0
    logits, cache = forward_fn(params, cfg, ids, cache)
    last = logits[:, -1, :]
    v = last.shape[-1]
    # rep counts include the prompt; out counts are generation-only
    rep = token_counts(ids, v) if penal else None
    outc = (torch.zeros((b, v), dtype=torch.int32, device=dev) if penal
            else None)
    rows = torch.arange(b, device=dev)

    def pick(lg, k):
        if penal:
            lg = apply_penalties(lg, rep, outc, rep_pen, pres, freq)
        return sample_token(lg, k, temperature=temp, top_k=top_k,
                            top_p=top_p).long()

    def bump(tok, done):
        if penal:
            add = (~done).to(torch.int32)
            for counts in (rep, outc):
                counts[rows, tok] = counts[rows, tok] + add

    # the key chain of the JAX loop, split on the host once
    key = rnd.prng_key(seed)
    subkeys = []
    for _ in range(t_new):
        key, sk = rnd.split(key)
        subkeys.append(sk)
    tok = pick(last, subkeys[0])
    done = (tok == eos if eos is not None
            else torch.zeros((b,), dtype=torch.bool, device=dev))
    bump(tok, torch.zeros_like(done))
    out = torch.zeros((b, t_new), dtype=torch.int64, device=dev)
    out[:, 0] = tok
    # the step's state lives in tensors it updates in place
    cache = cache.reset_pos(cache.pos.clone())
    keys = torch.tensor(subkeys, dtype=torch.int64, device=dev)   # [T, 2]
    ctr = torch.ones((1,), dtype=torch.int64, device=dev)

    def step():
        lg, _ = forward_fn(params, cfg, tok[:, None], cache)
        sk = keys.index_select(0, ctr)[0]
        nxt = torch.where(done, torch.zeros_like(tok),
                          pick(lg[:, -1, :], (sk[0], sk[1])))
        bump(nxt, done)
        if eos is not None:
            done.logical_or_(nxt == eos)
        out.index_copy_(1, ctr, nxt[:, None])
        tok.copy_(nxt)
        ctr.add_(1)
        cache.pos.add_(1)

    run = step
    if dev.type == "cuda" and decode_resident_enabled():
        run = StepGraph("generate_on_device", step, dev)
    for _ in range(t_new - 1):
        run()
    return out.to(torch.int32), cache


def beam_search(*args, **kwargs):
    raise NotImplementedError("beam search is not ported (ROADMAP A12)")


class Generator:
    """The generate loop over one model: `family` is its model module
    (``forward``, ``forward_last_token``, ``new_cache``; llama by
    default). Runs where the parameters live."""

    def __init__(self, params: Dict[str, Any], cfg, family=None,
                 max_seq: int = 2048, kv_cache_dtype: Optional[str] = None,
                 faults=None):
        if faults is not None:
            raise NotImplementedError(
                "fault hooks in the generate loop are not ported "
                "(ROADMAP A16)")
        self.params = params
        self.cfg = cfg
        self.family = family or llama_mod
        self.family.check_supported(cfg)
        self.max_seq = max_seq
        self.kv_cache_dtype = resolve_kv_cache_dtype(kv_cache_dtype)
        self.device = params["embed_tokens"].device
        # the resident step's kept KV caches by batch size, each with its
        # graphs, lent to one call at a time (``_borrow``)
        self._kept: "OrderedDict[int, _KeptCache]" = OrderedDict()
        self._lock = threading.Lock()

    def _bucket(self, n: int) -> int:
        """The prompt length rounded up to a power of two (at least 16),
        at most max_seq."""
        b = 16
        while b < n:
            b *= 2
        return min(b, self.max_seq)

    def generate(self, input_ids, gen: Optional[GenerationConfig] = None,
                 stats: Optional[GenerationStats] = None,
                 visual=None) -> np.ndarray:
        """Generated ids [B, <= max_new_tokens] (prompt excluded)."""
        return np.stack(list(self.stream(input_ids, gen, stats, visual)),
                        axis=1)

    def stream(self, input_ids, gen: Optional[GenerationConfig] = None,
               stats: Optional[GenerationStats] = None, visual=None):
        """Token-by-token generation: yields int32 [B] numpy arrays, one a
        step; rows past their EOS emit 0."""
        if visual is not None:
            raise NotImplementedError(
                "multimodal prefill (visual=) is not ported (ROADMAP A13)")
        gen = gen or GenerationConfig()
        ids = np.asarray(input_ids, np.int32)
        if ids.ndim == 1:
            ids = ids[None]
        b, s = ids.shape
        if s + gen.max_new_tokens > self.max_seq:
            raise ValueError(
                f"prompt ({s}) + max_new_tokens ({gen.max_new_tokens}) "
                f"exceeds max_seq {self.max_seq}")
        # each step runs under inference mode, and the mode is left before
        # the yield: a suspended stream holding it would leave the
        # caller's thread in it (and two interleaved streams would swap
        # what they restore)
        steps = self._stream(ids, gen, stats)
        try:
            while True:
                with torch.inference_mode():
                    tok = next(steps, None)
                if tok is None:
                    return
                yield tok
        finally:
            steps.close()

    def graph_stats(self) -> List[dict]:
        """Each kept resident-step graph's key, capture ms, pool bytes,
        replays and launches a replay (none on the CPU)."""
        return [dict(st.graph.stats(), batch=k.b, temperature=key[0],
                     top_k=key[1], top_p=key[2], eos=key[3])
                for k in self._kept.values()
                for key, st in k.steps.items() if st.graph.graph is not None]

    def _borrow(self, b: int) -> "_KeptCache":
        """The kept resident cache of batch `b`, lent to this call; a new
        one if none is kept or the weights moved. When another call holds
        it (two streams in flight), this call gets one of its own that is
        not kept. At most KEEP_CACHES are kept, the most recently used."""
        addrs = addresses(self.params)
        with self._lock:
            k = self._kept.pop(b, None)
            if k is not None and k.addrs != addrs:
                k = None
            if k is not None and k.busy:
                self._kept[b] = k
                k = _KeptCache(self, b, addrs)
            else:
                k = k or _KeptCache(self, b, addrs)
                self._kept[b] = k
                while len(self._kept) > KEEP_CACHES:
                    self._kept.popitem(last=False)
            k.busy = True
            return k

    def _stream(self, ids: np.ndarray, gen: GenerationConfig,
                stats: Optional[GenerationStats]):
        # the resident step's gate (the JAX Generator's): no host-side
        # work a step, that is no penalties and no check_logits
        if (not decode_resident_enabled() or gen.needs_token_counts
                or gen.check_logits):
            yield from self._run(ids, gen, stats, None)
            return
        kept = self._borrow(ids.shape[0])
        try:
            yield from self._run(ids, gen, stats, kept)
        finally:
            kept.busy = False

    def _run(self, ids: np.ndarray, gen: GenerationConfig,
             stats: Optional[GenerationStats], kept: Optional["_KeptCache"]):
        """The generate loop; with `kept` its decode steps are the
        resident step over the kept cache."""
        fam, p, cfg, dev = self.family, self.params, self.cfg, self.device
        b, s = ids.shape
        if kept is not None:
            cache = kept.cache
        else:
            cache = fam.new_cache(cfg, b, self.max_seq, device=dev,
                                  kv_cache_dtype=self.kv_cache_dtype)
        bucket = self._bucket(s)
        pad = bucket - s
        padded = np.zeros((b, bucket), np.int32)
        padded[:, :s] = ids
        padded_t = torch.from_numpy(padded).to(dev)

        key = rnd.prng_key(gen.seed)
        t0 = time.perf_counter()
        logits, cache = fam.forward_last_token(p, cfg, padded_t, cache)
        if pad > 0:
            # the bucket's last position is padding: rerun the last real
            # token through decode at position s - 1
            cache = cache.reset_pos(torch.tensor(s - 1, dtype=torch.int32,
                                                 device=dev))
            logits, cache = fam.forward(p, cfg, padded_t[:, s - 1:s], cache)

        temp = gen.temperature if gen.do_sample else 0.0
        penal = gen.needs_token_counts
        counts = out_counts = None
        if penal:
            v = logits.shape[-1]
            counts = token_counts(padded_t, v, s)
            out_counts = torch.zeros((b, v), dtype=torch.int32, device=dev)
        rows = torch.arange(b, device=dev)

        def sample(lg, k):
            if penal:
                lg = apply_penalties(lg, counts, out_counts,
                                     gen.repetition_penalty,
                                     gen.presence_penalty,
                                     gen.frequency_penalty)
            t = sample_token(lg, k, temperature=temp, top_k=gen.top_k,
                             top_p=gen.top_p)
            if penal:
                counts[rows, t.long()] += 1
                out_counts[rows, t.long()] += 1
            return t

        def check(lg, where):
            if gen.check_logits and not bool(torch.isfinite(lg).all()):
                raise FloatingPointError(f"non-finite logits {where}")

        check(logits[:, -1, :], "after prefill")
        key, sk = rnd.split(key)
        tok = sample(logits[:, -1, :], sk)
        tok_host = tok.cpu().numpy()
        if stats is not None:
            stats.first_token_s = time.perf_counter() - t0
        yield tok_host

        eos = gen.eos_token_id
        finished = np.zeros((b,), bool)
        finished_dev = torch.zeros((b,), dtype=torch.bool, device=dev)
        if eos is not None:
            finished |= tok_host == eos
            finished_dev = torch.from_numpy(finished).to(dev)
        if kept is not None:
            st = kept.step(self, temp, gen)
            st.start(tok, cache.pos, finished_dev)
            for _ in range(1, gen.max_new_tokens):
                if finished.all():
                    break
                t1 = time.perf_counter()
                key, sk = rnd.split(key)
                tok_host = st.step(sk)
                if stats is not None:
                    stats.rest_token_s.append(time.perf_counter() - t1)
                yield tok_host
                if eos is not None:
                    finished |= tok_host == eos
            return
        for step in range(1, gen.max_new_tokens):
            if finished.all():
                break
            t1 = time.perf_counter()
            logits, cache = fam.forward(p, cfg, tok.long()[:, None], cache)
            check(logits[:, -1, :], f"at decode step {step}")
            key, sk = rnd.split(key)
            tok = sample(logits[:, -1, :], sk)
            if eos is not None:
                # rows past their EOS emit 0; the mask stays on the device
                tok = torch.where(finished_dev, torch.zeros_like(tok), tok)
                finished_dev = finished_dev | (tok == eos)
            tok_host = tok.cpu().numpy()
            if stats is not None:
                stats.rest_token_s.append(time.perf_counter() - t1)
            yield tok_host
            if eos is not None:
                finished |= tok_host == eos


class _KeptCache:
    """A resident-step KV cache of batch `b` and the steps over it, one a
    sampling setting, EOS and flag set (the KEEP_GRAPHS most recently
    used). Their graphs share one memory pool: a kept cache is lent to
    one call at a time, so they never replay at the same time. Prefill
    rewrites every position a step reads, so a new call needs no
    clearing."""

    def __init__(self, g: Generator, b: int, addrs: tuple):
        self.b, self.addrs, self.busy = b, addrs, False
        self.cache = g.family.new_cache(g.cfg, b, g.max_seq, device=g.device,
                                        kv_cache_dtype=g.kv_cache_dtype)
        self.pool = GraphPool(g.device) if g.device.type == "cuda" else None
        self.steps: "OrderedDict[tuple, _GenStep]" = OrderedDict()

    def step(self, g: Generator, temp: float,
             gen: GenerationConfig) -> "_GenStep":
        key = (temp, gen.top_k, gen.top_p, gen.eos_token_id, flags())
        st = self.steps.pop(key, None) or _GenStep(g, self, temp, gen)
        self.steps[key] = st
        while len(self.steps) > KEEP_GRAPHS:
            self.steps.popitem(last=False)
        return st


class _GenStep:
    """Static buffers of the Generator's resident step over one cache:
    the token [B] int64, the subkey [2] int64, the EOS mask [B] bool and
    the cache with a position tensor of its own, advanced in place; and
    the step as a ``StepGraph`` (a graph on the card)."""

    def __init__(self, g: Generator, kept: _KeptCache, temp: float,
                 gen: GenerationConfig):
        dev, b, cache = g.device, kept.b, kept.cache
        self.tok = torch.zeros((b,), dtype=torch.int64, device=dev)
        self.key = torch.zeros((2,), dtype=torch.int64, device=dev)
        self.finished = torch.zeros((b,), dtype=torch.bool, device=dev)
        self.cache = cache.reset_pos(torch.zeros((), dtype=torch.int32,
                                                 device=dev))
        self.sampled = temp > 0.0
        c, tok, key, fin = self.cache, self.tok, self.key, self.finished
        fam, p, cfg = g.family, g.params, g.cfg

        def fn():
            step_resident(fam, p, cfg, c, tok, key, fin, temp, gen.top_k,
                          gen.top_p, gen.eos_token_id)

        self.graph = StepGraph("generate_decode_resident", fn, dev,
                               keep=(tok, key, fin, c.pos), pool=kept.pool)

    def start(self, tok: torch.Tensor, pos: torch.Tensor,
              finished: torch.Tensor) -> None:
        """Load the first token, the position after prefill and the EOS
        mask into the static buffers."""
        self.tok.copy_(tok)
        self.cache.pos.copy_(pos)
        self.finished.copy_(finished)

    def step(self, subkey) -> np.ndarray:
        """One step under `subkey`; returns the int32 [B] tokens."""
        if self.sampled:
            self.key.copy_(torch.tensor(subkey, dtype=torch.int64))
        self.graph()
        return self.tok.cpu().numpy().astype(np.int32)
