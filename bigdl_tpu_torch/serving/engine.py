"""Continuous-batching serving engine, lean port of
``bigdl_tpu/serving/engine.py::LLMEngine`` (slab KV mode).

Kept: the public surface of ``SamplingParams`` (max_tokens, temperature,
top_k, top_p, stop_token_ids, seed), ``RequestOutput`` and
``EngineConfig`` (max_batch, max_seq, prefill_bucket, prefill_chunk), and
``add_request`` / ``step`` / ``get_outputs`` / ``has_unfinished`` /
``generate``. Inside:

- one batched bf16 KV cache [L, max_batch, max_seq, Hkv, hd] with a
  per-slot position vector; a slot is a sequence's home for its lifetime;
- FCFS admission with chunked prefill into a private 1-row cache (at most
  one chunk per step, so a long prompt cannot stall running streams),
  spliced into the batched cache when the prompt is done;
- one batched decode over all slots per step (idle slots decode garbage
  that is never read, as in the reference);
- a batched sampler: greedy argmax, or temperature / top-k / top-p by
  gumbel-max with one seeded stream per (seed, position).

The sampled (non-greedy) tokens cannot match the JAX engine's bits: its
gumbel noise comes from ``fold_in(PRNGKey(seed), pos)`` (threefry), this
one from a ``torch.Generator`` seeded per (seed, position). Greedy
streams match; seeded streams repeat for the same seed.

Not ported yet: penalties, logprobs, n/best_of, paged KV, prefix caching,
preemption, overload control, deadlines, fault handling, observability.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.models import llama as llama_mod
from bigdl_tpu_torch.ops.kvcache import KVCache, init_cache


@dataclasses.dataclass
class SamplingParams:
    max_tokens: int = 128
    temperature: float = 0.0       # 0 = greedy
    top_k: int = 0
    top_p: float = 1.0
    stop_token_ids: Tuple[int, ...] = ()
    seed: Optional[int] = None


@dataclasses.dataclass
class Request:
    request_id: str
    prompt_token_ids: List[int]
    params: SamplingParams
    arrival: float = dataclasses.field(default_factory=time.time)


@dataclasses.dataclass
class RequestOutput:
    request_id: str
    new_token_ids: List[int]
    finished: bool
    finish_reason: Optional[str] = None


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    max_seq: int = 2048
    prefill_bucket: int = 16       # smallest prefill width
    # a step() runs at most this many prompt tokens of prefill before the
    # batched decode (rounded down to a power of two)
    prefill_chunk: int = 256


class _Slot:
    __slots__ = ("req", "generated", "last_token", "active", "seed")

    def __init__(self):
        self.req: Optional[Request] = None
        self.generated: List[int] = []
        self.last_token = 0
        self.active = False
        self.seed = 0           # sampler stream seed (31 bits)


@dataclasses.dataclass
class _Admission:
    """A sequence mid-(chunked)-prefill and its private 1-row cache."""
    req: Request
    slot_idx: int
    consumed: int
    cache1: KVCache
    chunk: int


_MASK64 = (1 << 64) - 1


def stream_seed(seed: int, pos: int) -> int:
    """64-bit generator seed for one (request seed, position) draw:
    splitmix64 of the pair, so every bit depends on both (the CPU
    generator keeps only the low 32 bits of its seed)."""
    z = (((int(seed) & 0x7FFFFFFF) << 32) | (int(pos) & 0xFFFFFFFF))
    z = (z + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def sample_rows(lg: torch.Tensor, temps: torch.Tensor, top_ks: torch.Tensor,
                top_ps: torch.Tensor, seeds: List[int], poss: List[int]
                ) -> torch.Tensor:
    """Batched sampler (the form of ``_device_sample_rows``): rows with
    temperature <= 0 take the argmax of their logits; the others mask by
    top-k, then top-p on the post-top-k distribution, and draw by
    gumbel-max with noise from a generator seeded by (seed, position).
    lg [B, V] f32; temps/top_ps f32 [B], top_ks int [B] on lg's device;
    seeds/poss host ints. Returns int64 [B]."""
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
    z = lg.clone()
    greedy_host = greedy.tolist()
    for i in range(b):
        if greedy_host[i]:
            continue
        gen = torch.Generator(device=lg.device)
        gen.manual_seed(stream_seed(seeds[i], poss[i]))
        u = torch.rand((v,), generator=gen, device=lg.device,
                       dtype=torch.float32)
        u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
        z[i] = t[i] - torch.log(-torch.log(u))
    return torch.argmax(z, dim=-1)


class LLMEngine:
    """Synchronous continuous-batching engine over one llama-family model
    (anything with ``.params``, ``.config`` and ``.hf_config``). Drive it
    with add_request() + step(), or generate()."""

    def __init__(self, model: Any, config: Optional[EngineConfig] = None,
                 device="cuda"):
        self.cfg_engine = ce = config or EngineConfig()
        self.params = model.params
        self.cfg = model.config
        self.device = torch.device(device)
        llama_mod.check_supported(self.cfg)
        eos = (getattr(model, "hf_config", None) or {}).get("eos_token_id")
        self.eos_token_id = eos[0] if isinstance(eos, list) else eos
        self.cache = init_cache(self.cfg.num_hidden_layers, ce.max_batch,
                                ce.max_seq, self.cfg.num_key_value_heads,
                                self.cfg.hd, per_slot_pos=True,
                                device=self.device)
        self.slots = [_Slot() for _ in range(ce.max_batch)]
        self.waiting: "collections.deque[Request]" = collections.deque()
        self._outputs: Dict[str, List[RequestOutput]] = {}
        # chunk width: a power of two, so chunks tile the private cache
        self._chunk = 1 << (max(1, ce.prefill_chunk).bit_length() - 1)
        self._admitting: Optional[_Admission] = None

    # -- public surface -------------------------------------------------------

    def add_request(self, request_id: str, prompt_token_ids,
                    params: Optional[SamplingParams] = None) -> None:
        params = params or SamplingParams()
        ids = [int(t) for t in prompt_token_ids]
        if not ids:
            raise ValueError("empty prompt")
        if len(ids) + 1 > self.cfg_engine.max_seq:
            raise ValueError(f"prompt length {len(ids)} exceeds engine "
                             f"max_seq {self.cfg_engine.max_seq}")
        v = self.cfg.vocab_size
        if any(t < 0 or t >= v for t in ids):
            raise ValueError(f"prompt token ids must be ints in [0, {v})")
        if params.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")
        self._outputs[request_id] = []
        self.waiting.append(Request(request_id, ids, params))

    def has_unfinished(self) -> bool:
        return (len(self.waiting) > 0 or self._admitting is not None
                or any(s.active for s in self.slots))

    def get_outputs(self, request_id: str) -> List[RequestOutput]:
        out = self._outputs.get(request_id, [])
        if any(o.finished for o in out):
            self._outputs.pop(request_id, None)
        elif out:
            self._outputs[request_id] = []
        return out

    @torch.no_grad()
    def step(self) -> bool:
        """Advance admission by at most one prefill chunk, then run one
        batched decode step. Returns True if any work was done."""
        self._admission_step()
        active = [i for i, s in enumerate(self.slots) if s.active]
        if not active:
            return self._admitting is not None
        b = self.cfg_engine.max_batch
        tokens = torch.zeros((b,), dtype=torch.int64)
        for i in active:
            tokens[i] = self.slots[i].last_token
        logits, self.cache = llama_mod.forward(
            self.params, self.cfg, tokens.to(self.device)[:, None],
            self.cache)
        toks = self._sample(logits[:, -1, :], active)
        for i in active:
            s = self.slots[i]
            s.last_token = toks[i]
            s.generated.append(toks[i])
            self._emit(s)
            self._check_done(i)
        return True

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

    def _bucket(self, n: int) -> int:
        b = self.cfg_engine.prefill_bucket
        while b < n:
            b *= 2
        return min(b, self.cfg_engine.max_seq)

    def _admission_step(self) -> None:
        a = self._admitting
        if a is None:
            free = next((i for i, s in enumerate(self.slots)
                         if not s.active), None)
            if free is None or not self.waiting:
                return
            req = self.waiting.popleft()
            # the private cache is a chunk multiple >= the bucket, so no
            # chunk write straddles its end; _insert clips to max_seq
            bucket = self._bucket(len(req.prompt_token_ids))
            chunk = min(self._chunk, bucket)
            alloc = -(-bucket // chunk) * chunk
            cache1 = init_cache(self.cfg.num_hidden_layers, 1, alloc,
                                self.cfg.num_key_value_heads, self.cfg.hd,
                                device=self.device)
            a = self._admitting = _Admission(req, free, 0, cache1, chunk)

        plen = len(a.req.prompt_token_ids)
        part = a.req.prompt_token_ids[a.consumed:a.consumed + a.chunk]
        padded = torch.zeros((1, a.chunk), dtype=torch.int64)
        padded[0, :len(part)] = torch.tensor(part, dtype=torch.int64)
        logits, a.cache1 = llama_mod.forward(
            self.params, self.cfg, padded.to(self.device), a.cache1)
        start = a.consumed
        a.consumed += a.chunk
        if a.consumed < plen:
            return
        self._insert(a.cache1, a.slot_idx, plen)
        s = self.slots[a.slot_idx]
        s.req = a.req
        p = a.req.params
        s.seed = (int(p.seed) & 0x7FFFFFFF if p.seed is not None
                  else int(np.random.default_rng().integers(1 << 31)))
        s.generated = []
        first = self._sample_one(logits[:, plen - 1 - start], s, pos=0)
        s.generated = [first]
        s.last_token = first
        s.active = True
        self._emit(s)
        self._check_done(a.slot_idx)
        self._admitting = None

    def _insert(self, cache1: KVCache, slot: int, plen: int) -> None:
        """Splice a finished admission's K/V into the batched cache."""
        max_s = self.cache.k.shape[2]
        n = min(cache1.k.shape[2], max_s)
        self.cache.k[:, slot, :n] = cache1.k[:, 0, :n]
        self.cache.v[:, slot, :n] = cache1.v[:, 0, :n]
        self.cache.pos[slot] = plen

    def _sample_params(self, rows):
        b = len(rows)
        temps = torch.zeros((b,), dtype=torch.float32)
        top_ks = torch.zeros((b,), dtype=torch.int64)
        top_ps = torch.ones((b,), dtype=torch.float32)
        seeds, poss = [0] * b, [0] * b
        for j, s in enumerate(rows):
            if s is None:
                continue
            p = s.req.params
            temps[j], top_ks[j], top_ps[j] = p.temperature, p.top_k, p.top_p
            seeds[j] = s.seed
            poss[j] = len(s.generated)
        dev = self.device
        return temps.to(dev), top_ks.to(dev), top_ps.to(dev), seeds, poss

    def _sample(self, lg: torch.Tensor, active: List[int]) -> List[int]:
        rows = [self.slots[i] if i in active else None
                for i in range(len(self.slots))]
        if all(self.slots[i].req.params.temperature <= 0.0 for i in active):
            return torch.argmax(lg, dim=-1).tolist()
        temps, top_ks, top_ps, seeds, poss = self._sample_params(rows)
        return sample_rows(lg, temps, top_ks, top_ps, seeds, poss).tolist()

    def _sample_one(self, lg: torch.Tensor, s: _Slot, pos: int) -> int:
        temps, top_ks, top_ps, seeds, poss = self._sample_params([s])
        poss[0] = pos
        return int(sample_rows(lg, temps, top_ks, top_ps, seeds, poss)[0])

    def _emit(self, s: _Slot) -> None:
        self._outputs.setdefault(s.req.request_id, []).append(
            RequestOutput(s.req.request_id, [s.last_token], False))

    def _check_done(self, idx: int) -> bool:
        s = self.slots[idx]
        p = s.req.params
        tok = s.last_token
        reason = None
        if self.eos_token_id is not None and tok == self.eos_token_id:
            reason = "stop"
        elif tok in p.stop_token_ids:
            reason = "stop"
        elif len(s.generated) >= p.max_tokens:
            reason = "length"
        elif (len(s.req.prompt_token_ids) + len(s.generated) + 1
              >= self.cfg_engine.max_seq):
            reason = "length"
        if reason is None:
            return False
        self._outputs.setdefault(s.req.request_id, []).append(
            RequestOutput(s.req.request_id, [], True, reason))
        s.req = None
        s.active = False
        s.generated = []
        # reset the idle row's position so it stops deepening
        self.cache.pos[idx] = 0
        return True
