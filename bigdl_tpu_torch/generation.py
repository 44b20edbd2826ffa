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

Not ported: the resident one-dispatch step (ROADMAP A7-resident) and
``generate_on_device`` (with it), beam search (A12), fault hooks (A16)
and multimodal prefill (``visual``, A13); each raises naming its item.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from bigdl_tpu_torch.models import llama as llama_mod
from bigdl_tpu_torch.ops import random as rnd
from bigdl_tpu_torch.ops.kvcache import resolve_kv_cache_dtype


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
    ninf = torch.tensor(float("-inf"), dtype=logits.dtype,
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


def generate_on_device(*args, **kwargs):
    raise NotImplementedError(
        "generate_on_device (the whole loop in one device program) is not "
        "ported; it comes with the resident decode step (ROADMAP "
        "A7-resident). Use Generator.generate")


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
        with torch.inference_mode():
            yield from self._stream(ids, gen, stats)

    def _stream(self, ids: np.ndarray, gen: GenerationConfig,
                stats: Optional[GenerationStats]):
        fam, p, cfg, dev = self.family, self.params, self.cfg, self.device
        b, s = ids.shape
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
