"""Continuous-batching serving engine, lean port of
``bigdl_tpu/serving/engine.py::LLMEngine`` (slab and paged KV modes, every
KV storage kind).

Kept: the public surface of ``SamplingParams`` (max_tokens, temperature,
top_k, top_p, stop_token_ids, seed), ``RequestOutput`` and
``EngineConfig`` (max_batch, max_seq, prefill_bucket, prefill_chunk,
kv_page_size, kv_pages, prefix_sharing, kv_cache_dtype, kv_quantized), and
``add_request`` / ``step`` / ``get_outputs`` / ``has_unfinished`` /
``generate`` / ``reset_prefix_cache``. Inside:

- KV storage (``kv_cache_dtype``): bf16, fp8_e5m2, or int8 / int4 codes
  with f32 scale planes that move wherever their codes move (splice,
  prefix seeding, copy-on-write); int8/int4 need a family with
  ``SUPPORTS_SCALED_KV``;
- slab mode: one batched KV cache [L, max_batch, max_seq, Hkv, hd] with a
  per-slot position vector; a slot is a sequence's home for its
  lifetime;
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
- a batched sampler: greedy argmax, or temperature / top-k / top-p by
  gumbel-max with noise from ``fold_in(PRNGKey(seed), position)``, the
  JAX engine's threefry stream (``ops/random.py``): seeded streams equal
  the JAX engine's up to one-ulp ties of its logs.

Not ported yet: penalties, logprobs, n/best_of, the host prefix cache,
preemption, overload control, deadlines, fault handling, migration and
observability.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.config import (flags, resolve_kv_page_size,
                                    resolve_kv_pages, resolve_prefix_sharing)
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


class LLMEngine:
    """Synchronous continuous-batching engine over one model: anything
    with ``.params``, ``.config``, ``.hf_config`` and ``.family``, the
    model module whose ``check_supported`` / ``forward`` / ``new_cache``
    (and, for paged KV, ``forward_paged`` / ``new_paged_cache`` with
    ``SUPPORTS_PAGED_KV``) the engine calls. Drive it with add_request() +
    step(), or generate()."""

    def __init__(self, model: Any, config: Optional[EngineConfig] = None,
                 device="cuda"):
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

    def reset_prefix_cache(self) -> None:
        """Drop every radix node; pages no live slot maps go free."""
        if self.radix is not None:
            self.radix.clear()

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
        tokens = tokens.to(self.device)[:, None]
        if self._paged:
            # copy-on-write barrier first (shared write pages get private
            # copies), then one decode through the block tables
            self._cow_step(active)
            logits, self.cache = self.family.forward_paged(
                self.params, self.cfg, tokens, self.cache, self._bt(),
                last_only=True)
        else:
            logits, self.cache = self.family.forward(self.params, self.cfg,
                                                     tokens, self.cache)
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
        # release the slot's pages (paged) and reset the idle row's
        # position so it stops deepening
        self._release_slot_pages(idx)
        self.cache.pos[idx] = 0
        return True
