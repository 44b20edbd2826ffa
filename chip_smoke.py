"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, all of them on every run, each printing one JSON line:

1. device: name and power limit (nvidia-smi); fails without CUDA.
2. build: nvcc builds every kernel from ``bigdl_tpu_torch/csrc``.
3. kernels: each hand-written kernel (B1 dequant GEMV, B2 dequant GEMM,
   B3 decode attention, B4 prefill attention, B5 paged decode attention,
   B6 ragged expert matmul) against its plain PyTorch version on the card,
   at Llama-2-7B shapes (B4 also at Mixtral's GQA, B6 at Mixtral-8x7B's
   expert shapes under a prefill-chunk and a decode routing), with times
   of the kernel, the plain version and a PyTorch library yardstick, and
   the least time the card could take (bytes / 3.35 TB/s or flops / 989
   TFLOP/s). Every dequant-matmul case launches twice and must repeat
   its bits (a K split sums in a fixed order). B1's std body runs at M 1,
   8, 16 and 32 on the five Llama-2-7B linears (the small-M body at 1, 2
   and 4 n8 tiles of tokens), B2's std and i4 bodies (the Hopper body of
   dequant_wgmma.cuh) at M 33, 64, 100 and 128 on the same linears; timed
   cases report ps a dequantized weight beside the times. B6 takes the
   bound on a tile's real rows that the MoE layer passes (min(N * k,
   128)): its decode routings (2, 8 and 16 slots) run the small-M entry,
   its prefill routings (a skewed and a uniform 256-token chunk) the
   Hopper body; a dense bf16 stack (a bf16 Mixtral load) takes the same
   two entries (the Hopper body's prefill tiles with bf16 boxes as the
   wgmma A operand, the small-M body's decode tiles with 16-byte bf16
   loads), timed at gate/up under both chunks and a decode routing, with
   ``torch._grouped_mm`` as its yardstick, and counts its launches apart.
   B4 is also checked at the generator's prefill buckets, Sq 1024 and
   2048 at pos 0 of a 2048-row cache. B5 must also equal B3 bit for bit on the same rows laid out
   densely, and B6 each tile of B2 at B2's K split. B3, B4 and B5 run
   again over fp8_e5m2, int8 and int4 caches (codes and f32 scales; the
   yardstick dequantizes, then calls SDPA), timed at the main path's
   shapes, B5 bit-equal to B3 for each kind. B1's mxu, fold, mxuflat and
   mxu8 bodies (all on the small-M body) and B2's i4 body run against
   their own plain versions, timed on Llama-2-7B's gate_up (4096 x 22016)
   at M 1, 8, 16 and 32 (i4: 33, 100, 128) over the int4 layout (fold over
   the canonical sym_int4, nf4 and sym_int8, fp4 and nf3 at M 8; mxu8,
   which quantizes x inside its one launch, also over sym_int8), checked
   at M 17, at a K-padded shape and at N % 8 != 0; fold, mxuflat and mxu8
   must launch one small-M kernel a call on gate_up, whose K they split;
   mxu (M 1, 8, 16, 32) and i4 (M 33, 64, 100, 128; 33 and 100 timed),
   the load path's defaults, are also checked on each of the other four
   Llama-2-7B linears.
4. reference: a 2-layer cut of the full-width model, prefill + one decode
   step on the card (kernels) against the same on the CPU (plain).
4a. resident: the resident decode step (``BIGDL_TPU_TORCH_DECODE_RESIDENT``:
   one CUDA graph replay a step) against the eager step, in turns in one
   process, before any torch.profiler window: the engine phase's eight
   requests through a slab engine at each KV kind (bf16: eager, graph,
   graph, eager; the others eager, graph), ``Generator.generate`` at bs 1
   greedy and bs 4 sampled (eager, graph, graph, eager) and
   ``generate_on_device`` at bs 1 (its eager loop, then its graph). Every
   graph stream must equal the eager stream token for token, and a graph
   engine's every pure-decode step must be exactly one replay (none on a
   step that captured). Step and next-token ms of both paths, replays,
   each graph's capture ms and pool bytes are printed. Every later engine
   and generate phase runs the resident step too (the flag's default);
   launch counts include each replay's kernels.
5. engine: seeded full-width Llama-2-7B, sym_int4 linears, merged
   projections, through ``LLMEngine`` (max_batch 8, max_seq 2048): eight
   requests whose prompt lengths cover every kernel route, 32 new tokens
   each; every request must finish, greedy and seeded requests must repeat,
   and every kernel's launch count must rise during the run. A last pass
   of the same requests profiles a few pure-decode steps (device time by
   kernel group, launches, host launch calls, idle share; one B3 kernel a
   B3 call and at most one small-M kernel a B1 call, of any body) under
   the graph, and the same window again with the eager step
   (``decode_profile_eager``).
5a. server: the engine phase's eight requests through the port's
   ``OpenAIServer`` (``serving/api_server.py``) on 127.0.0.1, port 0, over
   a fresh slab engine (max_batch 8, max_seq 2048), each request from a
   client thread of its own and all sent at once, first non-streamed, then
   streamed (SSE): every stream must equal the engine phase's token for
   token. Then a logprobs=5 greedy request (the same tokens; top-1 logprob
   the chosen token's), an n=2 seeded request (two choices), a
   repetition_penalty=1.8 request twice (it repeats), a client that drops
   mid-stream (the engine aborts it and goes idle), /metrics (every ported
   family) and /v1/stats; the engine loop must raise nothing, and B1-B4
   must launch. A second server over the paged engine (kv_page_size 128,
   sharing on) serves the four shared-prefix requests of phase 6 at once:
   streams equal the slab engine's, 3 radix hits, B5 launches. Client
   latencies and TTFT (streamed) and the server engine's pure-decode step
   time are printed beside the engine phase's.
5b. prefill_profile: torch.profiler over one prefill of a 100-token
   prompt (B2 takes its linears) through a fresh engine, after a warm-up
   prefill: device time by kernel group, idle share, launches. Phase 15b
   does the same for one 256-token Mixtral chunk (B6's prefill tiles, and
   the dequantize-then-matmul path of the linears past 128 rows, read from
   its profiler range).
6. engine_paged: the same eight requests through the paged engine
   (kv_page_size 128, sharing off), then four requests sharing a
   1024-token prefix with radix sharing on: greedy and seeded streams must
   equal the slab engine's, and B5 must launch.
7. prefix_burst: 32 requests of one 1024-token prefix plus one unique
   token in a 129-page arena (the bytes of the 8-slot slab) at max_batch
   32: all 32 must be active at once, the radix must hit 31 times, the
   pool must never run dry, and copy-on-write must copy.
8. reference_kv: the reference cut over an int8 and an int4 KV cache.
9. engine_kv: the engine phase's eight requests through the slab engine
   with a fp8_e5m2, an int8 and an int4 KV cache (one engine each, run
   twice), then the four shared-prefix requests: every request finishes,
   streams repeat, the kind's B3 and B4 bodies launch, and the cache
   holds the bytes of the formula; peak memory, step time, TTFT, a
   profiled decode window and agreement with the bf16 streams are
   reported.
10. engine_paged_kv: the shared-prefix requests through the paged engine
   with fp8_e5m2, int8 and int4 pages (kv_page_size 128, sharing on):
   streams must equal the slab engine's at the same kind, the radix must
   hit 3 times, copy-on-write must copy, and B5's body for the kind must
   launch.
11. reference_prepack: the load entry point. The 2-layer cut is written
   with ``save_low_bit`` and loaded with
   ``AutoModelForCausalLM.load_low_bit(device="cuda")``, whose prepack
   relays every sym_int4 leaf into the int4 layout: every leaf must relay
   back to the saved bytes, the card forward must run the mxu (decode) and
   i4 (prefill) bodies and no std B1/B2 body, and its logits must agree
   with the CPU's plain versions as in the reference phase.
12. engine_prepack: the eight requests once under matmul_gemv ``fold`` on
   the canonical model (the fold body must launch); then the full model
   becomes ``TpuCausalLM(params)``, prepacked in place on the card (load
   time and peak memory reported), and ``LLMEngine(model)`` serves the
   eight requests twice and a profiled decode window: every request
   finishes, streams repeat, mxu and i4 launch and std B1/B2 do not, peak
   memory is within 1% of the engine phase's; then once under
   ``mxuflat`` and once under ``mxu8`` (each body must launch; the fold
   and mxuflat passes profile a decode window: small-M kernels, at most
   one a B1 call).
12b. hf_load: the README's Quick start entry. A Llama-2-7B float
   checkpoint (full width, 4 layers, bf16, sharded under an index, seeded
   weights) is written with ``write_safetensors`` and loaded with
   ``from_pretrained(load_in_4bit=True)``, then at nf4 and bf16: load
   time and peak device memory (at most four f32 copies of the largest
   tensor above the final parameters), every quantized leaf with the
   prepack undone byte-equal to the port's quantize on the CPU, and the
   2-layer cut's logits against the CPU's as in the reference phase.
12c. generate: the full model as a ``TpuCausalLM`` through ``generate``:
   bs 1 greedy at prompts of 16, 100 and 1000 tokens, bs 4 seeded
   sampling, the same with a repetition penalty through
   ``model.generator``, and ``generate_stream``; each twice, tokens
   repeating; B1 at M 1 and 4, B3 once a layer each decode forward, B2
   and B4 at the 100-token bucket, B4 and the dequantize-then-matmul path
   at the 1000-token one; the 2-layer cut's greedy stream teacher-forced
   on the CPU (each chosen token within 5% of the logit range of the
   CPU's best); TTFT, next-token ms, tokens/s and peak memory at bs 1.
12d. hf_load_moe: after the Llama model is freed, a Mixtral-8x7B float
   checkpoint (full width, 1 layer) loaded at sym_int4 and at bf16: a
   256-token prefill and a decode step each, then a decode forward of 8
   sequences; B6 launches in the prefill (the tiles entry) and in the
   8-sequence decode (the small-M entry) at both qtypes, counted as its
   dense body at bf16.
13. model_moe: the Llama model is freed, and full-width, full-depth
   Mixtral-8x7B (sym_int4 linears, random weights from seed 0) is built
   on the card.
14. reference_moe: a 2-layer cut, 8 prompts of 32 tokens then one decode
   step (both through B6) on the card, against the same on the CPU with
   the ragged dispatch on B6's plain version.
14a. resident_moe: Mixtral's decode as a graph against the eager step
   (eager, then graph): the engine phase's eight requests at max_batch 8
   (the ragged dispatch: B6 in the graph) and four greedy ones at
   max_batch 4 (the gathered experts: B1 in the graph, no B6); streams
   equal the eager step's, one replay a pure-decode step.
15. engine_moe: the engine phase's eight requests through ``LLMEngine``
   serving Mixtral, twice: every request finishes, greedy and seeded
   streams repeat, B1-B4 and B6 launch, B6 in prefill and in decode; then
   a profiled decode window.
15b. prefill_profile (Mixtral): see 5b.
16. engine_moe_gather: four greedy requests at max_batch 4, so decode
   gathers the chosen experts (N * k = 8 <= E): streams repeat, and B1
   launches during decode-only steps while B6 does not.

Then a ``kernels`` summary line (every kernel, each quantized-KV body of
B3, B4 and B5 as an entry of its own), the card's name and power limit,
and the final ``{"ok": true, "device": ...}`` line. Any failed check exits
non-zero before the final line is printed. Imports torch, numpy and the port only.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

PEAK_BYTES_S = 3.35e12        # H100 SXM HBM3
PEAK_BF16_FLOPS = 989e12      # H100 SXM dense bf16 tensor cores
MATMUL_TOL = 2e-2             # kernel vs plain, bf16 output (~2 ulp at 1)
ATTN_TOL = 2e-2               # kernel vs plain, bf16 output, f32 softmax

LLAMA2_7B_LINEARS = {          # [K, N] of each merged linear
    "qkv_proj": (4096, 12288),
    "o_proj": (4096, 4096),
    "gate_up_proj": (4096, 22016),
    "down_proj": (11008, 4096),
    "lm_head": (4096, 32000),
}

KERNELS = {
    "dequant_gemv": dict(
        source="bigdl_tpu_torch/csrc/dequant_gemv.cu",
        replaces="bigdl_tpu/ops/pallas/dequant_matmul.py:473"),
    "dequant_gemm": dict(
        source="bigdl_tpu_torch/csrc/dequant_gemm.cu",
        replaces="bigdl_tpu/ops/pallas/dequant_matmul.py:641"),
    # B1's and B2's other bodies: the int4 layout a load prepacks sym_int4
    # weights into (mxu: the decode default of a loaded model; i4: its
    # prefill chunks) and the flag-selected bodies
    "dequant_gemv_mxu": dict(
        source="bigdl_tpu_torch/csrc/dequant_variants.cu",
        replaces="bigdl_tpu/ops/pallas/dequant_matmul.py:234"),
    "dequant_gemv_fold": dict(
        source="bigdl_tpu_torch/csrc/dequant_variants.cu",
        replaces="bigdl_tpu/ops/pallas/dequant_matmul.py:172"),
    "dequant_gemv_mxuflat": dict(
        source="bigdl_tpu_torch/csrc/dequant_variants.cu",
        replaces="bigdl_tpu/ops/pallas/dequant_matmul.py:265"),
    "dequant_gemv_mxu8": dict(
        source="bigdl_tpu_torch/csrc/dequant_variants.cu",
        replaces="bigdl_tpu/ops/pallas/dequant_matmul.py:284"),
    "dequant_gemm_i4": dict(
        source="bigdl_tpu_torch/csrc/dequant_gemm.cu",
        replaces="bigdl_tpu/ops/pallas/dequant_matmul.py:133"),
    "decode_attention": dict(
        source="bigdl_tpu_torch/csrc/decode_attention.cu",
        replaces="bigdl_tpu/ops/pallas/decode_attention.py:201"),
    "prefill_attention": dict(
        source="bigdl_tpu_torch/csrc/prefill_attention.cu",
        replaces="bigdl_tpu/ops/pallas/prefill_attention.py:194"),
    "paged_decode_attention": dict(
        source="bigdl_tpu_torch/csrc/paged_decode_attention.cu",
        replaces="bigdl_tpu/ops/pallas/paged_decode_attention.py:129"),
    "ragged_expert_matmul": dict(
        source="bigdl_tpu_torch/csrc/moe_dispatch.cu",
        replaces="bigdl_tpu/ops/pallas/moe_dispatch.py:90"),
    # B6 over a dense bf16 expert stack (a bf16 Mixtral load): the same two
    # entries (dequant_wgmma.cuh, dequant_smallm.cuh), its own launch count
    "ragged_expert_matmul_dense": dict(
        source="bigdl_tpu_torch/csrc/moe_dispatch.cu",
        replaces="bigdl_tpu/ops/pallas/moe_dispatch.py:84"),
}

# the quantized-KV bodies of B3, B4 and B5: each storage kind counts its own
# launches (``<name>_<kind>``); fp8_e5m2 replaces the bf16 body's e5m2
# input, int8 and int4 the scaled body
QUANT_KV_KINDS = ("fp8_e5m2", "int8", "int4")
_KV_BODIES = {
    "decode_attention": ("decode_attention.py:80", "decode_attention.py:127"),
    "prefill_attention": ("prefill_attention.py:34",
                          "prefill_attention.py:82"),
    "paged_decode_attention": ("paged_decode_attention.py:40",
                               "paged_decode_attention.py:84"),
}
for _base, (_fp8, _scaled) in _KV_BODIES.items():
    for _kind in QUANT_KV_KINDS:
        KERNELS[f"{_base}_{_kind}"] = dict(
            source=KERNELS[_base]["source"],
            replaces="bigdl_tpu/ops/pallas/"
            + (_fp8 if _kind == "fp8_e5m2" else _scaled))

MIXTRAL_EXPERT_LINEARS = {     # [K, N] of each expert projection
    "gate_up": (4096, 14336),
    "down": (14336, 4096),
}


class SmokeFailure(RuntimeError):
    pass


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def require(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def bound_ms(nbytes: float, flops: float):
    tb = nbytes / PEAK_BYTES_S
    tf = flops / PEAK_BF16_FLOPS
    return (max(tb, tf) * 1e3, "bytes" if tb >= tf else "operations")


class Timer:
    """Per-launch CUDA-event timing with the 50 MB L2 flushed before each
    launch (the main path meets its weights and caches cold). A spin on
    the card after the flush keeps it busy while the host enqueues the
    call, so the events time the device, not the Python wrapper. The
    median of the launches is kept: a host stall longer than the spin
    (the host CPU is shared) lands in one launch's events, and a mean
    took it in (one B6 case read 0.88 ms against its usual 0.70)."""

    def __init__(self, device):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)

    def ms(self, fn, iters: int = 10) -> float:
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(1_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))


def max_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got.float() - want.float()).abs().max())


def allclose(got, want, tol) -> bool:
    g, w = got.float(), want.float()
    return bool(torch.isfinite(g).all()) and bool(
        ((g - w).abs() <= tol + tol * w.abs()).all())


# -- phases --------------------------------------------------------------------


def phase_device():
    if not torch.cuda.is_available():
        raise SmokeFailure("torch.cuda.is_available() is false: no GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    emit({"phase": "device", "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "nvidia_smi": card,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0]})
    return card


def phase_build():
    from bigdl_tpu_torch import _native

    t0 = time.perf_counter()
    paths = _native.build_all()
    for name in _native.SOURCES:
        _native.kernel(name)
    emit({"phase": "build", "seconds": round(time.perf_counter() - t0, 3),
          "libraries": {k: v.split("bigdl_tpu_torch/")[-1]
                        for k, v in paths.items()}})


def _matmul_case(timer, name, x, w, kernel_fn, iters, plain_fn=None):
    from bigdl_tpu_torch.ops.cuda.dequant_matmul import plain_q_matmul
    from bigdl_tpu_torch.ops.quant import dequantize

    plain_fn = plain_fn or plain_q_matmul
    got = kernel_fn(x, w)
    again = kernel_fn(x, w)
    want = plain_fn(x, w)
    torch.cuda.synchronize()
    err = max_err(got, want)
    # a K split sums in a fixed order: two launches give the same bits
    repeats = bool(torch.equal(got, again))
    ok = allclose(got, want, MATMUL_TOL) and repeats
    m, k = x.shape
    n = w.n
    nbytes = (m * k * 2 + w.nbytes + m * n * 2)
    b_ms, b_by = bound_ms(nbytes, 2.0 * m * k * n)
    rec = {"kernel": name, "qtype": w.qtype, "layout": w.layout, "M": m,
           "K": k, "N": n, "max_abs_err": err, "tol": MATMUL_TOL, "ok": ok,
           "repeat_bit_identical": repeats,
           "bound_ms": b_ms, "bound_by": b_by}
    if iters:
        dense = dequantize(w, torch.bfloat16)
        rec["ms"] = timer.ms(lambda: kernel_fn(x, w), iters)
        # the time a dequantized weight takes, read the same way for B2
        # and B6 (ps)
        rec["ps_per_weight"] = rec["ms"] * 1e9 / (k * n)
        rec["plain_ms"] = timer.ms(lambda: plain_fn(x, w), iters)
        # library yardstick: dequantize to bf16, then one cuBLAS GEMM; and
        # the GEMM alone on the pre-dequantized weight (a dense bf16 layer)
        rec["library_ms"] = timer.ms(
            lambda: torch.matmul(x, dequantize(w, torch.bfloat16)), iters)
        rec["matmul_only_ms"] = timer.ms(lambda: torch.matmul(x, dense),
                                         iters)
        del dense
    return rec


_CODE_BYTES = {"bf16": 2.0, "fp8_e5m2": 1.0, "int8": 1.0, "int4": 0.5}


def _kv_row_bytes(hd, kind):
    """Bytes one (row, kv head) of K or V stores: its codes, and its f32
    scale for int8/int4."""
    return hd * _CODE_BYTES[kind] + (4 if kind in ("int8", "int4") else 0)


def _kv_codes(x, kind):
    """Random f32 rows -> the cache's codes of storage `kind` (and the f32
    scales of int8/int4), as the engine's appends store them."""
    from bigdl_tpu_torch.ops.kvcache import quantize_kv

    xb = x.to(torch.bfloat16)
    if kind == "bf16":
        return xb, None
    if kind == "fp8_e5m2":
        return xb.to(torch.float8_e5m2), None
    return quantize_kv(xb, kind)


def _attn_bounds(q, k, pos_list, sq, kind="bf16"):
    b, _, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    vis_rows = 0          # K/V rows read once per (slot, kv head)
    pairs = 0             # visible (query, key) pairs
    for p in pos_list:
        vis_rows += min(s, p + sq)
        pairs += sum(min(s, p + i + 1) for i in range(sq))
    nbytes = 2 * q.numel() * 2 + vis_rows * hkv * _kv_row_bytes(hd, kind) * 2
    flops = 4.0 * hd * h * pairs
    return bound_ms(nbytes, flops)


def _sdpa(q, k, v, pos_list, sq, ks=None, vs=None):
    """One torch.nn.functional.scaled_dot_product_attention call computing
    the same causal attention, after dequantizing a quantized cache
    (timing yardstick only)."""
    import torch.nn.functional as F

    from bigdl_tpu_torch.ops.kvcache import dequantize_kv

    b, _, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    kid = torch.arange(s, device=q.device)
    qid = torch.tensor(pos_list, device=q.device)[:, None] + torch.arange(
        sq, device=q.device)[None]
    mask = (kid[None, None, :] <= qid[:, :, None])[:, None]   # [B,1,Sq,S]
    qt = q.transpose(1, 2)

    def call():
        kt = dequantize_kv(k, ks).transpose(1, 2)
        vt = dequantize_kv(v, vs).transpose(1, 2)
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=(h != hkv))

    try:
        call()
    except TypeError:           # a torch without enable_gqa: no yardstick
        return None
    return call


def _attn_case(timer, randn, name, b, sq, h, hkv, hd, s, pos_list, timed,
               kind="bf16"):
    """One attention kernel against the plain version on the same inputs
    (a cache of storage `kind`); decode takes per-slot positions, prefill
    one scalar position."""
    from bigdl_tpu_torch.ops.cuda.decode_attention import (counter,
                                                           decode_attention,
                                                           plain_attention)
    from bigdl_tpu_torch.ops.cuda.prefill_attention import prefill_attention

    fn = decode_attention if name == "decode_attention" else \
        prefill_attention
    q = randn(b, sq, h, hd).to(torch.bfloat16)
    kc, ks = _kv_codes(randn(b, s, hkv, hd), kind)
    vc, vs = _kv_codes(randn(b, s, hkv, hd), kind)
    per_slot = name == "decode_attention"
    pos = torch.tensor(pos_list if per_slot else pos_list[0],
                       dtype=torch.int32, device=q.device)
    scale = hd ** -0.5
    got = fn(q, kc, vc, pos, scale, ks, vs)
    again = fn(q, kc, vc, pos, scale, ks, vs)
    want = plain_attention(q, kc, vc, pos, scale, ks, vs)
    torch.cuda.synchronize()
    # the decode body merges its spans in a fixed order: the bits repeat
    repeats = bool(torch.equal(got, again))
    b_ms, b_by = _attn_bounds(q, kc, pos_list * (b // len(pos_list)), sq,
                              kind)
    rec = {"kernel": counter(name, kind), "kv": kind, "B": b, "Sq": sq,
           "H": h, "Hkv": hkv, "hd": hd, "S": s,
           "pos": pos_list if per_slot else pos_list[0],
           "max_abs_err": max_err(got, want), "tol": ATTN_TOL,
           "repeat_bit_identical": repeats,
           "ok": allclose(got, want, ATTN_TOL) and repeats,
           "bound_ms": b_ms, "bound_by": b_by}
    if timed:
        lib = _sdpa(q, kc, vc, pos_list * (b // len(pos_list)), sq, ks, vs)
        rec.update(ms=timer.ms(lambda: fn(q, kc, vc, pos, scale, ks, vs)),
                   plain_ms=timer.ms(
                       lambda: plain_attention(q, kc, vc, pos, scale, ks,
                                               vs)),
                   library_ms=timer.ms(lib) if lib else None)
    return rec


def _paged_case(timer, randn, gen, b, h, hkv, hd, ps, np_, pos_list, timed,
                kind="bf16"):
    """B5 against its plain version over a random page permutation of an
    arena of storage `kind`, and against B3 over the same rows (and
    scales) gathered densely (must be bit-equal). The last row is idle: an
    all-null table row, pos past NP * ps."""
    import torch.nn.functional as F

    from bigdl_tpu_torch.ops.cuda.decode_attention import (counter,
                                                           decode_attention)
    from bigdl_tpu_torch.ops.cuda.paged_decode_attention import (
        paged_decode_attention, plain_paged_attention)
    from bigdl_tpu_torch.ops.kvcache import dequantize_kv
    from bigdl_tpu_torch.ops.paged import _gather_dense

    dev = gen.device
    p_ = b * np_ + 1
    q = randn(b, 1, h, hd).to(torch.bfloat16)
    ak, aks = _kv_codes(randn(p_, ps, hkv, hd), kind)
    av, avs = _kv_codes(randn(p_, ps, hkv, hd), kind)
    perm = torch.randperm(p_ - 1, generator=gen, device=dev) + 1
    bt = perm[:b * np_].reshape(b, np_).to(torch.int32).contiguous()
    bt[-1] = 0
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    scale = hd ** -0.5

    def dense(t):
        return None if t is None else _gather_dense(t, bt).contiguous()

    got = paged_decode_attention(q, ak, av, bt, pos, scale, aks, avs)
    again = paged_decode_attention(q, ak, av, bt, pos, scale, aks, avs)
    want = plain_paged_attention(q, ak, av, bt, pos, scale, aks, avs)
    kd, vd, ksd, vsd = dense(ak), dense(av), dense(aks), dense(avs)
    b3 = decode_attention(q, kd, vd, pos, scale, ksd, vsd)
    torch.cuda.synchronize()
    repeats = bool(torch.equal(got, again))
    s = np_ * ps
    vis = [min(p + 1, s) for p in pos_list]
    nbytes = (2 * q.numel() * 2 + sum(vis) * hkv * _kv_row_bytes(hd, kind) * 2
              + bt.numel() * 4 + pos.numel() * 4)
    b_ms, b_by = bound_ms(nbytes, 4.0 * hd * h * sum(vis))
    rec = {"kernel": counter("paged_decode_attention", kind), "kv": kind,
           "B": b, "H": h, "Hkv": hkv,
           "hd": hd, "ps": ps, "NP": np_, "P": p_, "pos": pos_list,
           "max_abs_err": max_err(got, want), "tol": ATTN_TOL,
           "equal_to_b3": bool(torch.equal(got, b3)),
           "repeat_bit_identical": repeats,
           "ok": allclose(got, want, ATTN_TOL) and repeats
           and bool(torch.equal(got, b3)),
           "bound_ms": b_ms, "bound_by": b_by}
    if timed:
        kid = torch.arange(s, device=dev)
        mask = (kid[None, :] <= pos[:, None].long())[:, None, None, :]
        qt = q.transpose(1, 2)

        def library():
            # the dense gather (and dequantization), then one SDPA
            kg = dequantize_kv(_gather_dense(ak, bt), dense(aks))
            vg = dequantize_kv(_gather_dense(av, bt), dense(avs))
            return F.scaled_dot_product_attention(
                qt, kg.transpose(1, 2), vg.transpose(1, 2), attn_mask=mask,
                enable_gqa=(h != hkv))

        try:
            library()
        except TypeError:       # a torch without enable_gqa: no yardstick
            library = None
        rec.update(
            ms=timer.ms(lambda: paged_decode_attention(q, ak, av, bt, pos,
                                                       scale, aks, avs)),
            b3_ms=timer.ms(lambda: decode_attention(q, kd, vd, pos, scale,
                                                    ksd, vsd)),
            plain_ms=timer.ms(lambda: plain_paged_attention(
                q, ak, av, bt, pos, scale, aks, avs)),
            library_ms=timer.ms(library) if library else None)
    return rec


def _stack_q(randn, e, k, n, qtype):
    """An [E, K, N] stack of quantized random experts."""
    from bigdl_tpu_torch.ops.quant import QTensor, quantize

    ws = [quantize(randn(k, n, scale=0.02), qtype) for _ in range(e)]
    return QTensor(torch.stack([w.data for w in ws]),
                   torch.stack([w.scale for w in ws]),
                   None if ws[0].zero is None
                   else torch.stack([w.zero for w in ws]), qtype,
                   ws[0].shape)


def _prefill_routing(dev):
    """A 256-token prefill chunk, top-2 of 8 experts, skewed: expert 0
    takes 200 choices (two tiles), expert 7 none; Np 1536."""
    topi = [(0, 1 + i % 6) if i < 200 else (1 + i % 6, 1 + (i + 1) % 6)
            for i in range(256)]
    return torch.tensor(topi, dtype=torch.int64, device=dev)


def _uniform_routing(dev):
    """A 256-token prefill chunk, top-2 of 8 experts, uniform: 64 choices
    an expert (8 tiles of 64 rows); Np 1024."""
    return torch.tensor([(i % 8, (i + 4) % 8) for i in range(256)],
                        dtype=torch.int64, device=dev)


def _decode_routing(gen, dev, n=8, e=8):
    """An n-slot decode step, top-2 of e experts at random; Np 1152."""
    return torch.stack([torch.randperm(e, generator=gen, device=dev)[:2]
                        for _ in range(n)])


def _grouped_library(x, r, num_experts):
    """One PyTorch call computing the ragged product on a dequantized
    [E, K, N] stack (timing yardstick only): torch._grouped_mm over the
    expert regions where this torch has it, else a torch.matmul per tile.
    Returns (name, fn(dense) -> y)."""
    t = 128
    te = r.tile_expert.tolist()
    # each expert's padded region (its tiles that hold rows; the trailing
    # tiles hold none and stay out of the call), as cumulative row ends
    per_e = [0] * num_experts
    for e_, n_ in zip(te, r.tile_rows.tolist()):
        if n_:
            per_e[e_] += t
    ends = np.cumsum(per_e).tolist()
    offs = torch.tensor(ends, dtype=torch.int32, device=x.device)

    def grouped(dense):
        return torch._grouped_mm(x, dense, offs=offs)

    def loop(dense):
        return torch.cat([x[i * t:(i + 1) * t] @ dense[e_]
                          for i, e_ in enumerate(te)])

    if hasattr(torch, "_grouped_mm"):
        try:
            dense0 = torch.zeros((num_experts, x.shape[1], 8),
                                 dtype=torch.bfloat16, device=x.device)
            grouped(dense0)
            return "torch._grouped_mm", grouped
        except (RuntimeError, TypeError):
            pass
    return "torch.matmul per tile", loop


def _ragged_case(timer, randn, routing, rname, lname, w, iters,
                 b2_check=False):
    """B6 against its plain version on a token buffer laid out by the
    port's own routing (real rows random, padding rows zero). The bound
    counts what the routing needs: the real rows of x, all of y, the
    packed planes of the experts that hold rows, and the real rows'
    flops (the padded buffer's flops are reported beside it)."""
    from bigdl_tpu_torch.ops.cuda.dequant_matmul import (_kind, _split_k,
                                                         dequant_gemm)
    from bigdl_tpu_torch.ops.cuda.moe_dispatch import (
        _launch, plain_ragged_expert_matmul, ragged_entry,
        ragged_expert_matmul)
    from bigdl_tpu_torch.ops.moe_dispatch import ragged_routing
    from bigdl_tpu_torch.ops.quant import QTensor, dequantize

    quantized = isinstance(w, QTensor)
    if quantized:
        num_e, k, n, nbytes_w = w.data.shape[0], w.k, w.n, w.nbytes
    else:
        num_e, k, n = w.shape
        nbytes_w = w.numel() * w.element_size()
    r = ragged_routing(routing, num_e)
    x = torch.zeros((r.np_, k), dtype=torch.bfloat16, device=routing.device)
    x[r.dest] = randn(len(r.dest), k).to(torch.bfloat16)
    te, tr = r.tile_expert, r.tile_rows
    nk = routing.numel()
    # the static bound moe_mlp_ragged passes: decode takes the small-M entry
    rows = min(nk, 128)

    def b6():
        return ragged_expert_matmul(x, w, te, tr, max_tile_rows=rows)

    got = b6()
    again = b6()
    want = plain_ragged_expert_matmul(x, w, te)
    torch.cuda.synchronize()
    repeats = bool(torch.equal(got, again))
    used = sorted({e_ for e_, rows in zip(te.tolist(), tr.tolist()) if rows})
    nbytes = nk * k * 2 + r.np_ * n * 2 + len(used) * nbytes_w // num_e
    b_ms, b_by = bound_ms(nbytes, 2.0 * nk * k * n)
    rec = {"kernel": "ragged_expert_matmul" if quantized
           else "ragged_expert_matmul_dense",
           "qtype": w.qtype if quantized else "bf16",
           "routing": rname,
           "linear": lname, "tokens": routing.shape[0], "E": num_e,
           "Np": r.np_, "K": k, "N": n, "tile_expert": te.tolist(),
           "tile_rows": tr.tolist(), "experts_with_rows": len(used),
           "max_tile_rows": rows, "entry": ragged_entry(w, rows),
           "max_abs_err": max_err(got, want), "tol": MATMUL_TOL,
           "repeat_bit_identical": repeats,
           "ok": allclose(got, want, MATMUL_TOL) and repeats,
           "bound_ms": b_ms, "bound_by": b_by,
           "flops_real_rows": 2.0 * nk * k * n,
           "flops_padded": 2.0 * r.np_ * k * n,
           "bound_ms_padded_flops": bound_ms(nbytes,
                                             2.0 * r.np_ * k * n)[0]}
    if b2_check:
        # B6 at B2's K split equals B2 on each real tile, bit for bit
        sp = _split_k("dequant_gemm", 128, n, w.kp, _kind(w), 1, x.device)
        y6 = _launch(x, w, te, tr, split=sp)
        same = [bool(torch.equal(
            dequant_gemm(x[i * 128:(i + 1) * 128], w.index(e_)),
            y6[i * 128:(i + 1) * 128]))
            for i, (e_, rows) in enumerate(zip(te.tolist(), tr.tolist()))
            if rows]
        rec["b2_split"] = list(sp)
        rec["equal_to_b2_per_tile"] = same
        rec["ok"] = rec["ok"] and all(same)
    if iters:
        def dequant_all():
            if not quantized:
                return w
            return torch.stack([dequantize(w.index(e_), torch.bfloat16)
                                for e_ in range(num_e)])

        dense = dequant_all()
        lib_name, lib = _grouped_library(x, r, num_e)
        real = r.tile_rows.repeat_interleave(128) > (
            torch.arange(r.np_, device=x.device) % 128)
        rec["library"] = lib_name
        rec["library_max_abs_err"] = max_err(lib(dense)[real], want[real])
        rec["ms"] = timer.ms(b6, iters)
        # per dequantized weight: every tile holding rows dequantizes its
        # expert once
        tiles = sum(1 for c in tr.tolist() if c)
        rec["ps_per_weight"] = rec["ms"] * 1e9 / (tiles * k * n)
        rec["plain_ms"] = timer.ms(
            lambda: plain_ragged_expert_matmul(x, w, te), iters)
        rec["library_ms"] = timer.ms(lambda: lib(dequant_all()), iters)
        rec["matmul_only_ms"] = timer.ms(lambda: lib(dense), iters)
        del dense
    return rec


def phase_kernels(timer):
    from bigdl_tpu_torch.ops.cuda.dequant_matmul import (dequant_gemm,
                                                         dequant_gemv)
    from bigdl_tpu_torch.ops.quant import quantize

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    records = []

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    # B1 / B2 at the five Llama-2-7B linear shapes, sym_int4: B1 (the
    # small-M body) at 1, 2 and 4 n8 tiles of tokens, B2 (the Hopper body)
    # at both token widths, with ragged edges (33, 100)
    for lname, (k, n) in LLAMA2_7B_LINEARS.items():
        w = quantize(randn(k, n, scale=0.02), "sym_int4")
        for m, fn, kname in ((1, dequant_gemv, "dequant_gemv"),
                             (8, dequant_gemv, "dequant_gemv"),
                             (16, dequant_gemv, "dequant_gemv"),
                             (32, dequant_gemv, "dequant_gemv"),
                             (33, dequant_gemm, "dequant_gemm"),
                             (64, dequant_gemm, "dequant_gemm"),
                             (100, dequant_gemm, "dequant_gemm"),
                             (128, dequant_gemm, "dequant_gemm")):
            x = randn(m, k).to(torch.bfloat16)
            rec = _matmul_case(timer, kname, x, w, fn, iters=10)
            rec["linear"] = lname
            records.append(rec)
            emit({"phase": "kernels", **rec})
        del w
    # every ported qtype at a small, K-padded shape
    for qtype in ("sym_int4", "asym_int4", "sym_int8", "nf4", "fp4", "nf3"):
        w = quantize(randn(1000, 512, scale=0.05), qtype)
        for m, fn, kname in ((8, dequant_gemv, "dequant_gemv"),
                             (96, dequant_gemm, "dequant_gemm")):
            x = randn(m, 1000).to(torch.bfloat16)
            rec = _matmul_case(timer, kname, x, w, fn, iters=0)
            records.append(rec)
            emit({"phase": "kernels", **rec})

    # the int4-layout and scale-folded bodies (B1 mxu, fold, mxuflat,
    # mxu8; B2 i4), each against its own plain version: timed on
    # Llama-2-7B's gate_up at the decode batch (B2: a 128-row prefill
    # chunk), fold also over nf4 and sym_int8 and mxu8 over sym_int8
    records += _variant_cases(timer, randn)

    # geometry the timed cases do not reach: two m-tiles, and the 4-column
    # loads B1 takes when N % 16 != 0
    for m, k, n in ((20, 4096, 4096), (8, 640, 260)):
        w = quantize(randn(k, n, scale=0.02), "sym_int4")
        x = randn(m, k).to(torch.bfloat16)
        rec = _matmul_case(timer, "dequant_gemv", x, w, dequant_gemv, iters=0)
        records.append(rec)
        emit({"phase": "kernels", **rec})

    # B3: slab decode attention, per-slot positions; B4: prefill flash
    # attention, scalar positions. Timed at Llama-2-7B geometry, checked
    # only at the other head dims and groups the kernels are built for.
    rng = np.random.default_rng(7)
    cases = []
    for h, hkv in ((32, 32), (32, 8)):
        pos_list = [int(p) for p in rng.integers(1, 2048, 8)]
        pos_list[0] = 2047
        cases.append(("decode_attention", 8, 1, h, hkv, 128, 2048, pos_list,
                      True))
    for hd in (64, 256):
        cases.append(("decode_attention", 4, 1, 8, 2, hd, 256,
                      [255, 3, 130, 0], False))
    for sq, smax, p0 in ((128, 128, 0), (128, 2048, 0), (256, 1024, 0),
                         (256, 2048, 256)):
        cases.append(("prefill_attention", 1, sq, 32, 32, 128, smax, [p0],
                      True))
    # Mixtral-8x7B's GQA (32 query heads on 8 kv heads) at a 256-token chunk
    cases.append(("prefill_attention", 1, 256, 32, 8, 128, 2048, [256], True))
    # the generator's prefill: a 1024- or 2048-token bucket at position 0
    # of a 2048-row cache (the plan spans keys past the bucket; they leave)
    for sq in (1024, 2048):
        cases.append(("prefill_attention", 1, sq, 32, 32, 128, 2048, [0],
                      False))
    for hd in (64, 256):
        cases.append(("prefill_attention", 2, 128, 8, 2, hd, 384, [128],
                      False))
    for case in cases:
        rec = _attn_case(timer, randn, *case)
        records.append(rec)
        emit({"phase": "kernels", **rec})

    # B5: paged decode over a 128-row-page arena, Llama-2-7B heads, NP 16
    # (max_seq 2048); the last row idle. Checked only at the other head
    # dims and page sizes.
    for b, h, hkv in ((8, 32, 32), (8, 32, 8), (32, 32, 32)):
        pos_list = [int(p) for p in rng.integers(1, 2048, b)]
        pos_list[0] = 2047
        pos_list[-1] = 2048 + 37
        rec = _paged_case(timer, randn, gen, b, h, hkv, 128, 128, 16,
                          pos_list, True)
        records.append(rec)
        emit({"phase": "kernels", **rec})
    for hd, ps in ((64, 128), (256, 256)):
        rec = _paged_case(timer, randn, gen, 4, 8, 2, hd, ps, 2,
                          [2 * ps - 1, 3, ps + 2, 2 * ps + 5], False)
        records.append(rec)
        emit({"phase": "kernels", **rec})

    # B6 at Mixtral-8x7B's expert shapes, sym_int4, under a skewed and a
    # uniform prefill-chunk routing (the Hopper body) and a decode routing
    # (the small-M entry); the gate_up prefill cases are also held tile by
    # tile against B2
    for lname, (k, n) in MIXTRAL_EXPERT_LINEARS.items():
        w = _stack_q(randn, 8, k, n, "sym_int4")
        for rname, routing in (("prefill", _prefill_routing(dev)),
                               ("prefill_uniform", _uniform_routing(dev)),
                               ("decode", _decode_routing(gen, dev))):
            rec = _ragged_case(timer, randn, routing, rname, lname, w,
                               iters=10, b2_check=(
                                   lname == "gate_up"
                                   and rname.startswith("prefill")))
            records.append(rec)
            emit({"phase": "kernels", **rec})
        del w
    # B6's small-M entry at its other n8-tile counts: 2 and 16 slots of a
    # decode step (4 and 32 token-choices), untimed
    for n_slots in (2, 16):
        for lname, (k, n) in MIXTRAL_EXPERT_LINEARS.items():
            w = _stack_q(randn, 8, k, n, "sym_int4")
            rec = _ragged_case(timer, randn,
                               _decode_routing(gen, dev, n=n_slots),
                               f"decode{n_slots}", lname, w, iters=0)
            records.append(rec)
            emit({"phase": "kernels", **rec})
            del w
    # every ported qtype at a small, K-padded shape (a prefill routing and
    # a decode one) and dense bf16 stacks at small shapes, untimed; dense
    # stacks at Mixtral's expert shapes under both prefill routings and a
    # decode routing (gate/up timed)
    for qtype in ("sym_int4", "asym_int4", "sym_int8", "nf4", "fp4", "nf3",
                  None, (1008, 260)):
        # a dense stack also at K % 64 != 0 with N % 8 != 0 (rows by
        # cp.async on the Hopper body, 8-byte loads on the small-M body)
        w = (_stack_q(randn, 4, 1000, 512, qtype) if isinstance(qtype, str)
             else randn(4, *(qtype or (1024, 512)), scale=0.02)
             .to(torch.bfloat16))
        for rname, tokens in (("random", 64), ("decode", 6)):
            routing = torch.stack([
                torch.randperm(4, generator=gen, device=dev)[:2]
                for _ in range(tokens)])
            rec = _ragged_case(timer, randn, routing, rname, "small", w,
                               iters=0)
            records.append(rec)
            emit({"phase": "kernels", **rec})
    for lname, (k, n) in MIXTRAL_EXPERT_LINEARS.items():
        w = randn(8, k, n, scale=0.02).to(torch.bfloat16)
        for rname, routing in (("prefill", _prefill_routing(dev)),
                               ("prefill_uniform", _uniform_routing(dev)),
                               ("decode", _decode_routing(gen, dev))):
            rec = _ragged_case(timer, randn, routing, rname, lname, w,
                               iters=10 if lname == "gate_up" else 0)
            records.append(rec)
            emit({"phase": "kernels", **rec})
        del w

    # the quantized-KV bodies of B3, B4 and B5 (fp8_e5m2, int8, int4): timed
    # at the main path's shapes (B3 and B5 at Llama-2-7B's heads and at
    # Mixtral-8x7B's GQA; B5 must equal B3 bit for bit on the same codes and
    # scales), checked only at the other head dims and groups
    for kind in QUANT_KV_KINDS:
        pos_list = [int(p) for p in rng.integers(1, 2048, 8)]
        pos_list[0] = 2047
        small = [255, 3, 130, 0]
        # a generator of their own: the MHA cases keep their positions
        gqa_pos = [int(p) for p in np.random.default_rng(
            [17, QUANT_KV_KINDS.index(kind)]).integers(1, 2048, 8)]
        gqa_pos[0] = 2047
        cases = [("decode_attention", 8, 1, 32, 32, 128, 2048, pos_list,
                  True),
                 # Mixtral-8x7B's GQA, 32 query heads on 8 kv heads
                 ("decode_attention", 8, 1, 32, 8, 128, 2048, gqa_pos, True),
                 ("decode_attention", 4, 1, 8, 2, 64, 256, small, False),
                 ("decode_attention", 4, 1, 8, 2, 256, 256, small, False),
                 ("prefill_attention", 1, 256, 32, 32, 128, 2048, [256],
                  True),
                 ("prefill_attention", 1, 256, 32, 8, 128, 2048, [256],
                  True),
                 ("prefill_attention", 2, 128, 8, 2, 64, 384, [128], False),
                 ("prefill_attention", 2, 128, 8, 2, 256, 384, [128],
                  False)]
        for case in cases:
            rec = _attn_case(timer, randn, *case, kind=kind)
            records.append(rec)
            emit({"phase": "kernels", **rec})
        paged_pos = list(pos_list)
        paged_pos[-1] = 2048 + 37
        paged_gqa = list(gqa_pos)
        paged_gqa[-1] = 2048 + 37
        for case in ((8, 32, 32, 128, 128, 16, paged_pos, True),
                     (8, 32, 8, 128, 128, 16, paged_gqa, True),
                     (4, 8, 2, 64, 128, 2, [255, 3, 130, 261], False)):
            rec = _paged_case(timer, randn, gen, *case, kind=kind)
            records.append(rec)
            emit({"phase": "kernels", **rec})

    # B4 at the engine's own prefill calls (one slot's private cache, as
    # large as the prompt's bucket for every chunk: a 128-token bucket
    # alone; the first 256-token chunk of a 256-, 1024- and 2048-row cache,
    # whose tiles stay one span whatever the plan; the last chunk of a
    # 1024-row cache), every kind, Llama-2-7B's heads and Mixtral's GQA
    for kind in ("bf16",) + QUANT_KV_KINDS:
        for sq, smax, p0 in ((128, 128, 0), (256, 256, 0), (256, 1024, 0),
                             (256, 1024, 768), (256, 2048, 0)):
            for h, hkv in ((32, 32), (32, 8)):
                if (kind, hkv) == ("bf16", 32) and (sq, smax, p0) in (
                        (128, 128, 0), (256, 1024, 0)):
                    continue                  # timed with the cases above
                rec = _attn_case(timer, randn, "prefill_attention", 1, sq, h,
                                 hkv, 128, smax, [p0], True, kind=kind)
                records.append(rec)
                emit({"phase": "kernels", **rec})

    bad = [r for r in records if not r["ok"]]
    require(not bad, f"{len(bad)} kernel case(s) disagree with their plain "
            f"version: {bad[:3]}")
    return records


def _variant_cases(timer, randn):
    from bigdl_tpu_torch.ops.cuda import dequant_matmul as dm
    from bigdl_tpu_torch.ops.quant import quantize, to_mxu_layout

    def gemv(body):
        return lambda x, w: dm.dequant_gemv(x, w, body)

    def i4(x, w):
        return dm.dequant_gemm(x, w, "i4")

    records = []

    def run(name, fn, plain, w, m, k, iters, **extra):
        x = randn(m, k).to(torch.bfloat16)
        rec = _matmul_case(timer, name, x, w, fn, iters, plain_fn=plain)
        rec.update(extra)
        records.append(rec)
        emit({"phase": "kernels", **rec})

    bodies = (("dequant_gemv_mxu", gemv("mxu"), dm.plain_q_matmul_fused),
              ("dequant_gemv_mxuflat", gemv("mxuflat"), dm.plain_q_matmul),
              ("dequant_gemv_mxu8", gemv("mxu8"), dm.plain_q_matmul_q8))
    fold = ("dequant_gemv_fold", gemv("fold"), dm.plain_q_matmul_fold)
    # the load path's defaults (mxu decode, i4 prefill chunk) at every
    # linear a prepacked Llama-2-7B runs them on: each linear's weight
    # loads and split-K count differ from gate_up's (i4 timed at the
    # ragged rows 33 and 100)
    for lname, (k, n) in LLAMA2_7B_LINEARS.items():
        if lname == "gate_up_proj":
            continue
        wm = to_mxu_layout(quantize(randn(k, n, scale=0.02), "sym_int4"))
        for m in (1, 8, 16, 32):
            run(*bodies[0], wm, m, k, 0, linear=lname)
        for m in (33, 64, 100, 128):
            run("dequant_gemm_i4", i4, dm.plain_q_matmul, wm, m, k,
                10 if m in (33, 100) else 0, linear=lname)
        del wm
    k, n = LLAMA2_7B_LINEARS["gate_up_proj"]
    for qtype in ("sym_int4", "nf4", "sym_int8", "fp4", "nf3"):
        w = quantize(randn(k, n, scale=0.02), qtype)
        # fold (the small-M body) at 1, 2 and 4 n8 tiles of tokens (fp4
        # and nf3 timed at M 8), one kernel a call with a K split
        for m in (1, 8, 16, 17, 32):
            timed = m == 8 or (m != 17 and qtype in ("sym_int4", "nf4",
                                                     "sym_int8"))
            run(*fold, w, m, k, 10 if timed else 0, linear="gate_up_proj")
        _one_kernel_a_call("dequant_gemv_fold", fold[1], w, randn)
        if qtype == "sym_int8":
            # mxu8 at 1, 2 and 4 n8 tiles of tokens, one kernel a call
            for m in (1, 8, 16, 32):
                run(*bodies[2], w, m, k, 10, linear="gate_up_proj")
            _one_kernel_a_call("dequant_gemv_mxu8", bodies[2][1], w, randn)
        if qtype != "sym_int4":
            continue
        wm = to_mxu_layout(w)
        # mxu, mxuflat and mxu8 over the int4 layout at 1, 2 and 4 n8
        # tiles (17 untimed), mxuflat and mxu8 one kernel a call
        for m in (1, 8, 16, 17, 32):
            for body in bodies:
                run(*body, wm, m, k, 0 if m == 17 else 10,
                    linear="gate_up_proj")
        for body in bodies[1:]:
            _one_kernel_a_call(body[0], body[1], wm, randn)
        for m in (33, 40, 64, 100, 128):
            run("dequant_gemm_i4", i4, dm.plain_q_matmul, wm, m, k,
                10 if m in (33, 100, 128) else 0, linear="gate_up_proj")
        del wm
    # a K-padded shape and the one-word loads (N % 8 != 0), untimed
    for k, n in ((1000, 512), (640, 260)):
        for qtype in ("sym_int4", "nf4", "sym_int8", "fp4", "nf3"):
            w = quantize(randn(k, n, scale=0.05), qtype)
            for m in (8, 20):
                run(*fold, w, m, k, 0)
            if qtype == "sym_int8":
                run(*bodies[2], w, 8, k, 0)
            if qtype == "sym_int4":
                wm = to_mxu_layout(w)
                for body in bodies:
                    for m in (8, 20):
                        run(*body, wm, m, k, 0)
                run("dequant_gemm_i4", i4, dm.plain_q_matmul, wm, 96, k, 0)
    return records


def _one_kernel_a_call(name, fn, w, randn, calls=5, windows=3):
    """The device kernels `calls` calls of fn (a B1 body at M 8 on w)
    launch, from torch.profiler after a warm call: exactly one a call (no
    quantize launches, no split-K sum), on a shape whose K the wrapper
    splits. torch.profiler loses device records now and then (see
    _profile_decode), so a window with fewer is measured again, at most
    `windows` in all; one with more fails."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.ops.cuda import dequant_matmul as dm

    x = randn(8, w.k).to(torch.bfloat16)
    split = dm._split_k(name, 8, w.n, w.kp, dm._kind(w),
                        dm._cw(name, w.n, 8), x.device)[0]
    require(split > 1, f"{name}: K not split on {w.k} x {w.n}")
    fn(x, w)
    torch.cuda.synchronize()
    for window in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn(x, w)
            torch.cuda.synchronize()
        kernels = {e.key: e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA}
        total = sum(kernels.values())
        require(total <= calls, f"{name}: {total} kernels for {calls} "
                f"calls: {kernels}")
        require(all("smallm_gemv" in key for key in kernels),
                f"{name}: a kernel other than the small-M body: {kernels}")
        if total == calls:
            emit({"phase": "kernels", "check": "kernels_per_call",
                  "kernel": name, "qtype": w.qtype, "layout": w.layout,
                  "M": 8, "split": split, "calls": calls,
                  "device_kernels": kernels, "windows": window + 1})
            return
    require(False, f"{name}: fewer kernels than calls in each of "
            f"{windows} windows: {kernels}")


def _cut_params(params, n_layers):
    from bigdl_tpu_torch.ops.quant import QTensor

    def cut(w):
        if isinstance(w, QTensor):
            return QTensor(w.data[:n_layers], w.scale[:n_layers],
                           None if w.zero is None else w.zero[:n_layers],
                           w.qtype, w.shape, w.layout)
        return w[:n_layers]

    return {**params, "layers": {k: cut(v)
                                 for k, v in params["layers"].items()}}


def _to_device(params, device):
    from bigdl_tpu_torch.ops.quant import QTensor

    def mv(w):
        if isinstance(w, QTensor):
            return w.to(device)
        if isinstance(w, dict):
            return {k: mv(v) for k, v in w.items()}
        return w.to(device)

    return mv(params)


def phase_reference(params, cfg, kind="bf16", cut=None, extra=None):
    """2-layer cut: prefill 128 tokens (B2, B4) + one decode step (B1, B3)
    on the card against the plain versions on the CPU, over a KV cache of
    storage `kind` (phase ``reference_kv`` for the quantized kinds). `cut`
    replaces the cut of `params` with given 2-layer parameters on the card
    (phase ``reference_prepack``), `extra` joins the emitted record.
    Rounding to a code is discontinuous: a K or V value within the two
    devices' bf16 noise of a rounding edge takes neighbouring codes on
    each, one step of amax / 7 apart at int4. So for int8/int4 the CPU run
    stores the card's codes and scales (``quantize_kv`` replayed), which
    holds the arithmetic of every layer to the tolerance; the codes the
    CPU's own quantization would have stored otherwise are counted."""
    import dataclasses

    from bigdl_tpu_torch.models import llama
    from bigdl_tpu_torch.ops import kvcache

    cut_cfg = dataclasses.replace(cfg, num_hidden_layers=2)
    gpu_params = _cut_params(params, 2) if cut is None else cut
    cpu_params = _to_device(gpu_params, "cpu")
    rng = np.random.default_rng(3)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, (1, 128)))
    nxt = torch.tensor(rng.integers(0, cfg.vocab_size, (1, 1)))
    quantize, card_codes, flips = kvcache.quantize_kv, [], [0, 0, 0]

    def record(x, name):
        codes, scales = quantize(x, name)
        card_codes.append((codes.cpu(), scales.cpu()))
        return codes, scales

    def replay(x, name):
        own, _ = quantize(x, name)
        codes, scales = card_codes[flips[2]]
        flips[0] += int((own != codes).sum())      # bytes (int4: two codes)
        flips[1] += codes.numel()
        flips[2] += 1
        return codes, scales

    from bigdl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    out = {}
    for dev, p in (("cuda", gpu_params), ("cpu", cpu_params)):
        kvcache.quantize_kv = record if dev == "cuda" else replay
        reset_launch_counts()
        try:
            cache = llama.new_cache(cut_cfg, 1, 256, device=dev,
                                    kv_cache_dtype=kind)
            with torch.no_grad():
                lg1, cache = llama.forward(p, cut_cfg, prompt.to(dev), cache)
                lg2, cache = llama.forward(p, cut_cfg, nxt.to(dev), cache)
        finally:
            kvcache.quantize_kv = quantize
        if dev == "cuda":
            card = {k: v for k, v in launch_counts().items() if v}
        out[dev] = (lg1.float().cpu(), lg2.float().cpu())
    res = {"phase": "reference" if kind == "bf16" else "reference_kv",
           "kv": kind, "layers": 2, "prompt": 128, "card_launches": card,
           **(extra or {})}
    if kind in ("int8", "int4"):
        res.update(quantize_calls=flips[2], code_bytes=flips[1],
                   code_bytes_stored_otherwise_on_cpu=flips[0])
    ok = True
    for i, name in enumerate(("prefill", "decode")):
        got, want = out["cuda"][i], out["cpu"][i]
        scale = float(want.abs().max())
        err = max_err(got, want)
        fin = bool(torch.isfinite(got).all())
        # two layers of bf16 activations: allow 5% of the logit range
        good = fin and got.shape == want.shape and err <= 0.05 * scale
        top1 = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        res[name] = {"shape": list(got.shape), "max_abs_err": err,
                     "ref_max_abs": scale, "tol": 0.05 * scale,
                     "finite": fin, "top1_agree": top1, "ok": good}
        ok &= good
    emit(res)
    require(ok, f"card forward disagrees with the CPU plain forward "
            f"({res['phase']}, {kind} KV cache)")
    return res


def _run_requests(eng, requests):
    """Feed all requests, step to completion; returns tokens, TTFT and
    pure-decode step timing (with each kernel's launches, the graph
    replays and the steps the resident step served in those steps)."""
    from bigdl_tpu_torch.ops.cuda import launch_counts, replay_counts

    t0 = time.perf_counter()
    for rid, prompt, sp in requests:
        eng.add_request(rid, prompt, sp)
    toks = {rid: [] for rid, _, _ in requests}
    reasons, ttft = {}, {}
    decode_s, decode_tokens, decode_steps, steps = 0.0, 0, 0, 0
    peak = 0
    decode_launches = dict.fromkeys(launch_counts(), 0)
    step_ms, replays_per_step, resident, captures = [], [], 0, 0
    while eng.has_unfinished():
        pure = eng._admitting is None and not eng.waiting
        n_active = sum(s.active for s in eng.slots)
        before = launch_counts()
        replays0 = sum(replay_counts().values())
        res0 = eng.resident_steps
        graphs0 = len(eng.resident_graph_stats())
        ts = time.perf_counter()
        eng.step()
        torch.cuda.synchronize()
        te = time.perf_counter()
        steps += 1
        peak = max(peak, sum(s.active for s in eng.slots))
        if pure and n_active:
            decode_s += te - ts
            decode_tokens += n_active
            decode_steps += 1
            step_ms.append(1e3 * (te - ts))
            replays_per_step.append(sum(replay_counts().values()) - replays0)
            resident += eng.resident_steps - res0
            captures += len(eng.resident_graph_stats()) - graphs0
            for k, v in launch_counts().items():
                decode_launches[k] += v - before[k]
        for rid in toks:
            for o in eng.get_outputs(rid):
                if o.new_token_ids and rid not in ttft:
                    ttft[rid] = te - t0
                toks[rid].extend(o.new_token_ids)
                if o.finished:
                    reasons[rid] = o.finish_reason
        require(steps < 10000, "engine did not finish")
    wall = time.perf_counter() - t0
    return toks, reasons, ttft, {
        "wall_s": wall, "steps": steps, "peak_active": peak,
        "decode_tokens_per_s": decode_tokens / decode_s if decode_s else None,
        "decode_steps": decode_steps,
        "decode_step_ms": 1e3 * decode_s / decode_steps if decode_steps
        else None,
        "decode_step_ms_median": (float(np.median(step_ms)) if step_ms
                                  else None),
        # graph replays a pure-decode step: 1, or 0 on a step that ran
        # eagerly (the flag off, a capture, host-sampled slots)
        "decode_replays": sum(replays_per_step),
        "decode_replays_per_step": sorted(set(replays_per_step)),
        "decode_captures": captures,
        "decode_resident_steps": resident,
        "decode_launches": decode_launches}


def _kernel_group(name: str) -> str:
    for key, group in (("smallm_ragged", "ragged_expert_matmul (B6)"),
                       ("wgmma_ragged", "ragged_expert_matmul (B6)"),
                       ("wgmma_gemm", "dequant_gemm (B2)"),
                       ("smallm_gemv", "dequant_gemv (B1)"),
                       ("decode_attention", "decode_attention (B3)"),
                       ("prefill_attention", "prefill_attention (B4)"),
                       ("gemm", "torch matmul"), ("nvjet", "torch matmul"),
                       ("elementwise", "elementwise"),
                       ("reduce", "reductions"), ("index", "cache writes"),
                       ("copy", "copies")):
        if key in name.lower():
            return group
    return "other"


# host calls that start device work: kernel launches, graph launches and
# copies (a CUDA graph's kernels start from one cudaGraphLaunch)
HOST_LAUNCH_API = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch")
HOST_COPY_API = ("cudaMemcpy", "cudaMemset")


def _host_launch_calls(prof, steps):
    """(host launch calls a step, every launch / copy API call a step by
    name) of a finished profile."""
    from torch.autograd import DeviceType

    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CPU and e.key.startswith(
                HOST_LAUNCH_API + HOST_COPY_API):
            by_name[e.key] = by_name.get(e.key, 0) + e.count / steps
    launches = sum(v for k, v in by_name.items()
                   if k.startswith(HOST_LAUNCH_API))
    return launches, by_name


def _device_ms_by_group(prof, steps):
    """(device ms per step by kernel group, launches per step, launches
    per step by group) from a finished profile; raises AttributeError on a
    profiler without the fields read here."""
    from torch.autograd import DeviceType

    groups, by_group = {}, {}
    for e in prof.key_averages():
        # a record_function range shows on the device too: not a kernel
        if e.device_type != DeviceType.CUDA or e.key.startswith("bigdl."):
            continue
        us = (getattr(e, "self_device_time_total", 0)
              or getattr(e, "self_cuda_time_total", 0))
        g = _kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + us / 1e3 / steps
        by_group[g] = by_group.get(g, 0) + e.count / steps
    return groups, sum(by_group.values()), by_group


def _profile_decode(eng, requests, steps=4, windows=3):
    """Device time of `steps` pure-decode steps (all slots active) by
    kernel group, from torch.profiler, beside the steps' wall time, with
    one B3-group kernel required for each B3/B5 call and at most one
    small-M kernel for each B1 call (any body). torch.profiler loses
    device records now and then: of 60 windows of tools/profile_decode.py
    on an H100, half on this code and half on its parent commit's, two
    lost a burst of 52 and 65 records, one of them a B3 kernel each, while
    the host's launch calls stayed the same in every window (PERF.md
    section 7); late in a full smoke run each of three Mixtral windows
    lost one B1 record. A window with fewer B3 records
    than calls is therefore measured again, at most `windows` in all; one
    with more B3 or B1 kernels than calls fails at once, as does a run
    whose every window lost a B3 record."""
    out = {}
    for w in range(windows):
        out = _decode_window(eng, requests, steps, f"-prof{w}")
        b3 = out.get("attention_launches_per_step")
        if b3 is None:                  # the profiler did not measure
            return out
        calls = out["attention_calls_per_step"]
        b1, b1_calls = out["b1_launches_per_step"], out["b1_calls_per_step"]
        require(0 < calls and b3 <= calls,
                f"decode_profile: {b3} decode attention kernels a step "
                f"for {calls} calls")
        require(b1 <= b1_calls, f"decode_profile: {b1} small-M B1 kernels "
                f"a step for {b1_calls} B1 calls")
        if b3 == calls:
            out["windows"] = w + 1
            return out
    require(False, f"decode_profile: {b3} decode attention kernels a step "
            f"for {calls} calls in each of {windows} windows")
    return out


def _decode_window(eng, requests, steps, tag):
    """One profiled decode window of _profile_decode: the requests (ids
    suffixed with `tag`) are admitted first and drained after. Only the
    profiler's own start and read-out may fail ("not measured"); a failing
    engine step fails the run."""
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.ops.cuda import launch_counts

    def calls(*prefixes):
        # launches of the wrappers counted under these names (B3 and B5:
        # every storage kind; B1: every body)
        return sum(v for k, v in launch_counts().items()
                   if k.startswith(prefixes))

    def attention_calls():
        return calls("decode_attention", "paged_decode_attention")

    for rid, prompt, sp in requests:
        eng.add_request(rid + tag, prompt, sp)
    while eng.waiting or eng._admitting is not None:
        eng.step()
    torch.cuda.synchronize()
    out = {"steps": steps}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.__enter__()
    except (RuntimeError, AttributeError) as e:   # profiler unavailable
        prof = None
        out["device_ms_per_step"] = f"not measured: {e}"
    calls0, b1_calls0 = attention_calls(), calls("dequant_gemv")
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    out["wall_ms_per_step"] = wall_ms
    out["attention_calls_per_step"] = (attention_calls() - calls0) / steps
    out["b1_calls_per_step"] = (calls("dequant_gemv") - b1_calls0) / steps
    if prof is not None:
        prof.__exit__(None, None, None)
        try:
            groups, launches, by_group = _device_ms_by_group(prof, steps)
            out["host_launch_calls_per_step"], out["host_api_per_step"] = \
                _host_launch_calls(prof, steps)
        except (RuntimeError, AttributeError) as e:
            groups, out["device_ms_per_step"] = {}, f"not measured: {e}"
        if groups:
            dev = sum(groups.values())
            # B3 / B5 and every B1 body are one kernel a call (no merge
            # pass, no split-K sum): the step's launches fall by its
            # attention calls against a two-kernel body (PERF.md section 5
            # keeps the earlier runs' counts)
            out["attention_launches_per_step"] = by_group.get(
                "decode_attention (B3)", 0.0)
            out["b1_launches_per_step"] = by_group.get(
                "dequant_gemv (B1)", 0.0)
            out.update(device_ms_per_step=dev,
                       device_idle_share=max(0.0, 1.0 - dev / wall_ms),
                       kernel_launches_per_step=launches,
                       device_ms_by_group=dict(sorted(
                           groups.items(), key=lambda kv: -kv[1])))
        else:
            out.setdefault("device_ms_per_step", "not measured")
    while eng.has_unfinished():
        eng.step()
        for rid, _, _ in requests:
            eng.get_outputs(rid + tag)
    return out


def phase_prefill_profile(params, cfg, family, model, prompt_len,
                          windows=3):
    """torch.profiler over one prefill: a `prompt_len`-token prompt through
    a fresh LLMEngine (max_batch 1) until its first token, after one
    unprofiled warm-up prefill of the same length. Reports the device time
    by kernel group (the dequantize-then-matmul path of linears past 128
    rows read from its profiler range), the idle share, and the kernels'
    launches. Returns the launch counts of the profiled prefill."""
    from bigdl_tpu_torch.ops.cuda import launch_counts
    from bigdl_tpu_torch.serving.engine import (EngineConfig, LLMEngine,
                                                SamplingParams)
    from bigdl_tpu_torch.utils.testing import SyntheticCausalLM

    model_obj = (SyntheticCausalLM(params, cfg) if family is None else
                 SyntheticCausalLM(params, cfg, family=family))
    eng = LLMEngine(model_obj, EngineConfig(max_batch=1, max_seq=2048),
                    device="cuda")
    prompt = np.random.default_rng(13).integers(
        0, cfg.vocab_size, prompt_len).tolist()

    def b4_calls():
        # B4 calls of every storage kind
        return sum(v for k, v in launch_counts().items()
                   if k.startswith("prefill_attention"))

    def prefill(rid):
        eng.add_request(rid, prompt, SamplingParams(max_tokens=1))
        steps, first = 0, False
        while not first:
            eng.step()
            steps += 1
            first = any(o.new_token_ids for o in eng.get_outputs(rid))
            require(steps < 64, f"prefill_profile: {rid} gave no token")
        while eng.has_unfinished():
            eng.step()
        return steps

    prefill("warm-up")
    torch.cuda.synchronize()
    # B4 is one kernel a call (its spans merge in the same launch); a
    # profile that lost B4 records (see _profile_decode) is taken again,
    # at most `windows` in all
    for w in range(windows):
        out, counts, b4 = _prefill_window(prefill, b4_calls, f"profiled{w}")
        out.update(phase="prefill_profile", model=model,
                   prompt_tokens=prompt_len, windows=w + 1)
        if b4 is None or b4 == out["b4_calls"]:
            break
        require(b4 < out["b4_calls"] and w + 1 < windows,
                f"prefill_profile: {b4} B4 kernels for {out['b4_calls']} "
                f"B4 calls in {model}'s prefill")
    emit(out)
    want = "dequant_gemm" if family is None else "ragged_expert_matmul"
    require(counts.get(want, 0) > 0,
            f"prefill_profile: {want} never launched in {model}'s prefill")
    return counts


def _prefill_window(prefill, b4_calls, rid):
    """One profiled prefill of phase_prefill_profile: (its record, its
    launch counts, its B4 kernel records or None where the profiler did
    not measure)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.ops.cuda import launch_counts
    from bigdl_tpu_torch.ops.matmul import DEQUANT_THEN_MATMUL

    out, b4 = {}, None
    before = launch_counts()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    try:
        prof.__enter__()
    except (RuntimeError, AttributeError) as e:   # profiler unavailable
        prof = None
        out["device_ms"] = f"not measured: {e}"
    t0 = time.perf_counter()
    calls0 = b4_calls()
    out["steps"] = prefill(rid)
    torch.cuda.synchronize()
    out["b4_calls"] = b4_calls() - calls0
    wall_ms = 1e3 * (time.perf_counter() - t0)
    counts = {k: v - before[k] for k, v in launch_counts().items()
              if v != before[k]}
    out.update(wall_ms=wall_ms, kernel_launches_by_counter=counts)
    if prof is not None:
        prof.__exit__(None, None, None)
        try:
            groups, launches, by_group = _device_ms_by_group(prof, 1)
            dtm = [e for e in prof.key_averages()
                   if e.key == DEQUANT_THEN_MATMUL
                   and e.device_type == DeviceType.CPU]
        except (RuntimeError, AttributeError) as e:
            groups, out["device_ms"] = {}, f"not measured: {e}"
        if groups:
            dev = sum(groups.values())
            b4 = by_group.get("prefill_attention (B4)", 0)
            out.update(b4_kernels=b4,
                       b4_device_ms=groups.get("prefill_attention (B4)",
                                               0.0))
            out.update(device_ms=dev,
                       device_idle_share=max(0.0, 1.0 - dev / wall_ms),
                       kernel_launches=launches,
                       device_ms_by_group=dict(sorted(
                           groups.items(), key=lambda kv: -kv[1])))
            if dtm:
                out["dequant_then_matmul"] = {
                    "calls": dtm[0].count,
                    "device_ms": (getattr(dtm[0], "device_time_total", 0)
                                  or getattr(dtm[0], "cuda_time_total", 0))
                    / 1e3}
    return out, counts, b4


def _engine_requests(cfg, max_new):
    from bigdl_tpu_torch.serving.engine import SamplingParams

    rng = np.random.default_rng(11)
    # prompt lengths cover every route: <=32 (B1, plain attention),
    # 33-64 (B2), 65-128 (B2 + B4 at Sq 128), 129-256 (torch matmul + B4
    # at Sq 256), >256 (chunks of 256 at pos 0, 256, ...)
    lens = [24, 48, 100, 200, 1000, 16, 64, 300]
    seeded = {5: 1234, 7: 99}
    requests = []
    for i, n in enumerate(lens):
        prompt = rng.integers(0, cfg.vocab_size, n).tolist()
        if i in seeded:
            sp = SamplingParams(max_tokens=max_new, temperature=0.8,
                                top_k=40, top_p=0.95, seed=seeded[i])
        else:
            sp = SamplingParams(max_tokens=max_new)
        requests.append((f"r{i}", prompt, sp))
    return lens, requests


def _shared_prefix_requests(cfg, max_new):
    """Four requests of one 1024-token prefix (eight full pages at ps 128)
    and tails of 1, 5, 40 and 130 tokens; two greedy, two seeded."""
    from bigdl_tpu_torch.serving.engine import SamplingParams

    rng = np.random.default_rng(12)
    pre = rng.integers(0, cfg.vocab_size, 1024).tolist()
    out = []
    for i, n in enumerate((1, 5, 40, 130)):
        tail = rng.integers(0, cfg.vocab_size, n).tolist()
        sp = (SamplingParams(max_tokens=max_new) if i % 2 == 0 else
              SamplingParams(max_tokens=max_new, temperature=0.9, top_k=50,
                             seed=77 + i))
        out.append((f"s{i}", pre + tail, sp))
    return out


def phase_engine(params, cfg, max_new=32):
    from bigdl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from bigdl_tpu_torch.serving.engine import EngineConfig, LLMEngine
    from bigdl_tpu_torch.utils.testing import SyntheticCausalLM

    lens, requests = _engine_requests(cfg, max_new)
    model = SyntheticCausalLM(params, cfg)
    ecfg = EngineConfig(max_batch=8, max_seq=2048)
    eng = LLMEngine(model, ecfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    toks1, reasons1, ttft, perf = _run_requests(eng, requests)
    counts = launch_counts()
    toks2, reasons2, _, perf2 = _run_requests(eng, requests)
    res = {"phase": "engine", "model": "llama2-7b", "qtype": "sym_int4",
           "layers": cfg.num_hidden_layers, "requests": len(requests),
           "prompt_lens": lens, "max_new_tokens": max_new,
           "launches": counts, "finish_reasons": reasons1,
           "ttft_s": ttft, "max_memory_allocated":
           torch.cuda.max_memory_allocated(), **perf,
           "repeat_run": perf2,
           "decode_profile": _profile_decode(eng, requests)}
    # the same window with the eager step: its host launch calls beside
    # the resident step's one graph launch
    with _resident("off"):
        res["decode_profile_eager"] = _profile_decode(eng, requests)
    greedy_same = all(toks1[r] == toks2[r] for r, _, sp in requests
                      if sp.temperature <= 0)
    seeded_same = all(toks1[r] == toks2[r] for r, _, sp in requests
                      if sp.temperature > 0)
    all_done = all(reasons1.get(r) in ("length", "stop")
                   for r, _, _ in requests)
    in_vocab = all(0 <= t < cfg.vocab_size for v in toks1.values()
                   for t in v)
    res.update(all_finished=all_done, greedy_repeat=greedy_same,
               seeded_repeat=seeded_same, tokens_in_vocab=in_vocab,
               tokens={r: toks1[r][:8] for r, _, _ in requests})
    emit(res)
    require(all_done, f"not every request finished: {reasons1}")
    require(all(len(toks1[r]) == max_new for r, _, _ in requests),
            "a request produced the wrong number of tokens")
    require(in_vocab, "token outside the vocabulary")
    require(greedy_same, "greedy requests did not repeat")
    require(seeded_same, "seeded requests did not repeat")
    missing = [k for k in ("dequant_gemv", "dequant_gemm", "decode_attention",
                           "prefill_attention") if counts[k] <= 0]
    require(not missing, f"kernels never launched on the main path: "
            f"{missing}")
    shared = _shared_prefix_requests(cfg, max_new)
    toks3, _, _, _ = _run_requests(eng, shared)
    return (counts, toks1, toks3, res["max_memory_allocated"],
            res["decode_step_ms"])


RESIDENT_ENV = "BIGDL_TPU_TORCH_DECODE_RESIDENT"


@contextlib.contextmanager
def _resident(mode):
    """BIGDL_TPU_TORCH_DECODE_RESIDENT set to `mode` ("off": the eager
    step; "auto": the resident step, a CUDA graph replay) inside."""
    old = os.environ.get(RESIDENT_ENV)
    os.environ[RESIDENT_ENV] = mode
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(RESIDENT_ENV, None)
        else:
            os.environ[RESIDENT_ENV] = old


def _resident_engine_turns(name, model, requests, ecfg, turns):
    """The requests through one eager and one graph engine of `ecfg`, in
    `turns` (modes in order), in one process: every turn's streams and
    finish reasons must equal the first's; the graph engine's steps must
    be resident, each pure-decode step one replay once its graphs exist.
    Returns (record, the graph turns' launches, graph turns' decode
    launches)."""
    from bigdl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from bigdl_tpu_torch.serving.engine import LLMEngine

    engs = {m: LLMEngine(model, ecfg, device="cuda") for m in set(turns)}
    runs, counts, dec = [], {}, {}
    for m in turns:
        with _resident(m):
            reset_launch_counts()
            toks, reasons, _, perf = _run_requests(engs[m], requests)
        if m != "off":
            for k, v in launch_counts().items():
                counts[k] = counts.get(k, 0) + v
            for k, v in perf["decode_launches"].items():
                dec[k] = dec.get(k, 0) + v
        runs.append({"mode": m, "toks": toks, "reasons": reasons,
                     **{k: perf[k] for k in (
                         "wall_s", "decode_steps", "decode_step_ms",
                         "decode_step_ms_median", "decode_tokens_per_s",
                         "decode_replays", "decode_replays_per_step",
                         "decode_captures", "decode_resident_steps")}})
    graphs = engs["auto"].resident_graph_stats()
    del engs
    gc.collect()
    torch.cuda.empty_cache()
    ref = runs[0]
    for r in runs:
        require(all(ref["reasons"].get(q) in ("length", "stop")
                    and r["reasons"].get(q) == ref["reasons"].get(q)
                    for q, _, _ in requests),
                f"resident {name}: finish reasons {r['reasons']}")
        require(r["toks"] == ref["toks"],
                f"resident {name}: the {r['mode']} turn's streams differ "
                "from the eager step's")
        steps = r["decode_steps"]
        if r["mode"] == "off":
            require(r["decode_resident_steps"] == r["decode_replays"] == 0,
                    f"resident {name}: the eager turn replayed a graph")
        else:
            # a step that captured ran eagerly; every other one replayed
            # exactly one graph
            require(r["decode_resident_steps"] == steps and
                    r["decode_replays"] == steps - r["decode_captures"] and
                    max(r["decode_replays_per_step"]) == 1,
                    f"resident {name}: {r['decode_replays']} replays in "
                    f"{steps} pure-decode steps ({r['decode_captures']} "
                    "captures)")
    require(graphs and all(g["captured"] for g in graphs),
            f"resident {name}: no graph captured: {graphs}")
    rec = {"graphs": graphs, "runs": [
        {k: v for k, v in r.items() if k not in ("toks", "reasons")}
        for r in runs], "streams_equal": True,
        "tokens": {q: ref["toks"][q][:8] for q, _, _ in requests[:2]}}
    return rec, counts, dec


# a step whose capture must fail (a host read of a device value), run by
# ``_failed_capture_raises`` in a process of its own
_CAPTURE_FAILS = """
import json, torch
from bigdl_tpu_torch.cuda_graph import StepGraph
x = torch.zeros(4, device="cuda")
def step():
    x.add_(1)
    if float(x.sum()) < 0:
        x.zero_()
try:
    StepGraph("probe", step, torch.device("cuda"))()
    out = {"raised": None}
except Exception as e:
    out = {"raised": type(e).__name__, "message": str(e)[:300]}
out["eager_runs"] = float(x[0])
print(json.dumps(out))
"""


def _failed_capture_raises():
    """A capture that fails raises (``StepGraph``'s RuntimeError) after
    the step's one eager run, and runs nothing else; checked in a child
    process, so the smoke's own CUDA context never holds a failed
    capture."""
    r = subprocess.run([sys.executable, "-c", _CAPTURE_FAILS],
                       capture_output=True, text=True, timeout=300,
                       cwd=os.path.dirname(os.path.abspath(__file__)))
    lines = r.stdout.strip().splitlines()
    out = json.loads(lines[-1]) if r.returncode == 0 and lines else {
        "returncode": r.returncode, "stderr": r.stderr[-500:]}
    require(out.get("raised") == "RuntimeError"
            and "capture failed" in out.get("message", "")
            and out.get("eager_runs") == 1.0,
            f"resident: a failing capture did not raise: {out}")
    return out


def _interleaved_streams(gens, ids_a, ids_b, gen):
    """Two ``generate_stream``-style streams of one graph Generator in
    flight at one batch size, stepped in turns: the first holds the kept
    KV cache, so the second must get a cache and a graph of its own. Each
    stream must equal its prompt's eager stream, and the kept caches stay
    within ``KEEP_CACHES``."""
    from bigdl_tpu_torch.generation import KEEP_CACHES

    with _resident("off"):
        want = [gens["off"].generate(i, gen) for i in (ids_a, ids_b)]
    with _resident("auto"):
        g = gens["auto"]
        streams = [g.stream(i, gen) for i in (ids_a, ids_b)]
        got = [[], []]
        for ta, tb in zip(*streams):
            got[0].append(ta)
            got[1].append(tb)
        got = [np.stack(t, axis=1) for t in got]
        torch.cuda.synchronize()
    require(all(np.array_equal(a, b) for a, b in zip(got, want)),
            "resident generate: two interleaved streams differ from their "
            "eager streams")
    require(len(g._kept) <= KEEP_CACHES,
            f"resident generate: {len(g._kept)} kept caches")
    return {"streams": 2, "tokens_equal": True,
            "kept_caches": len(g._kept),
            "kept_batches": sorted(g._kept)}


def phase_resident(params, cfg, max_new=32, new_tokens=64):
    """The resident decode step (a CUDA graph a step) against the eager
    step, in turns in one process, before any torch.profiler window: the
    engine phase's eight requests through a slab engine (max_batch 8) at
    each KV kind (bf16: eager, graph, graph, eager; the others eager,
    graph); ``Generator.generate`` at bs 1 (greedy, a 100-token prompt)
    and bs 4 (seeded sampling), eager, graph, graph, eager, then two
    greedy bs 1 streams in flight at once (``_interleaved_streams``); and
    ``generate_on_device`` at bs 1, its eager loop then its graph. Every
    graph stream must equal the eager stream token for token; a graph
    engine's pure-decode step is one replay (a capturing step none); a
    capture that fails raises (``_failed_capture_raises``).
    Reports step and next-token ms of both paths, replays, each graph's
    capture ms and pool bytes."""
    from bigdl_tpu_torch.generation import (GenerationConfig,
                                            GenerationStats, Generator,
                                            generate_on_device)
    from bigdl_tpu_torch.models import llama
    from bigdl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from bigdl_tpu_torch.serving.engine import EngineConfig
    from bigdl_tpu_torch.utils.testing import SyntheticCausalLM

    t_phase = time.perf_counter()
    lens, requests = _engine_requests(cfg, max_new)
    model = SyntheticCausalLM(params, cfg)
    res = {"phase": "resident", "model": "llama2-7b", "qtype": "sym_int4",
           "layers": cfg.num_hidden_layers, "requests": len(requests),
           "prompt_lens": lens, "max_new_tokens": max_new, "engine": {}}
    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    for kind in ("bf16", "fp8_e5m2", "int8", "int4"):
        turns = (("off", "auto", "auto", "off") if kind == "bf16"
                 else ("off", "auto"))
        rec, c, dec = _resident_engine_turns(
            f"engine {kind}", model, requests,
            EngineConfig(max_batch=8, max_seq=2048, kv_cache_dtype=kind),
            turns)
        add(c)
        attn = "decode_attention" + ("" if kind == "bf16" else f"_{kind}")
        require(dec["dequant_gemv"] > 0 and dec[attn] > 0,
                f"resident engine {kind}: B1 / {attn} did not launch in the "
                "graph's decode steps")
        res["engine"][kind] = rec

    rng = np.random.default_rng(13)
    ids1 = rng.integers(3, cfg.vocab_size, (1, 100))
    ids4 = rng.integers(3, cfg.vocab_size, (4, 100))
    greedy = GenerationConfig(max_new_tokens=new_tokens)
    sampled = GenerationConfig(max_new_tokens=new_tokens, do_sample=True,
                               temperature=0.8, top_k=40, top_p=0.95,
                               seed=11)
    gens = {m: Generator(params, cfg, max_seq=2048) for m in ("off", "auto")}
    gruns, outs = [], []
    for m in ("off", "auto", "auto", "off"):
        with _resident(m):
            reset_launch_counts()
            stats = GenerationStats()
            t0 = time.perf_counter()
            a = gens[m].generate(ids1, greedy, stats=stats)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            b = gens[m].generate(ids4, sampled)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if m != "off":
                add(launch_counts())
        outs.append((a, b))
        gruns.append({"mode": m, "bs1_wall_s": t1 - t0,
                      "bs1_next_token_ms": 1e3 * stats.rest_cost_mean,
                      "bs1_ttft_s": stats.first_token_s,
                      "bs4_sampled_wall_s": t2 - t1})
    gstats = gens["auto"].graph_stats()
    inter = _interleaved_streams(gens, ids1, ids4[1:2], greedy)
    del gens
    gc.collect()
    torch.cuda.empty_cache()
    require(all(np.array_equal(a, outs[0][0]) and np.array_equal(
        b, outs[0][1]) for a, b in outs),
            "resident generate: graph tokens differ from the eager step's")
    require(len(gstats) == 2 and all(
        g["captured"] and g["replays"] == 2 * (new_tokens - 1) - 1
        for g in gstats),
            f"resident generate: graphs {gstats}")
    res["generate"] = {"new_tokens": new_tokens, "runs": gruns,
                       "graphs": gstats, "tokens_equal": True,
                       "interleaved": inter,
                       "bs1_tokens": outs[0][0][0, 100:108].tolist()}

    dres = {}
    for m in ("off", "auto"):
        with _resident(m):
            reset_launch_counts()
            cache = llama.new_cache(cfg, 1, 2048, device="cuda")
            t0 = time.perf_counter()
            out, cache = generate_on_device(params, cfg, llama.forward,
                                            ids1, cache, new_tokens)
            toks = out.cpu().numpy()
            dres[m] = {"wall_s": time.perf_counter() - t0,
                       "pos": int(cache.pos), "tokens": toks}
            c = launch_counts()
            if m != "off":
                add(c)
            dres[m]["decode_attention"] = c["decode_attention"]
            del cache
    require(np.array_equal(dres["off"]["tokens"], dres["auto"]["tokens"]),
            "resident generate_on_device: graph tokens differ from its "
            "eager loop's")
    L = cfg.num_hidden_layers
    require(all(d["pos"] == 100 + new_tokens - 1 and d["decode_attention"]
                == L * (new_tokens - 1) for d in dres.values()),
            f"resident generate_on_device: {dres}")
    res["generate_on_device"] = {
        m: {k: v for k, v in d.items() if k != "tokens"}
        for m, d in dres.items()}
    res["generate_on_device"]["tokens_equal"] = True
    res["failed_capture"] = _failed_capture_raises()
    res["seconds"] = time.perf_counter() - t_phase
    emit(res)
    return counts


def phase_resident_moe(params, cfg, max_new=32):
    """Mixtral-8x7B's decode as a CUDA graph against the eager step, in
    turns: the engine phase's eight requests at max_batch 8 (16
    token-choices: the ragged dispatch, B6 in the graph) and four greedy
    ones at max_batch 4 (8 token-choices: the experts gathered, B1 in the
    graph and no B6). Streams must equal the eager step's."""
    from bigdl_tpu_torch.models import mixtral
    from bigdl_tpu_torch.serving.engine import EngineConfig
    from bigdl_tpu_torch.utils.testing import SyntheticCausalLM

    t0 = time.perf_counter()
    model = SyntheticCausalLM(params, cfg, family=mixtral)
    _, requests = _engine_requests(cfg, max_new)
    greedy4 = [q for q in requests if q[2].temperature <= 0][:4]
    res = {"phase": "resident_moe", "model": "mixtral-8x7b",
           "layers": cfg.num_hidden_layers, "max_new_tokens": max_new}
    counts = {}
    for name, reqs, mb in (("ragged", requests, 8), ("gather", greedy4, 4)):
        rec, c, dec = _resident_engine_turns(
            f"moe {name}", model, reqs,
            EngineConfig(max_batch=mb, max_seq=2048), ("off", "auto"))
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        if name == "ragged":
            require(dec["ragged_expert_matmul"] > 0,
                    "resident moe ragged: B6 did not launch in the graph's "
                    "decode steps")
        else:
            require(dec["dequant_gemv"] > 0 and
                    dec["ragged_expert_matmul"] == 0,
                    f"resident moe gather: decode launches {dec}")
        res[name] = rec
    res["seconds"] = time.perf_counter() - t0
    emit(res)
    return counts


SERVER_FAMILIES = (
    "bigdl_tpu_request_phase_seconds", "bigdl_tpu_ttft_seconds",
    "bigdl_tpu_tpot_seconds", "bigdl_tpu_slot_occupancy",
    "bigdl_tpu_queue_depth", "bigdl_tpu_admissions_total",
    "bigdl_tpu_preemptions_total", "bigdl_tpu_stall_guard_trips_total",
    "bigdl_tpu_requests_finished_total", "bigdl_tpu_engine_steps_total",
    "bigdl_tpu_tokens_generated_total", "bigdl_tpu_requests_cancelled_total",
    "bigdl_tpu_requests_quarantined_total")


class _Served:
    """An ``OpenAIServer`` over a fresh engine on 127.0.0.1, port 0, with
    the engine's pure-decode steps timed on its loop thread (a step with
    no admission pending and nothing queued, as ``_run_requests`` times
    them in the engine phases)."""

    def __init__(self, model, ecfg):
        from bigdl_tpu_torch.observability.metrics import MetricsRegistry
        from bigdl_tpu_torch.serving.api_server import OpenAIServer
        from bigdl_tpu_torch.serving.engine import LLMEngine

        self.engine = eng = LLMEngine(model, ecfg, device="cuda",
                                      registry=MetricsRegistry())
        self.decode = []                 # (active slots, seconds)
        step = eng.step

        def timed():
            pure = eng._admitting is None and not eng.waiting
            n = sum(s.active for s in eng.slots)
            t0 = time.perf_counter()
            did = step()
            if pure and n and did:
                self.decode.append((n, time.perf_counter() - t0))
            return did

        eng.step = timed
        self.server = OpenAIServer(eng)
        httpd = self.server.serve(host="127.0.0.1", port=0, background=True)
        self.base = f"http://127.0.0.1:{httpd.server_address[1]}"

    def get(self, path):
        import urllib.request

        with urllib.request.urlopen(self.base + path, timeout=120) as r:
            return r.status, r.read()

    def post(self, body, stream=False):
        """A completion: (ids, finish reason or None, seconds to the first
        streamed delta or None, seconds to the end, the response)."""
        import urllib.request

        req = urllib.request.Request(
            self.base + "/v1/completions",
            data=json.dumps(dict(body, stream=stream)).encode(),
            headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=600) as r:
            if not stream:
                out = json.loads(r.read())
                return ([int(t) for t in out["choices"][0]["text"].split()],
                        out["choices"][0]["finish_reason"], None,
                        time.perf_counter() - t0, out)
            first, text, lines = None, [], []
            for line in r:
                line = line.strip()
                if not line.startswith(b"data: "):
                    continue
                lines.append(line)
                if line == b"data: [DONE]":
                    continue
                if first is None:
                    first = time.perf_counter() - t0
                text.append(json.loads(line[6:])["choices"][0]["text"])
        require(lines and lines[-1] == b"data: [DONE]",
                "server: a stream did not end in data: [DONE]")
        return ([int(t) for t in "".join(text).split()], None, first,
                time.perf_counter() - t0, None)

    def concurrent(self, bodies, stream=False):
        """Each body from a client thread of its own, all sent at once."""
        import threading

        out = [None] * len(bodies)
        gate = threading.Barrier(len(bodies))

        def client(i):
            gate.wait()
            try:
                out[i] = self.post(bodies[i], stream)
            except Exception as e:       # checked below, on this thread
                out[i] = e

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        bad = [o for o in out if isinstance(o, Exception)]
        require(not bad, f"server: a client failed: {bad[:1]}")
        return out

    def decode_perf(self):
        steps, self.decode = self.decode, []
        s = sum(dt for _, dt in steps)
        return {"decode_steps": len(steps),
                "decode_step_ms": 1e3 * s / len(steps) if steps else None,
                "decode_tokens_per_s": (sum(n for n, _ in steps) / s
                                        if s else None)}

    def close(self):
        self.server.shutdown()


def _body(prompt, sp, **kw):
    return dict({"prompt": prompt, "max_tokens": sp.max_tokens,
                 "temperature": sp.temperature, "top_k": sp.top_k,
                 "top_p": sp.top_p, "seed": sp.seed}, **kw)


def _drop_mid_stream(srv, prompt, max_tokens):
    """A streamed request whose client hangs up after the first delta:
    the engine must abort it. Returns the seconds until it was idle."""
    import socket

    host, port = srv.base[len("http://"):].split(":")
    body = json.dumps({"prompt": prompt, "stream": True, "ignore_eos": True,
                       "max_tokens": max_tokens}).encode()
    s = socket.create_connection((host, int(port)), timeout=120)
    s.sendall(b"POST /v1/completions HTTP/1.1\r\nHost: x\r\n"
              b"Content-Type: application/json\r\n"
              + f"Content-Length: {len(body)}\r\n\r\n".encode() + body)
    got = b""
    while b"data: " not in got:
        chunk = s.recv(4096)
        require(bool(chunk), "server: the dropped stream closed early")
        got += chunk
    s.close()
    t0 = time.perf_counter()
    while srv.engine.has_unfinished():
        require(time.perf_counter() - t0 < 120,
                "server: a dropped client's request was not aborted")
        time.sleep(0.01)
    return time.perf_counter() - t0


def phase_server(params, cfg, slab_toks, slab_shared, engine_step_ms, card,
                 max_new=32):
    """The engine phase's eight requests through ``OpenAIServer`` (max_batch
    8, max_seq 2048), each from a client thread of its own, sent at once:
    non-streamed, then streamed; every stream must equal the engine
    phase's. Then logprobs, n=2, a repetition penalty, a client that drops
    mid-stream, /metrics and /v1/stats; B1-B4 must launch. A second server
    over the paged engine (kv_page_size 128, sharing on) serves the four
    shared-prefix requests: streams equal the slab engine's, B5 launches.
    Counts are reset before each server's traffic and read after it."""
    from bigdl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from bigdl_tpu_torch.serving.engine import EngineConfig
    from bigdl_tpu_torch.utils.testing import SyntheticCausalLM

    model = SyntheticCausalLM(params, cfg)
    _, requests = _engine_requests(cfg, max_new)
    total = {}
    res = {"phase": "server", "model": "llama2-7b", "qtype": "sym_int4",
           "requests": len(requests), "max_new_tokens": max_new,
           "card": card, "engine_phase_decode_step_ms": engine_step_ms}
    srv = _Served(model, EngineConfig(max_batch=8, max_seq=2048))
    try:
        reset_launch_counts()
        bodies = [_body(p, sp) for _, p, sp in requests]
        t0 = time.perf_counter()
        plain = srv.concurrent(bodies)
        res["nonstream"] = {
            "wall_s": time.perf_counter() - t0,
            "latency_s": [o[3] for o in plain], **srv.decode_perf()}
        t0 = time.perf_counter()
        streamed = srv.concurrent(bodies, stream=True)
        res["stream"] = {
            "wall_s": time.perf_counter() - t0,
            "ttft_s": [o[2] for o in streamed],
            "latency_s": [o[3] for o in streamed], **srv.decode_perf()}
        same = {r: (plain[i][0] == slab_toks[r], streamed[i][0]
                    == slab_toks[r]) for i, (r, _, _) in enumerate(requests)}
        res["equal_to_engine"] = same
        require(all(o[1] == "length" for o in plain),
                f"server: finish reasons {[o[1] for o in plain]}")
        require(all(a and b for a, b in same.values()),
                f"server: streams differ from the engine phase's: {same}")

        r0, p0, sp0 = requests[0]
        ids, _, _, _, out = srv.post(_body(p0, sp0, max_tokens=8,
                                           logprobs=5))
        lp = out["choices"][0]["logprobs"]
        top1 = [max(d.values()) for d in lp["top_logprobs"]]
        res["logprobs"] = {"ids_equal": ids == slab_toks[r0][:8],
                           "top1_minus_chosen": [
                               a - b for a, b in
                               zip(top1, lp["token_logprobs"])]}
        require(ids == slab_toks[r0][:8], "server: logprobs changed tokens")
        require(top1 == lp["token_logprobs"] and all(
            len(d) == 5 for d in lp["top_logprobs"]),
            "server: top-1 logprob is not the chosen token's")

        _, p5, sp5 = requests[5]
        _, _, _, _, out = srv.post(_body(p5, sp5, max_tokens=8, n=2))
        lens = [len(c["text"].split()) for c in out["choices"]]
        res["n2"] = {"choices": [c["index"] for c in out["choices"]],
                     "tokens": lens}
        require([c["index"] for c in out["choices"]] == [0, 1]
                and lens == [8, 8], f"server: n=2 gave {res['n2']}")

        _, p1, sp1 = requests[1]
        pen = [srv.post(_body(p1, sp1, max_tokens=16,
                              repetition_penalty=1.8)) for _ in range(2)]
        res["repetition_penalty"] = {
            "repeat": pen[0][0] == pen[1][0],
            "finish": [o[1] for o in pen],
            "differs_from_unpenalized": pen[0][0] != slab_toks["r1"][:16]}
        require(pen[0][0] == pen[1][0] and len(pen[0][0]) == 16,
                "server: a penalized request did not repeat")

        cancelled = srv.server._cancelled.labels("stream")
        before = cancelled.value
        res["dropped_client_idle_s"] = _drop_mid_stream(srv, p0, 512)
        recent = srv.engine.stats_snapshot()["requests"]["recent"]
        res["dropped_client"] = {
            "finish_reason": recent[-1]["finish_reason"],
            "n_generated": recent[-1]["n_generated"],
            "cancelled": cancelled.value - before}
        require(recent[-1]["finish_reason"] == "abort"
                and cancelled.value == before + 1,
                f"server: dropped client {res['dropped_client']}")

        code, text = srv.get("/metrics")
        text = text.decode()
        missing = [f for f in SERVER_FAMILIES if f"# TYPE {f} " not in text]
        code2, stats = srv.get("/v1/stats")
        stats = json.loads(stats)
        summ = stats["metrics"]
        res["metrics"] = {
            k: summ.get(k) for k in (
                "bigdl_tpu_ttft_seconds", "bigdl_tpu_tpot_seconds",
                "bigdl_tpu_engine_steps_total",
                "bigdl_tpu_tokens_generated_total",
                'bigdl_tpu_requests_finished_total{reason="abort"}',
                'bigdl_tpu_requests_finished_total{reason="length"}')}
        res["loop_errors"] = srv.server.loop.errors
        require(code == code2 == 200 and not missing,
                f"server: /metrics lacks {missing}")
        require(stats["loop_errors"] == 0 and srv.server.loop.errors == 0,
                f"server: the engine loop raised: {srv.server.loop.last_error}")
        counts = launch_counts()
        res["launches"] = counts
        missing = [k for k in ("dequant_gemv", "dequant_gemm",
                               "decode_attention", "prefill_attention")
                   if counts[k] <= 0]
        require(not missing, f"server: kernels never launched: {missing}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    finally:
        srv.close()
    del srv
    gc.collect()
    torch.cuda.empty_cache()

    shared = _shared_prefix_requests(cfg, max_new)
    srv = _Served(model, EngineConfig(max_batch=8, max_seq=2048,
                                      kv_page_size=128,
                                      prefix_sharing="on"))
    try:
        reset_launch_counts()
        t0 = time.perf_counter()
        outs = srv.concurrent([_body(p, sp) for _, p, sp in shared])
        counts = launch_counts()
        snap = srv.engine._paged_snapshot()
        same = {r: outs[i][0] == slab_shared[r]
                for i, (r, _, _) in enumerate(shared)}
        res["paged_shared_prefix"] = {
            "wall_s": time.perf_counter() - t0,
            "latency_s": [o[3] for o in outs], **srv.decode_perf(),
            "equal_to_slab": same, "radix_hits": snap["radix"]["hits"],
            "launches": counts, "loop_errors": srv.server.loop.errors}
        require(all(same.values()), f"server (paged): streams differ from "
                f"the slab engine's: {same}")
        require(counts["paged_decode_attention"] > 0,
                "server (paged): paged decode attention never launched")
        require(srv.server.loop.errors == 0,
                f"server (paged): the engine loop raised: "
                f"{srv.server.loop.last_error}")
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    finally:
        srv.close()
    del srv
    gc.collect()
    torch.cuda.empty_cache()
    emit(res)
    return total

def phase_engine_paged(params, cfg, slab_toks, slab_shared, max_new=32):
    """The engine phase's requests through the paged engine (sharing
    off), then the shared-prefix requests with radix sharing on: every
    stream must equal the slab engine's. Counts are reset before each
    run and read after it."""
    from bigdl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from bigdl_tpu_torch.serving.engine import EngineConfig, LLMEngine
    from bigdl_tpu_torch.utils.testing import SyntheticCausalLM

    model = SyntheticCausalLM(params, cfg)
    total = {}
    for name, sharing, requests, want in (
            ("paged", "off", _engine_requests(cfg, max_new)[1], slab_toks),
            ("paged_shared_prefix", "on",
             _shared_prefix_requests(cfg, max_new), slab_shared)):
        eng = LLMEngine(model, EngineConfig(
            max_batch=8, max_seq=2048, kv_page_size=128,
            prefix_sharing=sharing), device="cuda")
        reset_launch_counts()
        toks, reasons, ttft, perf = _run_requests(eng, requests)
        counts = launch_counts()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        snap = eng._paged_snapshot()
        same = {r: toks[r] == want[r] for r, _, _ in requests}
        res = {"phase": "engine_paged", "run": name, "prefix_sharing":
               sharing, "requests": len(requests),
               "prompt_lens": [len(p) for _, p, _ in requests],
               "launches": counts, "finish_reasons": reasons,
               "ttft_s": ttft, **perf, "paged": snap,
               "equal_to_slab": same,
               "tokens": {r: toks[r][:8] for r, _, _ in requests}}
        emit(res)
        require(all(reasons.get(r) in ("length", "stop")
                    for r, _, _ in requests), f"{name}: not every request "
                f"finished: {reasons}")
        require(all(same.values()), f"{name}: streams differ from the slab "
                f"engine's: {same}")
        require(counts["paged_decode_attention"] > 0,
                f"{name}: paged decode attention never launched")
        require(snap["pool_exhausted_total"] == 0, f"{name}: pool ran dry")
        if sharing == "on":
            require(snap["radix"]["hits"] == len(requests) - 1,
                    f"{name}: radix hits {snap['radix']}")
        del eng
        torch.cuda.empty_cache()
    return total


def phase_prefix_burst(params, cfg, n=32, max_new=64):
    """32 requests of one 1024-token prefix plus a unique token, in a
    129-page arena: the bytes of the 8-slot slab (8 x 16 pages + the null
    page). Without sharing they would need 32 x 9 = 288 pages. Each
    request runs 64 new tokens: admission takes one request per step, so
    with fewer the first request would finish before the last is
    admitted."""
    from bigdl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from bigdl_tpu_torch.ops.paged import paged_cache_nbytes
    from bigdl_tpu_torch.serving.engine import (EngineConfig, LLMEngine,
                                                SamplingParams)
    from bigdl_tpu_torch.utils.testing import SyntheticCausalLM

    rng = np.random.default_rng(13)
    pre = rng.integers(0, cfg.vocab_size, 1024).tolist()
    requests = [(f"b{i}", pre + [int(t)], SamplingParams(max_tokens=max_new))
                for i, t in enumerate(rng.choice(cfg.vocab_size, n,
                                                 replace=False))]
    eng = LLMEngine(SyntheticCausalLM(params, cfg), EngineConfig(
        max_batch=n, max_seq=2048, kv_page_size=128, kv_pages=129,
        prefix_sharing="on"), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    toks, reasons, _, perf = _run_requests(eng, requests)
    counts = launch_counts()
    snap = eng._paged_snapshot()
    hkv, hd, layers = cfg.num_key_value_heads, cfg.hd, cfg.num_hidden_layers
    res = {"phase": "prefix_burst", "requests": n, "prefix": 1024,
           "max_new_tokens": max_new, "max_batch": n, "kv_pages": 129,
           "launches": counts, **perf,
           "paged": snap, "arena_bytes": paged_cache_nbytes(
               layers, 129, 128, hkv, hd)["total"],
           "slab_bytes_8_slots": paged_cache_nbytes(
               layers, 8, 2048, hkv, hd)["total"],
           "slab_bytes_32_slots": paged_cache_nbytes(
               layers, n, 2048, hkv, hd)["total"],
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "finish_reasons": sorted(set(reasons.values()))}
    emit(res)
    require(all(reasons.get(r) in ("length", "stop") for r, _, _ in requests),
            "burst: not every request finished")
    require(all(len(toks[r]) == max_new for r, _, _ in requests),
            "burst: a request produced the wrong number of tokens")
    require(perf["peak_active"] == n,
            f"burst: only {perf['peak_active']} of {n} active at once")
    require(snap["radix"]["hits"] == n - 1
            and snap["radix"]["hit_tokens"] == (n - 1) * 1024,
            f"burst: radix {snap['radix']}")
    require(snap["pool_exhausted_total"] == 0, "burst: pool ran dry")
    require(snap["cow_pages_total"] > 0, "burst: no copy-on-write")
    require(counts["paged_decode_attention"] > 0,
            "burst: paged decode attention never launched")
    return counts


def _prefix_agree(toks, ref):
    """Per request, how many leading tokens equal the reference stream."""
    out = {}
    for r, t in toks.items():
        n = 0
        while n < min(len(t), len(ref[r])) and t[n] == ref[r][n]:
            n += 1
        out[r] = n
    return out


def phase_engine_kv(params, cfg, bf16_toks, max_new=32):
    """The engine phase's eight requests through the slab engine with a
    quantized KV cache, one engine per storage kind, run twice; then the
    shared-prefix requests, whose streams the paged engine must repeat.
    Every request finishes, greedy and seeded streams repeat, the kind's
    B3 and B4 bodies launch, and the cache holds the bytes of the formula.
    Agreement with the bf16 engine's streams is reported, not gated: a
    quantized cache changes the logits."""
    from bigdl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from bigdl_tpu_torch.ops.kvcache import kv_cache_bytes, kv_cache_nbytes
    from bigdl_tpu_torch.serving.engine import EngineConfig, LLMEngine
    from bigdl_tpu_torch.utils.testing import SyntheticCausalLM

    lens, requests = _engine_requests(cfg, max_new)
    shared = _shared_prefix_requests(cfg, max_new)
    model = SyntheticCausalLM(params, cfg)
    total, shared_toks = {}, {}
    for kind in QUANT_KV_KINDS:
        eng = LLMEngine(model, EngineConfig(max_batch=8, max_seq=2048,
                                            kv_cache_dtype=kind),
                        device="cuda")
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        toks1, reasons1, ttft, perf = _run_requests(eng, requests)
        counts = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        toks2, reasons2, _, perf2 = _run_requests(eng, requests)
        reset_launch_counts()
        shared_toks[kind], shared_reasons, _, _ = _run_requests(eng, shared)
        for k, v in launch_counts().items():
            total[k] = total.get(k, 0) + v + counts[k]
        kv = kv_cache_bytes(eng.cache)
        want = kv_cache_nbytes(cfg.num_hidden_layers, 8, 2048,
                               cfg.num_key_value_heads, cfg.hd, kind)
        res = {"phase": "engine_kv", "kv": kind, "model": "llama2-7b",
               "requests": len(requests), "prompt_lens": lens,
               "max_new_tokens": max_new, "launches": counts,
               "finish_reasons": reasons1, "ttft_s": ttft,
               "max_memory_allocated": peak, "kv_cache_bytes": kv,
               "kv_cache_bytes_formula": want, **perf, "repeat_run": perf2,
               "tokens_equal_to_bf16": _prefix_agree(toks1, bf16_toks),
               "streams_equal_to_bf16": sum(toks1[r] == bf16_toks[r]
                                            for r, _, _ in requests),
               "decode_profile": _profile_decode(eng, requests),
               "tokens": {r: toks1[r][:8] for r, _, _ in requests}}
        emit(res)
        _check_streams(f"engine_kv {kind}", requests,
                       ((toks1, reasons1), (toks2, reasons2)), cfg, max_new)
        require(all(shared_reasons.get(r) in ("length", "stop")
                    for r, _, _ in shared),
                f"engine_kv {kind}: a shared-prefix request did not finish")
        for base in ("decode_attention", "prefill_attention"):
            require(counts[f"{base}_{kind}"] > 0,
                    f"engine_kv {kind}: {base}_{kind} never launched")
        require(kv == want, f"engine_kv {kind}: cache bytes {kv} != {want}")
        del eng
        torch.cuda.empty_cache()
    return total, shared_toks


def phase_engine_paged_kv(params, cfg, slab_shared, max_new=32):
    """The shared-prefix requests through the paged engine (kv_page_size
    128, sharing on) with fp8_e5m2, int8 and int4 pages: streams equal the
    slab engine's at the same kind, the radix hits, copy-on-write copies
    pages and their scales, and B5's body for the kind launches."""
    from bigdl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from bigdl_tpu_torch.ops.paged import paged_cache_nbytes
    from bigdl_tpu_torch.serving.engine import EngineConfig, LLMEngine
    from bigdl_tpu_torch.utils.testing import SyntheticCausalLM

    requests = _shared_prefix_requests(cfg, max_new)
    model = SyntheticCausalLM(params, cfg)
    total = {}
    for kind in QUANT_KV_KINDS:
        eng = LLMEngine(model, EngineConfig(
            max_batch=8, max_seq=2048, kv_page_size=128,
            prefix_sharing="on", kv_cache_dtype=kind), device="cuda")
        reset_launch_counts()
        toks, reasons, ttft, perf = _run_requests(eng, requests)
        counts = launch_counts()
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
        snap = eng._paged_snapshot()
        page_bytes = paged_cache_nbytes(cfg.num_hidden_layers, 1, 128,
                                        cfg.num_key_value_heads, cfg.hd,
                                        kind)["total"]
        same = {r: toks[r] == slab_shared[kind][r] for r, _, _ in requests}
        emit({"phase": "engine_paged_kv", "kv": kind, "prefix_sharing": "on",
              "requests": len(requests),
              "prompt_lens": [len(p) for _, p, _ in requests],
              "launches": counts, "finish_reasons": reasons, "ttft_s": ttft,
              **perf, "paged": snap, "kv_bytes_per_page_formula": page_bytes,
              "equal_to_slab": same,
              "tokens": {r: toks[r][:8] for r, _, _ in requests}})
        name = f"engine_paged_kv {kind}"
        require(all(reasons.get(r) in ("length", "stop")
                    for r, _, _ in requests),
                f"{name}: not every request finished: {reasons}")
        require(all(same.values()), f"{name}: streams differ from the slab "
                f"engine's at {kind}: {same}")
        require(counts[f"paged_decode_attention_{kind}"] > 0,
                f"{name}: B5's {kind} body never launched")
        require(snap["radix"]["hits"] == len(requests) - 1,
                f"{name}: radix hits {snap['radix']}")
        require(snap["cow_pages_total"] > 0, f"{name}: no copy-on-write")
        require(snap["pool_exhausted_total"] == 0, f"{name}: pool ran dry")
        require(snap["kv_bytes_per_page"] == page_bytes,
                f"{name}: {snap['kv_bytes_per_page']} bytes a page, formula "
                f"{page_bytes}")
        del eng
        torch.cuda.empty_cache()
    return total


def _hf_config(cfg, n_layers=None):
    """The HF config.json fields of a llama config: what a low-bit
    directory's manifest records and ``load_low_bit`` reads back."""
    return {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
            "vocab_size": cfg.vocab_size, "hidden_size": cfg.hidden_size,
            "intermediate_size": cfg.intermediate_size,
            "num_hidden_layers": n_layers or cfg.num_hidden_layers,
            "num_attention_heads": cfg.num_attention_heads,
            "num_key_value_heads": cfg.num_key_value_heads,
            "max_position_embeddings": cfg.max_position_embeddings,
            "rms_norm_eps": cfg.rms_norm_eps, "rope_theta": cfg.rope_theta,
            "tie_word_embeddings": cfg.tie_word_embeddings}


def _qtensors(tree, prefix=""):
    from bigdl_tpu_torch.ops.quant import QTensor

    if isinstance(tree, QTensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _qtensors(v, f"{prefix}.{k}" if prefix else k)


def phase_reference_prepack(params, cfg):
    """The load entry point on the 2-layer cut: written with the port's
    ``save_low_bit`` to a temporary directory, loaded with
    ``AutoModelForCausalLM.load_low_bit(device="cuda")`` (prepack auto:
    on, since the leaves land on the card). The report must convert every
    sym_int4 QTensor, every loaded leaf must relay back to the saved bytes
    (``from_mxu_layout``), the card forward must run the mxu and i4 bodies
    and no std B1/B2 launch, and its logits must agree with the CPU's
    plain versions of the same bodies within 5% of the logit range (the
    reference phase's check). Full depth is not written to disk."""
    import os
    import shutil
    import tempfile

    from bigdl_tpu_torch.ops.quant import from_mxu_layout
    from bigdl_tpu_torch.transformers import lowbit_io
    from bigdl_tpu_torch.transformers.model import AutoModelForCausalLM

    cut = _cut_params(params, 2)
    d = tempfile.mkdtemp(prefix="bigdl_tpu_torch_lowbit_")
    try:
        t0 = time.perf_counter()
        lowbit_io.save_low_bit(cut, d, config=_hf_config(cfg, 2),
                               family="llama", qtype="sym_int4",
                               extra={"max_seq": 2048})
        save_s = time.perf_counter() - t0
        dir_bytes = sum(os.path.getsize(os.path.join(d, f))
                        for f in os.listdir(d))
        t0 = time.perf_counter()
        model = AutoModelForCausalLM.load_low_bit(d, device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(d, ignore_errors=True)
    saved = dict(_qtensors(cut))
    loaded = dict(_qtensors(model.params))
    n_sym4 = sum(q.qtype == "sym_int4" for q in loaded.values())
    relaid = sorted(saved) == sorted(loaded) and all(
        q.layout == ("int4" if q.qtype == "sym_int4" else "canonical")
        and torch.equal(from_mxu_layout(q).data, saved[k].data)
        and torch.equal(q.scale, saved[k].scale)
        for k, q in loaded.items())
    rep = model.prepack_report
    res = phase_reference(None, cfg, cut=model.params, extra={
        "phase": "reference_prepack", "prepack_report": rep,
        "sym_int4_qtensors": n_sym4, "relaid_bytes_equal_saved": relaid,
        "dir_bytes": dir_bytes, "save_s": save_s, "load_s": load_s,
        "family": model.family.FAMILY, "qtype": model.qtype,
        "max_seq": model.max_seq})
    require(rep["applied"] and rep["converted"] == rep["qtensors"] == n_sym4
            and n_sym4 > 0, f"reference_prepack: report {rep} does not "
            f"convert all {n_sym4} sym_int4 QTensors")
    require(relaid, "reference_prepack: a loaded leaf does not relay back "
            "to the bytes save_low_bit wrote")
    card = res["card_launches"]
    require(card.get("dequant_gemv_mxu", 0) > 0
            and card.get("dequant_gemm_i4", 0) > 0
            and not card.get("dequant_gemv") and not card.get("dequant_gemm"),
            f"reference_prepack: card launches {card}: mxu and i4 must "
            "launch, std B1/B2 must not")


def phase_engine_prepack(params, cfg, slab_toks, slab_peak, max_new=32):
    """The load path's model at full width and depth: a pass of the engine
    phase's eight requests under ``BIGDL_TPU_TORCH_MATMUL_GEMV=fold`` on the
    canonical parameters, then ``TpuCausalLM(params)`` on the card (prepack
    auto: every sym_int4 leaf of `params` is relaid in place, leaf by leaf)
    served by ``LLMEngine(model)``: the eight requests twice and a profiled
    decode window, then once under ``mxuflat`` and once under ``mxu8``
    (``fold`` and ``mxuflat`` with a profiled decode window each).
    Every request finishes, greedy and seeded streams repeat, the mxu and
    i4 bodies launch and the std B1/B2 bodies do not, each flag's body
    launches, and the engine's peak memory is within 1% of the canonical
    engine phase's. How many greedy first tokens equal the canonical
    engine's is reported, not gated (the mxu body's numerics differ)."""
    import os

    from bigdl_tpu_torch.models import llama
    from bigdl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from bigdl_tpu_torch.serving.engine import EngineConfig, LLMEngine
    from bigdl_tpu_torch.transformers.model import TpuCausalLM
    from bigdl_tpu_torch.utils.testing import SyntheticCausalLM

    lens, requests = _engine_requests(cfg, max_new)
    ecfg = EngineConfig(max_batch=8, max_seq=2048)
    total, flag_runs = {}, {}
    env = "BIGDL_TPU_TORCH_MATMUL_GEMV"

    def add(counts):
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v

    def flag_pass(mode, model, body):
        os.environ[env] = mode
        try:
            eng = LLMEngine(model, ecfg, device="cuda")
            reset_launch_counts()
            toks, reasons, _, perf = _run_requests(eng, requests)
            counts = launch_counts()
        finally:
            del os.environ[env]
        add(counts)
        flag_runs[mode] = {"launches": {k: v for k, v in counts.items()
                                        if v},
                           "decode_step_ms": perf["decode_step_ms"],
                           "finish_reasons": reasons}
        require(all(reasons.get(r) in ("length", "stop")
                    for r, _, _ in requests),
                f"engine_prepack {mode}: not every request finished")
        require(counts[body] > 0, f"engine_prepack {mode}: {body} never "
                "launched")
        if mode in ("fold", "mxuflat"):
            # the flag's body in decode: small-M kernels, none past one a
            # B1 call
            prof = _profile_decode(eng, requests)
            flag_runs[mode]["decode_profile"] = prof
            require(prof.get("b1_launches_per_step", 1) > 0,
                    f"engine_prepack {mode}: no small-M B1 kernel in the "
                    f"decode profile: {prof}")
        del eng
        gc.collect()

    flag_pass("fold", SyntheticCausalLM(params, cfg), "dequant_gemv_fold")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = TpuCausalLM(params, cfg, llama, _hf_config(cfg), "sym_int4",
                        max_seq=2048)
    torch.cuda.synchronize()
    load = {"prepack_s": time.perf_counter() - t0,
            "report": model.prepack_report, "memory_before": before,
            "peak_memory_during": torch.cuda.max_memory_allocated(),
            "memory_after": torch.cuda.memory_allocated()}
    require(model.prepack_report["converted"]
            == model.prepack_report["qtensors"] > 0,
            f"engine_prepack: report {model.prepack_report}")

    eng = LLMEngine(model, ecfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    toks1, reasons1, ttft, perf = _run_requests(eng, requests)
    counts = launch_counts()
    toks2, reasons2, _, perf2 = _run_requests(eng, requests)
    peak = torch.cuda.max_memory_allocated()      # as the engine phase's
    add(counts)
    prof = _profile_decode(eng, requests)
    del eng
    gc.collect()
    greedy = [r for r, _, sp in requests if sp.temperature <= 0]
    res = {"phase": "engine_prepack", "model": "llama2-7b",
           "qtype": "sym_int4", "layout": "int4", "load": load,
           "requests": len(requests), "prompt_lens": lens,
           "max_new_tokens": max_new,
           "launches": {k: v for k, v in counts.items() if v},
           "finish_reasons": reasons1, "ttft_s": ttft,
           "max_memory_allocated": peak,
           "engine_phase_max_memory_allocated": slab_peak, **perf,
           "repeat_run": perf2, "decode_profile": prof,
           "greedy_first_tokens_equal_canonical": sum(
               toks1[r][0] == slab_toks[r][0] for r in greedy),
           "greedy_requests": len(greedy),
           "tokens_equal_to_canonical": _prefix_agree(toks1, slab_toks),
           "tokens": {r: toks1[r][:8] for r, _, _ in requests}}
    flag_pass("mxuflat", model, "dequant_gemv_mxuflat")
    flag_pass("mxu8", model, "dequant_gemv_mxu8")
    res["flag_runs"] = flag_runs
    emit(res)
    _check_streams("engine_prepack", requests,
                   ((toks1, reasons1), (toks2, reasons2)), cfg, max_new)
    require(counts["dequant_gemv_mxu"] > 0 and counts["dequant_gemm_i4"] > 0,
            f"engine_prepack: mxu/i4 launches {counts}")
    require(counts["dequant_gemv"] == 0 and counts["dequant_gemm"] == 0,
            f"engine_prepack: std B1/B2 launched on the prepacked model: "
            f"{counts}")
    require(abs(peak - slab_peak) <= 0.01 * slab_peak,
            f"engine_prepack: peak memory {peak} not within 1% of the "
            f"engine phase's {slab_peak}")
    return total


def phase_model_moe():
    from bigdl_tpu_torch.models.llama import merge_projections
    from bigdl_tpu_torch.utils.testing import (MIXTRAL_8X7B,
                                               random_mixtral_params)

    cfg = MIXTRAL_8X7B
    t0 = time.perf_counter()
    params = merge_projections(random_mixtral_params(
        cfg, "sym_int4", seed=0, device="cuda"), cfg)
    torch.cuda.synchronize()
    emit({"phase": "model_moe", "model": "mixtral-8x7b", "qtype": "sym_int4",
          "layers": cfg.num_hidden_layers,
          "experts": cfg.num_local_experts,
          "build_s": time.perf_counter() - t0,
          "memory_allocated": torch.cuda.memory_allocated()})
    return params, cfg


def phase_reference_moe(params, cfg):
    """2-layer cut: 8 prompts of 32 tokens (a 256-row prefill, B6) and one
    decode step of 8 rows (B6) on the card, against the CPU running the
    ragged dispatch on B6's plain version. A router's top-k is
    discontinuous: a token whose k-th and (k+1)-th logits lie within the
    two devices' bf16 noise picks another expert on each. So the CPU run
    takes the card's expert choices (with its own logits' weights), which
    holds the arithmetic of every layer to the tolerance; the tokens whose
    own CPU choice differed are counted."""
    import dataclasses
    import os

    from bigdl_tpu_torch.models import llama, mixtral
    from bigdl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    cut_cfg = dataclasses.replace(cfg, num_hidden_layers=2)
    gpu_params = _cut_params(params, 2)
    cpu_params = _to_device(gpu_params, "cpu")
    rng = np.random.default_rng(4)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, (8, 32)))
    nxt = torch.tensor(rng.integers(0, cfg.vocab_size, (8, 1)))
    out = {}
    route, card_topi, flips = llama._route, [], [0, 0]

    def record(xf, router, k):
        topi, w = route(xf, router, k)
        card_topi.append(topi.cpu())
        return topi, w

    def replay(xf, router, k):
        own, _ = route(xf, router, k)
        topi = card_topi[flips[1]]
        flips[0] += int((own != topi).any(dim=-1).sum())
        flips[1] += 1
        logits = torch.matmul(xf.to(torch.float32),
                              router.to(xf.dtype).to(torch.float32))
        return topi, torch.softmax(logits.gather(1, topi), dim=-1)

    env = os.environ.get("BIGDL_TPU_TORCH_MOE_DISPATCH")
    reset_launch_counts()
    for dev, p in (("cuda", gpu_params), ("cpu", cpu_params)):
        if dev == "cpu":
            os.environ["BIGDL_TPU_TORCH_MOE_DISPATCH"] = "ragged"
        llama._route = record if dev == "cuda" else replay
        try:
            cache = mixtral.new_cache(cut_cfg, 8, 256, device=dev)
            with torch.no_grad():
                lg1, cache = mixtral.forward(p, cut_cfg, prompt.to(dev),
                                             cache)
                lg2, cache = mixtral.forward(p, cut_cfg, nxt.to(dev), cache)
            out[dev] = (lg1.float().cpu(), lg2.float().cpu())
        finally:
            llama._route = route
            if env is None:
                os.environ.pop("BIGDL_TPU_TORCH_MOE_DISPATCH", None)
            else:
                os.environ["BIGDL_TPU_TORCH_MOE_DISPATCH"] = env
        if dev == "cuda":
            counts = launch_counts()
    res = {"phase": "reference_moe", "layers": 2, "batch": 8, "prompt": 32,
           "launches": counts, "router_calls": flips[1],
           "tokens_routed_otherwise_on_cpu": flips[0]}
    ok = counts["ragged_expert_matmul"] > 0
    for i, name in enumerate(("prefill", "decode")):
        got, want = out["cuda"][i], out["cpu"][i]
        scale = float(want.abs().max())
        err = max_err(got, want)
        fin = bool(torch.isfinite(got).all())
        good = fin and got.shape == want.shape and err <= 0.05 * scale
        top1 = float((got.argmax(-1) == want.argmax(-1)).float().mean())
        res[name] = {"shape": list(got.shape), "max_abs_err": err,
                     "ref_max_abs": scale, "tol": 0.05 * scale,
                     "finite": fin, "top1_agree": top1, "ok": good}
        ok &= good
    emit(res)
    require(ok, "Mixtral card forward disagrees with the CPU plain forward "
            "or never launched B6")
    del cpu_params


def _check_streams(name, requests, runs, cfg, max_new):
    """Every request finished with max_new in-vocabulary tokens, and the
    runs' greedy and seeded streams repeat."""
    (toks1, reasons1), (toks2, _) = runs
    require(all(reasons1.get(r) in ("length", "stop") for r, _, _ in requests),
            f"{name}: not every request finished: {reasons1}")
    require(all(len(toks1[r]) == max_new for r, _, _ in requests),
            f"{name}: a request produced the wrong number of tokens")
    require(all(0 <= t < cfg.vocab_size for v in toks1.values() for t in v),
            f"{name}: token outside the vocabulary")
    require(all(toks1[r] == toks2[r] for r, _, _ in requests),
            f"{name}: streams did not repeat")


def phase_engine_moe(params, cfg, max_new=32):
    """The engine phase's eight requests through LLMEngine serving
    Mixtral-8x7B (max_batch 8: decode is 16 token-choices over 8 experts,
    the ragged dispatch), twice, then a profiled decode window."""
    from bigdl_tpu_torch.models import mixtral
    from bigdl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from bigdl_tpu_torch.serving.engine import EngineConfig, LLMEngine
    from bigdl_tpu_torch.utils.testing import SyntheticCausalLM

    lens, requests = _engine_requests(cfg, max_new)
    eng = LLMEngine(SyntheticCausalLM(params, cfg, family=mixtral),
                    EngineConfig(max_batch=8, max_seq=2048), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    toks1, reasons1, ttft, perf = _run_requests(eng, requests)
    counts = launch_counts()
    toks2, reasons2, _, perf2 = _run_requests(eng, requests)
    dec = perf["decode_launches"]
    res = {"phase": "engine_moe", "model": "mixtral-8x7b",
           "qtype": "sym_int4", "layers": cfg.num_hidden_layers,
           "requests": len(requests), "prompt_lens": lens,
           "max_new_tokens": max_new, "launches": counts,
           "finish_reasons": reasons1, "ttft_s": ttft,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           **perf, "repeat_run": perf2,
           "decode_profile": _profile_decode(eng, requests),
           "tokens": {r: toks1[r][:8] for r, _, _ in requests}}
    emit(res)
    _check_streams("engine_moe", requests,
                   ((toks1, reasons1), (toks2, reasons2)), cfg, max_new)
    missing = [k for k in ("dequant_gemv", "dequant_gemm", "decode_attention",
                           "prefill_attention", "ragged_expert_matmul")
               if counts[k] <= 0]
    require(not missing, f"engine_moe: kernels never launched: {missing}")
    require(dec["ragged_expert_matmul"] > 0,
            "engine_moe: B6 never launched in a decode step")
    require(counts["ragged_expert_matmul"] > dec["ragged_expert_matmul"],
            "engine_moe: B6 never launched in a prefill step")
    return counts


def phase_engine_moe_gather(params, cfg, max_new=32):
    """Four greedy requests at max_batch 4: decode has N * k = 8 <= 8
    token-choices, so it gathers the chosen experts (B1 at M = 1); B6 runs
    only in prefill."""
    from bigdl_tpu_torch.models import mixtral
    from bigdl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts
    from bigdl_tpu_torch.serving.engine import EngineConfig, LLMEngine
    from bigdl_tpu_torch.utils.testing import SyntheticCausalLM

    _, requests = _engine_requests(cfg, max_new)
    requests = [q for q in requests if q[2].temperature <= 0][:4]
    eng = LLMEngine(SyntheticCausalLM(params, cfg, family=mixtral),
                    EngineConfig(max_batch=4, max_seq=2048), device="cuda")
    reset_launch_counts()
    toks1, reasons1, ttft, perf = _run_requests(eng, requests)
    counts = launch_counts()
    toks2, reasons2, _, perf2 = _run_requests(eng, requests)
    dec = perf["decode_launches"]
    emit({"phase": "engine_moe_gather", "model": "mixtral-8x7b",
          "max_batch": 4, "requests": len(requests),
          "prompt_lens": [len(p) for _, p, _ in requests],
          "launches": counts, "finish_reasons": reasons1, "ttft_s": ttft,
          **perf, "repeat_run": perf2,
          "tokens": {r: toks1[r][:8] for r, _, _ in requests}})
    _check_streams("engine_moe_gather", requests,
                   ((toks1, reasons1), (toks2, reasons2)), cfg, max_new)
    require(dec["dequant_gemv"] > 0 and dec["ragged_expert_matmul"] == 0,
            f"engine_moe_gather: decode launches {dec}: B1 must launch and "
            "B6 must not")
    return counts


# -- the float checkpoint entry and the generator --------------------------------

def _llama_hf_shapes(cfg, n_layers):
    """(HF name, [out, in] shape or [D], init std; 0 = ones) of a llama
    checkpoint, layer by layer, then the top-level tensors."""
    d, f, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    kv = cfg.num_key_value_heads * cfg.hd
    for i in range(n_layers):
        p = f"model.layers.{i}."
        yield [(p + "self_attn.q_proj.weight", (d, d), 0.02),
               (p + "self_attn.k_proj.weight", (kv, d), 0.02),
               (p + "self_attn.v_proj.weight", (kv, d), 0.02),
               (p + "self_attn.o_proj.weight", (d, d), 0.02),
               (p + "mlp.gate_proj.weight", (f, d), 0.02),
               (p + "mlp.up_proj.weight", (f, d), 0.02),
               (p + "mlp.down_proj.weight", (d, f), 0.02),
               (p + "input_layernorm.weight", (d,), 0),
               (p + "post_attention_layernorm.weight", (d,), 0)]
    yield [("model.embed_tokens.weight", (v, d), 0.02),
           ("model.norm.weight", (d,), 0),
           ("lm_head.weight", (v, d), 0.02)]


def _mixtral_hf_shapes(cfg, n_layers):
    d, f = cfg.hidden_size, cfg.intermediate_size
    for i, shard in enumerate(_llama_hf_shapes(cfg, n_layers)):
        if i == n_layers:
            yield shard
            continue
        p = f"model.layers.{i}.block_sparse_moe."
        attn = [t for t in shard if ".mlp." not in t[0]]
        experts = [(p + f"experts.{e}.{w}.weight", shape, 0.02)
                   for e in range(cfg.num_local_experts)
                   for w, shape in (("w1", (f, d)), ("w3", (f, d)),
                                    ("w2", (d, f)))]
        yield attn + [(p + "gate.weight", (cfg.num_local_experts, d),
                       0.02)] + experts


def _write_hf_checkpoint(path, hf_config, shards, seed):
    """A bf16 HF checkpoint at `path`: one safetensors file a shard (a
    list of (name, shape, std)), a model.safetensors.index.json and the
    config. Each tensor is drawn on the card from its own seed when the
    writer reaches it and crosses to the host as its uint16 bits, so one
    tensor at a time is on the host."""
    import os

    from bigdl_tpu_torch.transformers.lowbit_io import write_safetensors

    os.makedirs(path, exist_ok=True)
    gen = torch.Generator(device="cuda")
    weight_map, total, shards = {}, 0, list(shards)

    def fetch(shape, std, s):
        def f():
            if not std:
                t = torch.ones(shape, dtype=torch.bfloat16, device="cuda")
            else:
                gen.manual_seed(s)
                t = (torch.randn(shape, generator=gen, device="cuda")
                     * std).to(torch.bfloat16)
            return t.view(torch.int16).cpu().numpy().view(np.uint16)
        return f

    n = 0
    for j, shard in enumerate(shards):
        fname = f"model-{j + 1:05d}-of-{len(shards):05d}.safetensors"
        tensors = {}
        for name, shape, std in shard:
            tensors[name] = ("BF16", shape, fetch(shape, std, seed * 10000 + n))
            weight_map[name] = fname
            total += 2 * int(np.prod(shape))
            n += 1
        write_safetensors(os.path.join(path, fname), tensors)
    with open(os.path.join(path, "model.safetensors.index.json"), "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f)
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(hf_config, f)
    return total


def _dir_bytes(path):
    import os

    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def _timed_load(path, **kw):
    """from_pretrained on the card: (model, load s, peak and final device
    bytes above what was allocated before)."""
    from bigdl_tpu_torch.transformers.model import AutoModelForCausalLM

    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = AutoModelForCausalLM.from_pretrained(path, device="cuda", **kw)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    return (model, load_s, torch.cuda.max_memory_allocated() - base,
            torch.cuda.memory_allocated() - base)


def _leaf_of(params, cfg, name):
    """The loaded QTensor of one HF linear (one layer, canonical layout)
    and the columns its weight takes there (merged q/k/v, gate/up)."""
    from bigdl_tpu_torch.ops.quant import from_mxu_layout

    if name == "lm_head.weight":
        return from_mxu_layout(params["lm_head"]), 0, cfg.vocab_size
    parts = name.split(".")
    i, proj = int(parts[2]), parts[4]
    d, f = cfg.hidden_size, cfg.intermediate_size
    kv = cfg.num_key_value_heads * cfg.hd
    layers = params["layers"]
    where = {"q_proj": ("qkv_proj", 0, d), "k_proj": ("qkv_proj", d, d + kv),
             "v_proj": ("qkv_proj", d + kv, d + 2 * kv),
             "gate_proj": ("gate_up_proj", 0, f),
             "up_proj": ("gate_up_proj", f, 2 * f),
             "o_proj": ("o_proj", 0, d), "down_proj": ("down_proj", 0, d)}
    key, c0, c1 = where[proj]
    return from_mxu_layout(layers[key].index(i)), c0, c1


def _card_bytes_equal_cpu(model, path, qtype):
    """Every quantized leaf of a load (prepack undone) against the port's
    quantize on the CPU of the same checkpoint tensor: (leaves checked,
    names whose bytes differ)."""
    from bigdl_tpu_torch.ops.quant import quantize
    from bigdl_tpu_torch.utils.hf import iter_hf_tensors

    n, bad = 0, []
    for name, w in iter_hf_tensors(path):
        if not name.endswith("proj.weight") and name != "lm_head.weight":
            continue
        want = quantize(w.to(torch.float32).t().contiguous(), qtype)
        leaf, c0, c1 = _leaf_of(model.params, model.config, name)
        same = (torch.equal(leaf.data[:, c0:c1].cpu(), want.data)
                and torch.equal(leaf.scale[:, c0:c1].cpu().view(torch.int16),
                                want.scale.view(torch.int16))
                and (want.zero is None or torch.equal(
                    leaf.zero[:, c0:c1].cpu().view(torch.int16),
                    want.zero.view(torch.int16))))
        n += 1
        if not same:
            bad.append(name)
    return n, bad


def phase_hf_load(cfg, n_layers=4):
    """The README's Quick start entry: a Llama-2-7B float checkpoint at
    full width and `n_layers` layers (bf16, sharded under an index, seeded
    weights, written here with ``write_safetensors``) through
    ``from_pretrained(load_in_4bit=True)`` on the card, then
    ``load_in_low_bit`` nf4 and bf16. Each load: its time, its peak
    device memory (at most four f32 copies of the largest tensor above
    the final parameters: one tensor's quantization transients, no second
    copy of the model), the 2-layer cut's prefill and decode logits
    against the CPU's (``phase_reference``), and for the quantized loads
    every leaf, prepack undone, byte-equal to the CPU's quantize of the
    same tensor."""
    import shutil
    import tempfile

    from bigdl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    hf_config = {**_hf_config(cfg, n_layers), "torch_dtype": "bfloat16",
                 "bos_token_id": 1, "eos_token_id": 2}
    path = tempfile.mkdtemp(prefix="bigdl_tpu_torch_hf_")
    counts = {}
    try:
        t0 = time.perf_counter()
        total = _write_hf_checkpoint(path, hf_config,
                                     _llama_hf_shapes(cfg, n_layers), seed=5)
        write_s = time.perf_counter() - t0
        largest_f32 = 4 * cfg.vocab_size * cfg.hidden_size
        for qtype in ("sym_int4", "nf4", "bf16"):
            kw = ({"load_in_4bit": True} if qtype == "sym_int4"
                  else {"load_in_low_bit": qtype})
            reset_launch_counts()
            model, load_s, peak, final = _timed_load(path, **kw)
            rec = {"phase": f"hf_load_{qtype}", "model": "llama2-7b",
                   "layers": n_layers, "checkpoint_bytes": total,
                   "dir_bytes": _dir_bytes(path), "write_s": write_s,
                   "load_s": load_s, "peak_bytes": peak,
                   "final_param_bytes": final,
                   "peak_over_final_bytes": peak - final,
                   "allowed_over_final_bytes": 4 * largest_f32,
                   "prepack_report": model.prepack_report,
                   "load_launches": {k: v for k, v in launch_counts().items()
                                     if v}}
            if qtype != "bf16":
                t0 = time.perf_counter()
                rec["leaves_checked"], rec["leaves_differing"] = \
                    _card_bytes_equal_cpu(model, path, qtype)
                rec["byte_check_s"] = time.perf_counter() - t0
            res = phase_reference(None, cfg, cut=_cut_params(model.params, 2),
                                  extra=rec)
            for k, v in res["card_launches"].items():
                counts[k] = counts.get(k, 0) + v
            require(peak - final <= 4 * largest_f32,
                    f"hf_load {qtype}: peak {peak} exceeds the final "
                    f"parameters {final} by more than four f32 copies of the "
                    "largest tensor")
            if qtype != "bf16":
                require(rec["leaves_checked"] == 7 * n_layers + 1
                        and not rec["leaves_differing"],
                        f"hf_load {qtype}: leaves quantized on the card "
                        f"differ from the CPU's: {rec['leaves_differing']}")
            if qtype == "sym_int4":
                card = res["card_launches"]
                require(card.get("dequant_gemv_mxu", 0) > 0
                        and card.get("dequant_gemm_i4", 0) > 0,
                        f"hf_load: card launches {card}: the prepacked load "
                        "must run mxu and i4")
            del model
    finally:
        shutil.rmtree(path, ignore_errors=True)
    return counts


def phase_hf_load_moe(cfg, n_layers=1):
    """A Mixtral-8x7B float checkpoint at full width and `n_layers`
    layer(s) through ``from_pretrained`` at sym_int4 and at bf16 (dense
    expert stacks): a 256-token prefill and one decode step on each, then
    8 sequences of 16 tokens and one decode forward of the 8, with finite
    logits of the expected shapes; B6 (its dense body at bf16) must launch
    in the 256-token prefill (the tiles entry: 512 token-choices) and in
    the 8-sequence decode (the small-M entry: 16)."""
    import shutil
    import tempfile

    from bigdl_tpu_torch.models import mixtral
    from bigdl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    hf_config = {**_hf_config(cfg, n_layers),
                 "architectures": ["MixtralForCausalLM"],
                 "model_type": "mixtral", "torch_dtype": "bfloat16",
                 "num_local_experts": cfg.num_local_experts,
                 "num_experts_per_tok": cfg.num_experts_per_tok,
                 "eos_token_id": 2}
    path = tempfile.mkdtemp(prefix="bigdl_tpu_torch_hf_moe_")
    counts = {}
    rng = np.random.default_rng(4)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, (1, 256)),
                          device="cuda")
    prompt8 = torch.tensor(rng.integers(0, cfg.vocab_size, (8, 16)),
                           device="cuda")
    try:
        t0 = time.perf_counter()
        total = _write_hf_checkpoint(path, hf_config,
                                     _mixtral_hf_shapes(cfg, n_layers),
                                     seed=6)
        write_s = time.perf_counter() - t0
        for qtype, body in (("sym_int4", "ragged_expert_matmul"),
                            ("bf16", "ragged_expert_matmul_dense")):
            model, load_s, peak, final = _timed_load(
                path, load_in_low_bit=qtype)
            mcfg = model.config
            reset_launch_counts()
            with torch.no_grad():
                cache = mixtral.new_cache(mcfg, 1, 2048, device="cuda")
                lg1, cache = mixtral.forward(model.params, mcfg, prompt,
                                             cache)
                torch.cuda.synchronize()
                b6_prefill = launch_counts()[body]
                lg2, cache = mixtral.forward(model.params, mcfg,
                                             prompt[:, -1:], cache)
                # 8 sequences of 16 tokens, then one decode forward: its
                # 16 token-choices take B6's small-M entry
                cache8 = mixtral.new_cache(mcfg, 8, 2048, device="cuda")
                lg3, cache8 = mixtral.forward(model.params, mcfg, prompt8,
                                              cache8)
                torch.cuda.synchronize()
                before = launch_counts()[body]
                lg4, cache8 = mixtral.forward(model.params, mcfg,
                                              prompt8[:, -1:], cache8)
                torch.cuda.synchronize()
                b6_decode8 = launch_counts()[body] - before
            card = {k: v for k, v in launch_counts().items() if v}
            for k, v in card.items():
                counts[k] = counts.get(k, 0) + v
            logits = (lg1, lg2, lg3, lg4)
            fin = all(bool(torch.isfinite(lg).all()) for lg in logits)
            shapes = [list(lg.shape) for lg in logits]
            stacks = {k: (getattr(v, "qtype", None) or str(v.dtype),
                          list(v.data.shape if hasattr(v, "qtype")
                               else v.shape))
                      for k, v in model.params["layers"].items()
                      if k.startswith("experts_")}
            emit({"phase": f"hf_load_moe_{qtype}", "model": "mixtral-8x7b",
                  "layers": n_layers, "checkpoint_bytes": total,
                  "write_s": write_s, "load_s": load_s, "peak_bytes": peak,
                  "final_param_bytes": final, "expert_stacks": stacks,
                  "launches": card, "b6_prefill_launches": b6_prefill,
                  "b6_decode8_launches": b6_decode8,
                  "logits_shapes": shapes, "finite": fin})
            v = cfg.vocab_size
            require(fin and shapes == [[1, 256, v], [1, 1, v], [8, 16, v],
                                       [8, 1, v]],
                    f"hf_load_moe {qtype}: logits {shapes}, finite {fin}")
            require(b6_prefill > 0 and b6_decode8 > 0,
                    f"hf_load_moe {qtype}: {body} launched {b6_prefill} "
                    f"times in the prefill (the tiles entry) and "
                    f"{b6_decode8} in the 8-sequence decode (the small-M "
                    f"entry): {card}")
            del model, cache, cache8
    finally:
        shutil.rmtree(path, ignore_errors=True)
    return counts


def _gen_run(fn, name):
    """fn() twice from launch counts of 0: (first output, counts of the
    first run, seconds of each run); the two outputs must be equal."""
    from bigdl_tpu_torch.ops.cuda import launch_counts, reset_launch_counts

    reset_launch_counts()
    t0 = time.perf_counter()
    a = fn()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    counts = launch_counts()
    b = fn()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    same = np.array_equal(a, b)
    require(same, f"generate {name}: the second run's tokens differ")
    return a, counts, (t1 - t0, t2 - t1)


def _decode_forwards(n_new, prompt_len):
    """Decode forwards of a generate: one a token after the first, plus
    the pad repair when the prompt does not fill its bucket."""
    bucket = 16
    while bucket < prompt_len:
        bucket *= 2
    return n_new - 1 + (bucket != prompt_len)


def phase_generate(params, cfg, card, max_new=64):
    """The README's ``generate`` on the full-depth Llama-2-7B of the
    engine phase (prepacked), as a ``TpuCausalLM``: bs 1 greedy at
    prompts of 16, 100 and 1000 tokens, bs 4 seeded sampling
    (temperature 0.8, top-k 40, top-p 0.95), the same through
    ``model.generator.generate`` with repetition_penalty 1.1, and
    ``generate_stream`` at bs 1; each twice, the tokens repeating. B1 (mxu)
    launches at M 1 and 4 and B3 once a layer each decode forward; B2 (i4)
    and B4 take the 100-token prompt (bucket 128), B4 and the
    dequantize-then-matmul path the 1000-token one (bucket 1024), the plain
    attention the 16-token one. Then the 2-layer cut's greedy stream is
    held teacher-forced against the CPU, and bs 1 TTFT, next-token ms and
    peak memory are reported."""
    import dataclasses

    from bigdl_tpu_torch.generation import GenerationConfig, GenerationStats
    from bigdl_tpu_torch.models import llama
    from bigdl_tpu_torch.ops.matmul import DEQUANT_THEN_MATMUL
    from bigdl_tpu_torch.transformers.model import TpuCausalLM

    model = TpuCausalLM(params, cfg, llama, _hf_config(cfg), "sym_int4",
                        max_seq=2048)
    rng = np.random.default_rng(9)
    L = cfg.num_hidden_layers
    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v

    runs = {}
    torch.cuda.reset_peak_memory_stats()
    for n in (16, 100, 1000):
        ids = rng.integers(3, cfg.vocab_size, (1, n))
        stats = GenerationStats()

        def go(ids=ids, stats=stats):
            stats.rest_token_s.clear()
            return model.generate(ids, max_new_tokens=max_new, stats=stats)

        out, c, secs = _gen_run(go, f"bs1-{n}")
        add(c)
        new = out.shape[1] - n
        fwd = _decode_forwards(new, n)
        runs[f"bs1_{n}"] = {
            "new_tokens": new, "wall_s": secs, "ttft_s": stats.first_token_s,
            "next_token_ms": 1e3 * stats.rest_cost_mean,
            "tokens_per_s": (1.0 / stats.rest_cost_mean
                             if stats.rest_cost_mean else None),
            "launches": {k: v for k, v in c.items() if v},
            "decode_forwards": fwd, "tokens": out[0, n:n + 8].tolist(),
            "attention_route": ("B4" if c["prefill_attention"] else "plain")}
        require(c["decode_attention"] == L * fwd,
                f"generate bs1-{n}: B3 launched {c['decode_attention']} "
                f"times for {fwd} decode forwards of {L} layers")
        require(c["dequant_gemv_mxu"] > 0, f"generate bs1-{n}: no B1 (mxu)")
        require(not c["dequant_gemv"] and not c["dequant_gemm"],
                f"generate bs1-{n}: a std B1/B2 body ran on the prepacked "
                "model")
        if n == 16:
            require(c["prefill_attention"] == 0,
                    "generate bs1-16: a 16-token bucket went to B4")
        else:
            require(c["prefill_attention"] == L,
                    f"generate bs1-{n}: B4 launched "
                    f"{c['prefill_attention']} times, not once a layer")
        if n == 100:
            require(c["dequant_gemm_i4"] > 0,
                    "generate bs1-100: B2 (i4) did not take the prefill")
        runs[f"bs1_{n}"]["ids"] = out
    # the 1000-token prompt's prefill: linears past 128 rows dequantize
    # and multiply (read from the path's profiler range)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model.generate(runs["bs1_1000"]["ids"][:, :1000], max_new_tokens=1)
    dtm = sum(1 for e in prof.events() if e.name == DEQUANT_THEN_MATMUL)
    runs["bs1_1000"]["dequant_then_matmul_calls"] = dtm
    require(dtm > 0, "generate bs1-1000: no linear took the "
            "dequantize-then-matmul path")
    for r in runs.values():
        r.pop("ids")
    peak_bs1 = torch.cuda.max_memory_allocated()

    ids4 = rng.integers(3, cfg.vocab_size, (4, 100))
    samp = dict(do_sample=True, temperature=0.8, top_k=40, top_p=0.95,
                seed=11)
    out4, c, secs = _gen_run(lambda: model.generate(
        ids4, max_new_tokens=max_new, **samp), "bs4-sampled")
    add(c)
    require(c["dequant_gemv_mxu"] > 0, "generate bs4: no B1 (mxu) at M 4")
    runs["bs4_sampled"] = {"wall_s": secs, "tokens": out4[:, 100:108]
                           .tolist(), "launches": {k: v for k, v in
                                                   c.items() if v}}
    gen = GenerationConfig(max_new_tokens=max_new, repetition_penalty=1.1,
                           **samp)
    outp, c, secs = _gen_run(lambda: model.generator.generate(ids4, gen),
                             "bs4-penalized")
    add(c)
    runs["bs4_penalized"] = {
        "wall_s": secs, "tokens": outp[:, :8].tolist(),
        "differs_from_unpenalized": not np.array_equal(outp,
                                                       out4[:, 100:])}
    ids1 = rng.integers(3, cfg.vocab_size, (1, 100))
    stream, c, secs = _gen_run(lambda: list(model.generate_stream(
        ids1, max_new_tokens=max_new)), "stream")
    add(c)
    full = model.generate(ids1, max_new_tokens=max_new)[0, 100:]
    same = stream == full[:len(stream)].tolist()
    runs["stream_bs1"] = {"wall_s": secs, "tokens": len(stream),
                          "equals_generate": same}
    require(same, "generate_stream tokens differ from generate's")
    in_vocab = all(0 <= t < cfg.vocab_size for t in stream)
    require(in_vocab, "generate: token outside the vocabulary")

    # teacher-forced: the 2-layer cut's greedy stream on the card, each
    # chosen token's logit on the CPU within 5% of the row's range of the
    # CPU's best
    cut_cfg = dataclasses.replace(cfg, num_hidden_layers=2)
    cut = _cut_params(params, 2)
    small = TpuCausalLM(cut, cut_cfg, llama, _hf_config(cfg, 2), "sym_int4",
                        max_seq=2048)
    ids_t = rng.integers(3, cfg.vocab_size, (1, 100))
    seq = small.generate(ids_t, max_new_tokens=max_new)
    with torch.no_grad():
        cpu_lg, _ = llama.forward(
            _to_device(cut, "cpu"), cut_cfg,
            torch.from_numpy(seq[:, :-1]).long(),
            llama.new_cache(cut_cfg, 1, 2048, device="cpu"))
    rows = cpu_lg[0, 99:].float()
    chosen = rows[torch.arange(rows.shape[0]),
                  torch.from_numpy(seq[0, 100:]).long()]
    gap = rows.max(-1).values - chosen
    rng_ = rows.max(-1).values - rows.min(-1).values
    worst = float((gap / rng_).max())
    top1 = float((gap == 0).float().mean())
    runs["teacher_forced_cut"] = {"layers": 2, "steps": int(rows.shape[0]),
                                  "worst_gap_of_range": worst,
                                  "cpu_top1_agree": top1, "tol": 0.05}
    require(worst <= 0.05, f"generate: a card token's CPU logit lies "
            f"{worst:.3f} of the range below the CPU's best (tol 0.05)")
    b1 = runs["bs1_100"]
    emit({"phase": "generate", "model": "llama2-7b", "qtype": "sym_int4",
          "layout": "int4", "layers": L, "max_new_tokens": max_new,
          "kv": model.kv_cache_dtype, "runs": runs,
          "bs1_ttft_s": b1["ttft_s"], "bs1_next_token_ms":
          b1["next_token_ms"], "bs1_tokens_per_s": b1["tokens_per_s"],
          "peak_memory_bs1": peak_bs1,
          "peak_memory": torch.cuda.max_memory_allocated(),
          "card": card})
    return counts


def summary(records, counts):
    """One entry per kernel: its launches on the engine run and the
    numbers of its representative main-path case."""
    rep = {
        "dequant_gemv": dict(M=8, linear="gate_up_proj"),
        "dequant_gemm": dict(M=128, linear="gate_up_proj"),
        "dequant_gemv_mxu": dict(M=8, linear="gate_up_proj"),
        "dequant_gemv_fold": dict(M=8, linear="gate_up_proj",
                                  qtype="sym_int4"),
        "dequant_gemv_mxuflat": dict(M=8, linear="gate_up_proj"),
        "dequant_gemv_mxu8": dict(M=8, linear="gate_up_proj",
                                  qtype="sym_int4"),
        "dequant_gemm_i4": dict(M=128, linear="gate_up_proj"),
        "decode_attention": dict(Hkv=32, hd=128),
        "prefill_attention": dict(Sq=256, S=2048, Hkv=32),
        "paged_decode_attention": dict(B=8, Hkv=32, hd=128),
        "ragged_expert_matmul": dict(routing="prefill", linear="gate_up"),
        "ragged_expert_matmul_dense": dict(routing="prefill",
                                           linear="gate_up"),
    }
    for base in _KV_BODIES:
        for kind in QUANT_KV_KINDS:
            rep[f"{base}_{kind}"] = rep[base]
    out = []
    for name, meta in KERNELS.items():
        mine = [r for r in records if r["kernel"] == name]
        main = next(r for r in mine if "ms" in r and all(
            r.get(k) == v for k, v in rep[name].items()))
        extra = {}
        if name.startswith("ragged_expert_matmul"):
            for routing in ("decode", "prefill_uniform"):
                other = next((r for r in mine if "ms" in r and r.get(
                    "linear") == "gate_up" and r.get("routing") == routing),
                    None)
                if other is None:
                    continue
                extra[routing] = {k: other[k] for k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                    "entry", "max_abs_err", "ps_per_weight")}
        if name in ("dequant_gemv_fold", "dequant_gemv_mxuflat",
                    "dequant_gemv_mxu8"):
            # their other token counts and qtypes, on gate_up
            for r in mine:
                if "ms" in r and r.get("linear") == "gate_up_proj" and r \
                        is not main:
                    extra[f"{r['layout']}_{r['qtype']}_M{r['M']}"] = {
                        k: r[k] for k in ("ms", "plain_ms", "bound_ms",
                                          "bound_by", "library_ms",
                                          "max_abs_err")}
        if name.startswith(("decode_attention", "paged_decode_attention",
                            "prefill_attention")):
            # Mixtral-8x7B's GQA (32 query heads on 8 kv heads)
            want = {**rep[name], "Hkv": 8}
            gqa = next(r for r in mine if "ms" in r and all(
                r.get(k) == v for k, v in want.items()))
            extra["gqa"] = {k: gqa[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                "max_abs_err") + (("b3_ms",) if "b3_ms" in gqa else ())}
        out.append({"name": name, "route": "cuda", **meta, **extra,
                    "launches": int(counts.get(name, 0)),
                    "max_abs_err": max(r["max_abs_err"] for r in mine),
                    "ms": main["ms"], "plain_ms": main["plain_ms"],
                    "bound_ms": main["bound_ms"],
                    "bound_by": main["bound_by"],
                    "library_ms": main["library_ms"],
                    **{k: main[k] for k in ("matmul_only_ms", "b3_ms",
                                            "ps_per_weight") if k in main},
                    "case": {k: main[k] for k in main if k in (
                        "kv", "qtype", "layout", "M", "K", "N", "B", "H",
                        "Hkv", "hd", "S", "Sq",
                        "ps", "NP", "pos", "E", "Np", "tokens", "routing",
                        "linear")}})
    emit({"kernels": out})


def main() -> int:
    import bigdl_tpu_torch  # noqa: F401  (fails here without the package)

    try:
        card = phase_device()
        phase_build()
        records = phase_kernels(Timer("cuda"))

        from bigdl_tpu_torch.models.llama import merge_projections
        from bigdl_tpu_torch.utils.testing import (LLAMA2_7B,
                                                   random_llama_params)

        cfg = LLAMA2_7B
        t0 = time.perf_counter()
        params = merge_projections(random_llama_params(
            cfg, "sym_int4", seed=0, device="cuda"), cfg)
        torch.cuda.synchronize()
        emit({"phase": "model", "layers": cfg.num_hidden_layers,
              "build_s": time.perf_counter() - t0,
              "memory_allocated": torch.cuda.memory_allocated()})
        phase_reference(params, cfg)
        # the resident step against the eager step, timed before any
        # torch.profiler window of the process
        resident = phase_resident(params, cfg)
        counts, slab_toks, slab_shared, slab_peak, step_ms = phase_engine(
            params, cfg)
        # main-path launches: each path's run, counted from 0
        more = [resident,
                phase_server(params, cfg, slab_toks, slab_shared, step_ms,
                             card),
                phase_prefill_profile(params, cfg, None, "llama2-7b", 100),
                phase_engine_paged(params, cfg, slab_toks, slab_shared),
                phase_prefix_burst(params, cfg)]
        for kind in ("int8", "int4"):
            phase_reference(params, cfg, kind)
        kv_counts, kv_shared = phase_engine_kv(params, cfg, slab_toks)
        more += [kv_counts, phase_engine_paged_kv(params, cfg, kv_shared)]
        # the load path: a low-bit directory of the 2-layer cut, then the
        # full model prepacked in place (params hold the int4 layout after)
        phase_reference_prepack(params, cfg)
        more.append(phase_engine_prepack(params, cfg, slab_toks, slab_peak))
        # the Quick start: a float checkpoint through from_pretrained, then
        # generate on the full (prepacked) model
        more.append(phase_hf_load(cfg))
        more.append(phase_generate(params, cfg, card))
        del params
        gc.collect()
        torch.cuda.empty_cache()

        from bigdl_tpu_torch.utils.testing import MIXTRAL_8X7B
        more.append(phase_hf_load_moe(MIXTRAL_8X7B))
        moe_params, moe_cfg = phase_model_moe()
        phase_reference_moe(moe_params, moe_cfg)
        from bigdl_tpu_torch.models import mixtral
        more += [phase_resident_moe(moe_params, moe_cfg),
                 phase_engine_moe(moe_params, moe_cfg),
                 phase_prefill_profile(moe_params, moe_cfg, mixtral,
                                       "mixtral-8x7b", 256),
                 phase_engine_moe_gather(moe_params, moe_cfg)]
        for m in more:
            for k, v in m.items():
                counts[k] = counts.get(k, 0) + v
        summary(records, counts)
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
