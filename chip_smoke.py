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
   TFLOP/s). B5 must also equal B3 bit for bit on the same rows laid out
   densely, and B6 each tile of B2 at B2's K split.
4. reference: a 2-layer cut of the full-width model, prefill + one decode
   step on the card (kernels) against the same on the CPU (plain).
5. engine: seeded full-width Llama-2-7B, sym_int4 linears, merged
   projections, through ``LLMEngine`` (max_batch 8, max_seq 2048): eight
   requests whose prompt lengths cover every kernel route, 32 new tokens
   each; every request must finish, greedy and seeded requests must repeat,
   and every kernel's launch count must rise during the run. A last pass
   of the same requests profiles a few pure-decode steps (device time by
   kernel group, launches, idle share).
6. engine_paged: the same eight requests through the paged engine
   (kv_page_size 128, sharing off), then four requests sharing a
   1024-token prefix with radix sharing on: greedy and seeded streams must
   equal the slab engine's, and B5 must launch.
7. prefix_burst: 32 requests of one 1024-token prefix plus one unique
   token in a 129-page arena (the bytes of the 8-slot slab) at max_batch
   32: all 32 must be active at once, the radix must hit 31 times, the
   pool must never run dry, and copy-on-write must copy.
8. model_moe: the Llama model is freed, and full-width, full-depth
   Mixtral-8x7B (sym_int4 linears, random weights from seed 0) is built
   on the card.
9. reference_moe: a 2-layer cut, 8 prompts of 32 tokens then one decode
   step (both through B6) on the card, against the same on the CPU with
   the ragged dispatch on B6's plain version.
10. engine_moe: the engine phase's eight requests through ``LLMEngine``
   serving Mixtral, twice: every request finishes, greedy and seeded
   streams repeat, B1-B4 and B6 launch, B6 in prefill and in decode; then
   a profiled decode window.
11. engine_moe_gather: four greedy requests at max_batch 4, so decode
   gathers the chosen experts (N * k = 8 <= E): streams repeat, and B1
   launches during decode-only steps while B6 does not.

Then a ``kernels`` summary line, the card's name and power limit, and the
final ``{"ok": true, "device": ...}`` line. Any failed check exits non-zero
before the final line is printed. Imports torch, numpy and the port only.
"""

from __future__ import annotations

import gc
import json
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
}

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
    call, so the events time the device, not the Python wrapper."""

    def __init__(self, device):
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device=device)

    def ms(self, fn, iters: int = 10) -> float:
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(iters):
            self.flush.zero_()
            torch.cuda._sleep(1_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            total += start.elapsed_time(end)
        return total / iters


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


def _matmul_case(timer, name, x, w, kernel_fn, iters):
    from bigdl_tpu_torch.ops.cuda.dequant_matmul import plain_q_matmul
    from bigdl_tpu_torch.ops.quant import dequantize

    got = kernel_fn(x, w)
    want = plain_q_matmul(x, w)
    torch.cuda.synchronize()
    err = max_err(got, want)
    ok = allclose(got, want, MATMUL_TOL)
    m, k = x.shape
    n = w.n
    nbytes = (m * k * 2 + w.nbytes + m * n * 2)
    b_ms, b_by = bound_ms(nbytes, 2.0 * m * k * n)
    rec = {"kernel": name, "qtype": w.qtype, "M": m, "K": k, "N": n,
           "max_abs_err": err, "tol": MATMUL_TOL, "ok": ok,
           "bound_ms": b_ms, "bound_by": b_by}
    if iters:
        dense = dequantize(w, torch.bfloat16)
        rec["ms"] = timer.ms(lambda: kernel_fn(x, w), iters)
        rec["plain_ms"] = timer.ms(lambda: plain_q_matmul(x, w), iters)
        # library yardstick: dequantize to bf16, then one cuBLAS GEMM; and
        # the GEMM alone on the pre-dequantized weight (a dense bf16 layer)
        rec["library_ms"] = timer.ms(
            lambda: torch.matmul(x, dequantize(w, torch.bfloat16)), iters)
        rec["matmul_only_ms"] = timer.ms(lambda: torch.matmul(x, dense),
                                         iters)
        del dense
    return rec


def _attn_bounds(q, k, pos_list, sq):
    b, _, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    vis_rows = 0          # K/V rows read once per (slot, kv head)
    pairs = 0             # visible (query, key) pairs
    for p in pos_list:
        vis_rows += min(s, p + sq)
        pairs += sum(min(s, p + i + 1) for i in range(sq))
    nbytes = 2 * q.numel() * 2 + vis_rows * hkv * hd * 2 * 2
    flops = 4.0 * hd * h * pairs
    return bound_ms(nbytes, flops)


def _sdpa(q, k, v, pos_list, sq):
    """One torch.nn.functional.scaled_dot_product_attention call computing
    the same causal attention (timing yardstick only)."""
    import torch.nn.functional as F

    b, _, h, hd = q.shape
    s, hkv = k.shape[1], k.shape[2]
    kid = torch.arange(s, device=q.device)
    qid = torch.tensor(pos_list, device=q.device)[:, None] + torch.arange(
        sq, device=q.device)[None]
    mask = (kid[None, None, :] <= qid[:, :, None])[:, None]   # [B,1,Sq,S]
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def call():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                              enable_gqa=(h != hkv))

    try:
        call()
    except TypeError:           # a torch without enable_gqa: no yardstick
        return None
    return call


def _attn_case(timer, randn, name, b, sq, h, hkv, hd, s, pos_list, timed):
    """One attention kernel against the plain version on the same inputs;
    decode takes per-slot positions, prefill one scalar position."""
    from bigdl_tpu_torch.ops.cuda.decode_attention import (decode_attention,
                                                           plain_attention)
    from bigdl_tpu_torch.ops.cuda.prefill_attention import prefill_attention

    fn = decode_attention if name == "decode_attention" else \
        prefill_attention
    q = randn(b, sq, h, hd).to(torch.bfloat16)
    kc = randn(b, s, hkv, hd).to(torch.bfloat16)
    vc = randn(b, s, hkv, hd).to(torch.bfloat16)
    per_slot = name == "decode_attention"
    pos = torch.tensor(pos_list if per_slot else pos_list[0],
                       dtype=torch.int32, device=q.device)
    scale = hd ** -0.5
    got = fn(q, kc, vc, pos, scale)
    want = plain_attention(q, kc, vc, pos, scale)
    torch.cuda.synchronize()
    b_ms, b_by = _attn_bounds(q, kc, pos_list * (b // len(pos_list)), sq)
    rec = {"kernel": name, "B": b, "Sq": sq, "H": h, "Hkv": hkv, "hd": hd,
           "S": s, "pos": pos_list if per_slot else pos_list[0],
           "max_abs_err": max_err(got, want), "tol": ATTN_TOL,
           "ok": allclose(got, want, ATTN_TOL),
           "bound_ms": b_ms, "bound_by": b_by}
    if timed:
        lib = _sdpa(q, kc, vc, pos_list * (b // len(pos_list)), sq)
        rec.update(ms=timer.ms(lambda: fn(q, kc, vc, pos, scale)),
                   plain_ms=timer.ms(
                       lambda: plain_attention(q, kc, vc, pos, scale)),
                   library_ms=timer.ms(lib) if lib else None)
    return rec


def _paged_case(timer, randn, gen, b, h, hkv, hd, ps, np_, pos_list, timed):
    """B5 against its plain version over a random page permutation, and
    against B3 over the same rows gathered densely (must be bit-equal).
    The last row is idle: an all-null table row, pos past NP * ps."""
    import torch.nn.functional as F

    from bigdl_tpu_torch.ops.cuda.decode_attention import decode_attention
    from bigdl_tpu_torch.ops.cuda.paged_decode_attention import (
        paged_decode_attention, plain_paged_attention)
    from bigdl_tpu_torch.ops.paged import _gather_dense

    dev = gen.device
    p_ = b * np_ + 1
    q = randn(b, 1, h, hd).to(torch.bfloat16)
    ak = randn(p_, ps, hkv, hd).to(torch.bfloat16)
    av = randn(p_, ps, hkv, hd).to(torch.bfloat16)
    perm = torch.randperm(p_ - 1, generator=gen, device=dev) + 1
    bt = perm[:b * np_].reshape(b, np_).to(torch.int32).contiguous()
    bt[-1] = 0
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    scale = hd ** -0.5
    got = paged_decode_attention(q, ak, av, bt, pos, scale)
    want = plain_paged_attention(q, ak, av, bt, pos, scale)
    kd = _gather_dense(ak, bt).contiguous()
    vd = _gather_dense(av, bt).contiguous()
    b3 = decode_attention(q, kd, vd, pos, scale)
    torch.cuda.synchronize()
    s = np_ * ps
    vis = [min(p + 1, s) for p in pos_list]
    nbytes = (2 * q.numel() * 2 + sum(vis) * hkv * hd * 2 * 2
              + bt.numel() * 4 + pos.numel() * 4)
    b_ms, b_by = bound_ms(nbytes, 4.0 * hd * h * sum(vis))
    rec = {"kernel": "paged_decode_attention", "B": b, "H": h, "Hkv": hkv,
           "hd": hd, "ps": ps, "NP": np_, "P": p_, "pos": pos_list,
           "max_abs_err": max_err(got, want), "tol": ATTN_TOL,
           "equal_to_b3": bool(torch.equal(got, b3)),
           "ok": allclose(got, want, ATTN_TOL) and bool(torch.equal(got,
                                                                     b3)),
           "bound_ms": b_ms, "bound_by": b_by}
    if timed:
        kid = torch.arange(s, device=dev)
        mask = (kid[None, :] <= pos[:, None].long())[:, None, None, :]
        qt = q.transpose(1, 2)

        def library():
            # two calls: the dense gather, then one SDPA
            kg = _gather_dense(ak, bt).transpose(1, 2)
            vg = _gather_dense(av, bt).transpose(1, 2)
            return F.scaled_dot_product_attention(qt, kg, vg,
                                                  attn_mask=mask,
                                                  enable_gqa=(h != hkv))

        try:
            library()
        except TypeError:       # a torch without enable_gqa: no yardstick
            library = None
        rec.update(
            ms=timer.ms(lambda: paged_decode_attention(q, ak, av, bt, pos,
                                                       scale)),
            b3_ms=timer.ms(lambda: decode_attention(q, kd, vd, pos, scale)),
            plain_ms=timer.ms(lambda: plain_paged_attention(
                q, ak, av, bt, pos, scale)),
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
        _launch, plain_ragged_expert_matmul, ragged_expert_matmul)
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
    got = ragged_expert_matmul(x, w, te, tr)
    want = plain_ragged_expert_matmul(x, w, te)
    torch.cuda.synchronize()
    nk = routing.numel()
    used = sorted({e_ for e_, rows in zip(te.tolist(), tr.tolist()) if rows})
    nbytes = nk * k * 2 + r.np_ * n * 2 + len(used) * nbytes_w // num_e
    b_ms, b_by = bound_ms(nbytes, 2.0 * nk * k * n)
    rec = {"kernel": "ragged_expert_matmul",
           "qtype": w.qtype if quantized else "bf16",
           "routing": rname,
           "linear": lname, "tokens": routing.shape[0], "E": num_e,
           "Np": r.np_, "K": k, "N": n, "tile_expert": te.tolist(),
           "tile_rows": tr.tolist(), "experts_with_rows": len(used),
           "max_abs_err": max_err(got, want), "tol": MATMUL_TOL,
           "ok": allclose(got, want, MATMUL_TOL),
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
        rec["ms"] = timer.ms(lambda: ragged_expert_matmul(x, w, te, tr),
                             iters)
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

    # B1 / B2 at the five Llama-2-7B linear shapes, sym_int4
    for lname, (k, n) in LLAMA2_7B_LINEARS.items():
        w = quantize(randn(k, n, scale=0.02), "sym_int4")
        for m, fn, kname in ((1, dequant_gemv, "dequant_gemv"),
                             (8, dequant_gemv, "dequant_gemv"),
                             (64, dequant_gemm, "dequant_gemm"),
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

    # B6 at Mixtral-8x7B's expert shapes, sym_int4, under a skewed
    # prefill-chunk routing and a decode routing; the first case is also
    # held tile by tile against B2
    for lname, (k, n) in MIXTRAL_EXPERT_LINEARS.items():
        w = _stack_q(randn, 8, k, n, "sym_int4")
        for rname, routing in (("prefill", _prefill_routing(dev)),
                               ("decode", _decode_routing(gen, dev))):
            rec = _ragged_case(timer, randn, routing, rname, lname, w,
                               iters=10, b2_check=(lname == "gate_up"
                                                   and rname == "prefill"))
            records.append(rec)
            emit({"phase": "kernels", **rec})
        del w
    # every ported qtype at a small, K-padded shape, and the dense bf16
    # body at a small shape and at Mixtral's gate/up shape, untimed
    for qtype in ("sym_int4", "asym_int4", "sym_int8", "nf4", "fp4", "nf3",
                  None):
        w = (_stack_q(randn, 4, 1000, 512, qtype) if qtype else
             randn(4, 1024, 512, scale=0.02).to(torch.bfloat16))
        routing = torch.stack([torch.randperm(4, generator=gen, device=dev)[:2]
                               for _ in range(64)])
        rec = _ragged_case(timer, randn, routing, "random", "small", w,
                           iters=0)
        records.append(rec)
        emit({"phase": "kernels", **rec})
    w = randn(8, 4096, 14336, scale=0.02).to(torch.bfloat16)
    rec = _ragged_case(timer, randn, _prefill_routing(dev), "prefill",
                       "gate_up", w, iters=0)
    records.append(rec)
    emit({"phase": "kernels", **rec})
    del w

    bad = [r for r in records if not r["ok"]]
    require(not bad, f"{len(bad)} kernel case(s) disagree with their plain "
            f"version: {bad[:3]}")
    return records


def _cut_params(params, n_layers):
    from bigdl_tpu_torch.ops.quant import QTensor

    def cut(w):
        if isinstance(w, QTensor):
            return QTensor(w.data[:n_layers], w.scale[:n_layers],
                           None if w.zero is None else w.zero[:n_layers],
                           w.qtype, w.shape)
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


def phase_reference(params, cfg):
    """2-layer cut: prefill 100 tokens (B2, B4) + one decode step (B1, B3)
    on the card against the plain versions on the CPU."""
    import dataclasses

    from bigdl_tpu_torch.models import llama

    cut_cfg = dataclasses.replace(cfg, num_hidden_layers=2)
    gpu_params = _cut_params(params, 2)
    cpu_params = _to_device(gpu_params, "cpu")
    rng = np.random.default_rng(3)
    prompt = torch.tensor(rng.integers(0, cfg.vocab_size, (1, 128)))
    nxt = torch.tensor(rng.integers(0, cfg.vocab_size, (1, 1)))
    out = {}
    for dev, p in (("cuda", gpu_params), ("cpu", cpu_params)):
        cache = llama.new_cache(cut_cfg, 1, 256, device=dev)
        with torch.no_grad():
            lg1, cache = llama.forward(p, cut_cfg, prompt.to(dev), cache)
            lg2, cache = llama.forward(p, cut_cfg, nxt.to(dev), cache)
        out[dev] = (lg1.float().cpu(), lg2.float().cpu())
    res = {"phase": "reference", "layers": 2, "prompt": 128}
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
    require(ok, "card forward disagrees with the CPU plain forward")


def _run_requests(eng, requests):
    """Feed all requests, step to completion; returns tokens, TTFT and
    pure-decode step timing (with each kernel's launches in those steps)."""
    from bigdl_tpu_torch.ops.cuda import launch_counts

    t0 = time.perf_counter()
    for rid, prompt, sp in requests:
        eng.add_request(rid, prompt, sp)
    toks = {rid: [] for rid, _, _ in requests}
    reasons, ttft = {}, {}
    decode_s, decode_tokens, decode_steps, steps = 0.0, 0, 0, 0
    peak = 0
    decode_launches = dict.fromkeys(launch_counts(), 0)
    while eng.has_unfinished():
        pure = eng._admitting is None and not eng.waiting
        n_active = sum(s.active for s in eng.slots)
        before = launch_counts()
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
        else None, "decode_launches": decode_launches}


def _kernel_group(name: str) -> str:
    for key, group in (("ragged_mma", "ragged_expert_matmul (B6)"),
                       ("dequant_mma", "dequant_gemv/gemm (B1/B2)"),
                       ("finalize_kernel", "dequant split-K sum"),
                       ("decode_attention", "decode_attention (B3)"),
                       ("prefill_attention", "prefill_attention (B4)"),
                       ("gemm", "torch matmul"), ("elementwise", "elementwise"),
                       ("reduce", "reductions"), ("index", "cache writes"),
                       ("copy", "copies")):
        if key in name.lower():
            return group
    return "other"


def _device_ms_by_group(prof, steps):
    """(device ms per step by kernel group, launches per step) from a
    finished profile; raises AttributeError on a profiler without the
    fields read here."""
    from torch.autograd import DeviceType

    groups, launches = {}, 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = (getattr(e, "self_device_time_total", 0)
              or getattr(e, "self_cuda_time_total", 0))
        g = _kernel_group(e.key)
        groups[g] = groups.get(g, 0.0) + us / 1e3 / steps
        launches += e.count
    return groups, launches / steps


def _profile_decode(eng, requests, steps=4):
    """Device time of `steps` pure-decode steps (all slots active) by
    kernel group, from torch.profiler, beside the steps' wall time. The
    requests are admitted first and drained after. Only the profiler's
    own start and read-out may fail ("not measured"); a failing engine
    step fails the run."""
    from torch.profiler import ProfilerActivity, profile

    for rid, prompt, sp in requests:
        eng.add_request(rid + "-prof", prompt, sp)
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
    t0 = time.perf_counter()
    for _ in range(steps):
        eng.step()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / steps
    out["wall_ms_per_step"] = wall_ms
    if prof is not None:
        prof.__exit__(None, None, None)
        try:
            groups, launches = _device_ms_by_group(prof, steps)
        except (RuntimeError, AttributeError) as e:
            groups, out["device_ms_per_step"] = {}, f"not measured: {e}"
        if groups:
            dev = sum(groups.values())
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
            eng.get_outputs(rid + "-prof")
    return out


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
    missing = [k for k, v in counts.items() if v <= 0
               and k not in ("paged_decode_attention", "ragged_expert_matmul")]
    require(not missing, f"kernels never launched on the main path: "
            f"{missing}")
    shared = _shared_prefix_requests(cfg, max_new)
    toks3, _, _, _ = _run_requests(eng, shared)
    return counts, toks1, toks3


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


def summary(records, counts):
    """One entry per kernel: its launches on the engine run and the
    numbers of its representative main-path case."""
    rep = {
        "dequant_gemv": dict(M=8, linear="gate_up_proj"),
        "dequant_gemm": dict(M=128, linear="gate_up_proj"),
        "decode_attention": dict(Hkv=32, hd=128),
        "prefill_attention": dict(Sq=256, S=2048, Hkv=32),
        "paged_decode_attention": dict(B=8, Hkv=32, hd=128),
        "ragged_expert_matmul": dict(routing="prefill", linear="gate_up"),
    }
    out = []
    for name, meta in KERNELS.items():
        mine = [r for r in records if r["kernel"] == name]
        main = next(r for r in mine if "ms" in r and all(
            r.get(k) == v for k, v in rep[name].items()))
        out.append({"name": name, "route": "cuda", **meta,
                    "launches": int(counts.get(name, 0)),
                    "max_abs_err": max(r["max_abs_err"] for r in mine),
                    "ms": main["ms"], "plain_ms": main["plain_ms"],
                    "bound_ms": main["bound_ms"],
                    "bound_by": main["bound_by"],
                    "library_ms": main["library_ms"],
                    **{k: main[k] for k in ("matmul_only_ms", "b3_ms")
                       if k in main},
                    "case": {k: main[k] for k in main if k in (
                        "M", "K", "N", "B", "H", "Hkv", "hd", "S", "Sq",
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
        counts, slab_toks, slab_shared = phase_engine(params, cfg)
        # main-path launches: each path's run, counted from 0
        more = [phase_engine_paged(params, cfg, slab_toks, slab_shared),
                phase_prefix_burst(params, cfg)]
        del params
        gc.collect()
        torch.cuda.empty_cache()

        moe_params, moe_cfg = phase_model_moe()
        phase_reference_moe(moe_params, moe_cfg)
        more += [phase_engine_moe(moe_params, moe_cfg),
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
