"""Time the attention kernels of the PyTorch/CUDA port on one NVIDIA GPU:
the decode body (``bigdl_tpu_torch/csrc/decode_attention.cuh``) as B3 (slab
cache) and B5 (paged arena), and the prefill body B4
(``bigdl_tpu_torch/csrc/prefill_attention.cu``), at every KV storage kind.

    python3 tools/bench_attention.py [--parent DIR] [--probe] [--trace]
                                     [--only b3|b4]

Prints one JSON object a line:
- the card (``nvidia-smi`` name and power limit);
- B3 and B5 at bf16, fp8_e5m2, int8 and int4, at Llama-2-7B's heads (32
  query heads on 32 kv heads) and at Mixtral-8x7B's GQA (32 on 8): B 8,
  hd 128, S 2048 (B5: 128-row pages, 16 a slot, over a random page
  permutation, the last slot idle), per-slot positions drawn as
  ``chip_smoke.py`` draws them. Each row is the median of 10 cold-L2
  launches (``chip_smoke.Timer``) beside its byte bound and, for this
  tree, its largest difference from the plain version;
- this tree only: each case again at spans around the planner's choice
  (``plan_spans``: half, the plan, double, and the extremes a slot's keys
  allow), with the plan marked;
- B4 at the engine's prefill calls (B 1, hd 128; a prompt's private cache
  is its bucket, S rows, for every chunk: Sq 128 / S 128 / pos 0; the
  first 256-token chunk of a 256-, 1024- and 2048-row cache, pos 0; the
  last chunk of a 1024-row cache, pos 768; the second of a 2048-row cache,
  pos 256) at every kind, Llama's and Mixtral's heads, the position on the
  card as the engine passes it; this tree only: each case again at blocks
  a query tile around ``plan_prefill``'s choice (1, 2, the plan, double);
- with ``--probe``, this tree's probe builds (``-DBIGDL_DA_PROBE=1`` /
  ``-DBIGDL_PFA_PROBE=1``: the tiles staged, no arithmetic; ``=2``: the
  arithmetic, nothing staged; ``=3``: no tile, the launch, q and the
  merges alone), swept too: their out is not the attention, only their
  time is read.

``--only b3`` times B3 and B5 alone, ``--only b4`` B4 alone. ``--trace``
builds B4 with ``-DBIGDL_PFA_TRACE`` and prints, for one cold-L2 launch
of bf16 at Llama's heads (Sq 256 / S 2048 / pos 256 and Sq 128 / S 128 /
pos 0, one block a query tile and two) and of its probe build without
tiles, the spread over blocks of each phase's time from the kernel's own
``%globaltimer`` stamps (q, the tile loop, the merge) beside the events'.

With ``--parent DIR`` (a checkout of another commit) every case runs
again from DIR's package, in turns: DIR, this tree, this tree, DIR. Each
tree runs in a process of its own (its own kernels). Needs a GPU; exits
1 without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KINDS = ("bf16", "fp8_e5m2", "int8", "int4")
GROUPS = ((32, 32), (32, 8))          # (H, Hkv): Llama-2-7B, Mixtral-8x7B
B, HD, S, PS, NP = 8, 128, 2048, 128, 16
# the bodies' probe builds (BIGDL_DA_PROBE in csrc/decode_attention.cuh,
# BIGDL_PFA_PROBE in csrc/prefill_attention.cu)
PROBES = {"b3": ("BIGDL_DA_PROBE=1", "BIGDL_DA_PROBE=2", "BIGDL_DA_PROBE=3"),
          "b4": ("BIGDL_PFA_PROBE=1", "BIGDL_PFA_PROBE=2",
                 "BIGDL_PFA_PROBE=3")}
# B4: (Sq, S, pos) of the engine's prefill calls (one slot, hd 128; S the
# prompt's bucket)
PREFILL = ((128, 128, 0), (256, 256, 0), (256, 1024, 0), (256, 1024, 768),
           (256, 2048, 0), (256, 2048, 256))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _positions(seed: int, idle_last: bool):
    import numpy as np

    pos = [int(p) for p in np.random.default_rng(seed).integers(1, S, B)]
    pos[0] = S - 1
    if idle_last:
        pos[-1] = S + 37
    return pos


def _times(root: str, tag: str, sweep: bool, defines=(),
           only=None) -> None:
    """B3/B5 and B4 timings from the package under `root` (built with the
    given -D defines)."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from bigdl_tpu_torch import _native

    if defines:
        _native.NVCC_FLAGS = _native.NVCC_FLAGS + [f"-D{d}" for d in defines]
        tag = f"{tag} {' '.join(defines)}"
    dev = torch.device("cuda")
    if "BIGDL_PFA_TRACE" in defines:
        _prefill_trace(cs, dev, tag)
        return
    timer = cs.Timer(dev)
    if only != "b4":
        _decode_times(cs, timer, dev, tag, sweep, bool(defines))
    if only != "b3":
        _prefill_times(cs, timer, dev, tag, sweep, bool(defines))


def _prefill_times(cs, timer, dev, tag: str, sweep: bool,
                   probe: bool) -> None:
    """B4 at the engine's prefill shapes, every kind, both head groups."""
    import torch

    from bigdl_tpu_torch.ops.cuda import prefill_attention as pa

    scale = HD ** -0.5
    for kind in KINDS:
        for h, hkv in GROUPS:
            for sq, s, p in PREFILL:
                gen = torch.Generator(device=dev)
                gen.manual_seed(1000 + 100 * KINDS.index(kind) + hkv + sq)

                def randn(*shape):
                    return torch.randn(shape, generator=gen, device=dev)

                q = randn(1, sq, h, HD).to(torch.bfloat16)
                kc, ks = cs._kv_codes(randn(1, s, hkv, HD), kind)
                vc, vs = cs._kv_codes(randn(1, s, hkv, HD), kind)
                # the engine's position: a 0-d int32 tensor on the card
                pos = torch.tensor(p, dtype=torch.int32, device=dev)
                b_ms, b_by = cs._attn_bounds(q, kc, [p], sq, kind)
                rec = {"kernel": "B4", "tree": tag, "kv": kind, "H": h,
                       "Hkv": hkv, "Sq": sq, "S": s, "pos": p,
                       "ms": timer.ms(lambda: pa.prefill_attention(
                           q, kc, vc, pos, scale, ks, vs)),
                       "bound_ms": b_ms, "bound_by": b_by}
                if sweep and not probe:
                    got = pa.prefill_attention(q, kc, vc, pos, scale, ks, vs)
                    want = pa.plain_attention(q, kc, vc, pos, scale, ks, vs)
                    rec["max_abs_err"] = cs.max_err(got, want)
                if sweep:
                    plan = pa.plan_prefill(1, h, hkv, sq, s, None,
                                           torch.cuda.get_device_properties(
                                               dev).multi_processor_count)
                    rec["plan"] = plan
                    p1 = pos.reshape(1)
                    rec["nspan"] = {
                        n: timer.ms(lambda: pa._launch(q, kc, vc, p1, scale,
                                                       ks, vs, nspan=n))
                        for n in sorted({1, 2, plan[2], 2 * plan[2]})
                        if n <= pa.MAX_SPANS}
                emit(rec)
                del kc, vc, ks, vs
    torch.cuda.empty_cache()


def _prefill_trace(cs, dev, tag: str) -> None:
    """Per-block phase times of B4 from a -DBIGDL_PFA_TRACE build (its
    stamps: csrc/prefill_attention.cu)."""
    import ctypes

    import numpy as np
    import torch

    from bigdl_tpu_torch import _native
    from bigdl_tpu_torch.ops.cuda import prefill_attention as pa

    lib = ctypes.CDLL(_native.build_all(("prefill_attention",))[
        "prefill_attention"])
    stamps = np.zeros((4096, 16), np.uint64)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def spread(x):
        x = x[x >= 0]
        return [round(float(v), 2) for v in (x.min(), np.median(x),
                                              x.max())] if len(x) else None

    for sq, s, p in ((256, 2048, 256), (128, 128, 0)):
        gen = torch.Generator(device=dev)
        gen.manual_seed(7)
        q = torch.randn((1, sq, 32, HD), generator=gen, device=dev).to(
            torch.bfloat16)
        kc, _ = cs._kv_codes(torch.randn((1, s, 32, HD), generator=gen,
                                         device=dev), "bf16")
        vc, _ = cs._kv_codes(torch.randn((1, s, 32, HD), generator=gen,
                                         device=dev), "bf16")
        pos = torch.tensor([p], dtype=torch.int32, device=dev)
        for nspan in (1, 2):
            pa._launch(q, kc, vc, pos, HD ** -0.5, None, None, nspan=nspan)
            torch.cuda.synchronize()
            if lib.bigdl_pfa_trace_clear() != 0:
                raise RuntimeError("bigdl_pfa_trace_clear failed")
            flush.zero_()
            torch.cuda._sleep(1_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            pa._launch(q, kc, vc, pos, HD ** -0.5, None, None, nspan=nspan)
            end.record()
            end.synchronize()
            if lib.bigdl_pfa_trace(stamps.ctypes.data) != 0:
                raise RuntimeError("bigdl_pfa_trace failed")
            nqt = pa.plan_prefill(1, 32, 32, sq, s, p, 132)[1]
            t = stamps[:nqt * nspan * 32].astype(np.int64)
            t0 = t[:, 0].min()

            def phase(i, j):
                ok = (t[:, i] > 0) & (t[:, j] > 0)
                return spread(np.where(ok, (t[:, j] - t[:, i]) / 1e3, -1.0))

            ends = np.where(t[:, 5] > 0, (t[:, 5] - t0) / 1e3, -1.0)
            emit({"kernel": "B4 trace", "tree": tag, "kv": "bf16", "H": 32,
                  "Hkv": 32, "Sq": sq, "S": s, "pos": p, "nspan": nspan,
                  "event_us": start.elapsed_time(end) * 1e3,
                  "q_us": phase(0, 1), "loop_us": phase(1, 2),
                  "partial_us": phase(2, 3), "cluster_barrier_us":
                  phase(3, 4), "merge_us": phase(4, 5),
                  "kernel_end_us": spread(ends),
                  "note": "min / median / max over blocks; kernel_end_us "
                          "from the first block's start"})
        del kc, vc


def _decode_times(cs, timer, dev, tag: str, sweep: bool,
                  probe: bool) -> None:
    """B3 and B5 at B 8, S 2048, every kind, both head groups."""
    import torch

    from bigdl_tpu_torch.ops.cuda import decode_attention as da
    from bigdl_tpu_torch.ops.cuda import paged_decode_attention as pda
    from bigdl_tpu_torch.ops.paged import _gather_dense

    scale = HD ** -0.5
    for kind in KINDS:
        for h, hkv in GROUPS:
            gen = torch.Generator(device=dev)
            gen.manual_seed(100 * KINDS.index(kind) + hkv)

            def randn(*shape):
                return torch.randn(shape, generator=gen, device=dev)

            q = randn(B, 1, h, HD).to(torch.bfloat16)
            # B3: a slab cache
            kc, ks = cs._kv_codes(randn(B, S, hkv, HD), kind)
            vc, vs = cs._kv_codes(randn(B, S, hkv, HD), kind)
            pos_list = _positions(len(kind) + hkv, False)
            pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
            b_ms, _ = cs._attn_bounds(q, kc, pos_list, 1, kind)
            rec = {"kernel": "B3", "tree": tag, "kv": kind, "H": h,
                   "Hkv": hkv, "ms": timer.ms(lambda: da.decode_attention(
                       q, kc, vc, pos, scale, ks, vs)), "bound_ms": b_ms}
            if sweep and not probe:
                got = da.decode_attention(q, kc, vc, pos, scale, ks, vs)
                want = da.plain_attention(q, kc, vc, pos, scale, ks, vs)
                rec["max_abs_err"] = cs.max_err(got, want)
            if sweep:
                rec["plan"] = da.decode_plan(B, hkv, S, da.KV_KINDS[
                    kc.dtype][1], HD, h // hkv, dev)
                rec["spans"] = {
                    span: timer.ms(lambda: da._launch(q, kc, vc, pos, scale,
                                                      ks, vs, span=span))
                    for span in _sweep(rec["plan"][0], S)}
            emit(rec)
            del kc, vc, ks, vs
            # B5: the same kind in a paged arena, the last slot idle
            p_ = B * NP + 1
            ak, aks = cs._kv_codes(randn(p_, PS, hkv, HD), kind)
            av, avs = cs._kv_codes(randn(p_, PS, hkv, HD), kind)
            perm = torch.randperm(p_ - 1, generator=gen, device=dev) + 1
            bt = perm[:B * NP].reshape(B, NP).to(torch.int32).contiguous()
            bt[-1] = 0
            pos_list = _positions(len(kind) + hkv + 1, True)
            pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
            vis = [min(p + 1, NP * PS) for p in pos_list]
            row = cs._kv_row_bytes(HD, kind)
            b_ms, _ = cs.bound_ms(2 * q.numel() * 2 + sum(vis) * hkv * row
                                  * 2 + bt.numel() * 4 + B * 4, 0.0)
            rec = {"kernel": "B5", "tree": tag, "kv": kind, "H": h,
                   "Hkv": hkv, "ms": timer.ms(
                       lambda: pda.paged_decode_attention(
                           q, ak, av, bt, pos, scale, aks, avs)),
                   "bound_ms": b_ms}

            def dense(t):
                return None if t is None else _gather_dense(t, bt).contiguous()

            kd, vd, ksd, vsd = dense(ak), dense(av), dense(aks), dense(avs)
            rec["b3_same_rows_ms"] = timer.ms(
                lambda: da.decode_attention(q, kd, vd, pos, scale, ksd, vsd))
            if sweep and not probe:
                got = pda.paged_decode_attention(q, ak, av, bt, pos, scale,
                                                 aks, avs)
                b3 = da.decode_attention(q, kd, vd, pos, scale, ksd, vsd)
                rec["equal_to_b3"] = bool(torch.equal(got, b3))
            if sweep:
                rec["plan"] = da.decode_plan(B, hkv, NP * PS, da.KV_KINDS[
                    ak.dtype][1], HD, h // hkv, dev)
                rec["spans"] = {
                    span: timer.ms(lambda: pda._launch(
                        q, ak, av, bt, pos, scale, aks, avs, span=span))
                    for span in _sweep(rec["plan"][0], NP * PS)}
            emit(rec)
            del ak, av, aks, avs, kd, vd, ksd, vsd
            torch.cuda.empty_cache()


def _sweep(plan: int, s: int):
    """Spans around the plan: half and double it, and the extremes (four
    tiles a block, all keys in one block), multiples of 16 up to s."""
    cands = {plan, plan // 2, plan * 2, 64, s}
    return sorted(c for c in cands if 16 <= c <= s and c % 16 == 0)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="checkout of another commit, timed in "
                    "turns with this tree")
    ap.add_argument("--times-only", metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--tag", default="this tree", help=argparse.SUPPRESS)
    ap.add_argument("--probe", action="store_true",
                    help="also time this tree's probe builds")
    ap.add_argument("--sweep", action="store_true", help=argparse.SUPPRESS)
    ap.add_argument("--define", action="append", default=[],
                    help=argparse.SUPPRESS)
    ap.add_argument("--only", choices=("b3", "b4"),
                    help="time one body only")
    ap.add_argument("--trace", action="store_true",
                    help="B4's per-block phase times from a trace build")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_attention: no CUDA device", file=sys.stderr)
        return 1
    if args.times_only:
        _times(os.path.abspath(args.times_only), args.tag, sweep=args.sweep,
               defines=args.define, only=args.only)
        return 0
    os.chdir(ROOT)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    emit({"card": smi.stdout.strip(), "torch": torch.__version__})
    me = os.path.abspath(__file__)
    runs = [(ROOT, "this tree")]
    if args.parent:
        parent = os.path.abspath(args.parent)
        runs = [(parent, "parent"), (ROOT, "this tree"), (ROOT, "this tree"),
                (parent, "parent")]
    only = ["--only", args.only] if args.only else []
    for root, tag in runs:
        subprocess.run([sys.executable, me, "--times-only", root, "--tag",
                        tag, *only], check=True)
    subprocess.run([sys.executable, me, "--times-only", ROOT, "--tag",
                    "this tree", "--sweep", *only], check=True)
    if args.trace:
        for define in ("BIGDL_PFA_TRACE", "BIGDL_PFA_TRACE BIGDL_PFA_PROBE=3"):
            cmd = [sys.executable, me, "--times-only", ROOT, "--tag",
                   "this tree"]
            for d in define.split():
                cmd += ["--define", d]
            subprocess.run(cmd, check=True)
    if args.probe:
        for body in ("b3", "b4"):
            if args.only and args.only != body:
                continue
            for define in PROBES[body]:
                subprocess.run([sys.executable, me, "--times-only", ROOT,
                                "--tag", "this tree", "--sweep", "--only",
                                body, "--define", define], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
