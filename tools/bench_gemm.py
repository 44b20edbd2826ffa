"""Time the Hopper dequant GEMM body of the PyTorch/CUDA port
(``bigdl_tpu_torch/csrc/dequant_wgmma.cuh``) on one NVIDIA GPU: B2's std
and i4 prefill GEMMs and B6's prefill tiles, over quantized and dense bf16
expert stacks.

    python3 tools/bench_gemm.py [--parent DIR]

Prints one JSON object a line:
- the card (``nvidia-smi`` name and power limit);
- B2 std (canonical sym_int4) and i4 (int4 layout) at M 64 and 128 on the
  five Llama-2-7B linears, each the median of 10 cold-L2 launches
  (``chip_smoke.Timer``) beside its bound and the time a dequantized
  weight takes (ps);
- B6 on a 256-token top-2 prefill chunk of Mixtral-8x7B (the smoke's
  skewed routing, and a uniform one: 64 rows an expert) at both expert
  shapes, with the bound on a tile's real rows the MoE layer passes (128),
  over sym_int4 stacks and dense bf16 ones (``torch._grouped_mm`` on the
  dense stack timed beside it);
- this tree only: B2 std at M 64 and 128 at each K split from 1 to 8 on
  every linear (beside the split the wrapper picks), B6 at splits 1 to 3,
  the host time of the tensor-map encode a launch does, and B2 / B6 on
  gate_up in the probe builds ``-DBIGDL_WGMMA_PROBE=1`` (the ring, the
  barriers and the code reads, neither dequantizing nor multiplying) and
  ``=2`` (the same with the wgmma, on the raw code words), swept too:
  their y is not the product, only their time is read.

With ``--parent DIR`` (a checkout of another commit) the B2 and B6 rows
run again from DIR's package, in turns: DIR, this tree, this tree, DIR.
Needs a GPU; exits 1 without one.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEMM_MS = (64, 128)
# the body's probe builds (BIGDL_WGMMA_PROBE in csrc/dequant_wgmma.cuh)
VARIANTS = (("BIGDL_WGMMA_PROBE=1",), ("BIGDL_WGMMA_PROBE=2",))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _uniform_routing(dev):
    """A 256-token prefill chunk, top-2 of 8 experts, 64 choices each."""
    import torch

    return torch.tensor([(i % 8, (i + 4) % 8) for i in range(256)],
                        dtype=torch.int64, device=dev)


def _times(root: str, tag: str, sweep: bool, defines=()) -> None:
    """B2 and B6 timings from the package under `root` (built with the
    given -D defines)."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from bigdl_tpu_torch import _native
    from bigdl_tpu_torch.ops.cuda import dequant_matmul as dm
    from bigdl_tpu_torch.ops.cuda import moe_dispatch as cmoe
    from bigdl_tpu_torch.ops.moe_dispatch import ragged_routing
    from bigdl_tpu_torch.ops.quant import quantize, to_mxu_layout

    if defines:
        _native.NVCC_FLAGS = _native.NVCC_FLAGS + [f"-D{d}" for d in defines]
        tag = f"{tag} {' '.join(defines)}"
    # a tree whose i4 body lives in the variants library builds it too
    libs = ["dequant_gemm", "moe_dispatch"]
    if "dequant_gemm_i4" in getattr(dm, "_VARIANT_BODY", {}):
        libs.append("dequant_variants")
    if defines:
        # the consumers' setmaxnreg takes the registers the producer
        # warpgroup frees from a 168-register block: a build ptxas gave
        # another count would wait for them forever, so it is not run
        _native.NVCC_FLAGS = _native.NVCC_FLAGS + ["-Xptxas", "-v"]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            _native.build_all(libs)
        counts = {int(m) for m in re.findall(
            r"wgmma_\w+kernel\S*'[^\n]*\n(?:[^\n]*\n)*?[^\n]*Used (\d+) "
            r"registers", buf.getvalue())}
        if counts != {168}:
            emit({"tree": tag, "skipped": f"registers {sorted(counts)}"})
            return
    _native.build_all(libs)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    timer = cs.Timer("cuda")

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    linears = cs.LLAMA2_7B_LINEARS
    if defines:
        linears = {"gate_up_proj": linears["gate_up_proj"]}
    for lname, (k, n) in linears.items():
        w = quantize(randn(k, n, scale=0.02), "sym_int4")
        wm = to_mxu_layout(w)
        for m in GEMM_MS:
            x = randn(m, k).to(torch.bfloat16)
            for body, ww in (("std", w), ("i4", wm)):
                ms = timer.ms(lambda: dm.dequant_gemm(x, ww, body))
                emit({"tree": tag, "kernel": f"B2 {body}", "linear": lname,
                      "M": m, "ms": ms, "ps_per_weight": ms * 1e9 / (k * n),
                      "bound_ms": cs.bound_ms(
                          m * k * 2 + ww.nbytes + m * n * 2,
                          2.0 * m * k * n)[0]})
        if sweep:
            chunks = -(-k // 64)
            auto = dm._split_k
            for m in GEMM_MS:
                x = randn(m, k).to(torch.bfloat16)
                for split in range(1, 9):
                    per = -(-chunks // split)
                    dm._split_k = lambda *a, per=per, **kw: (
                        -(-chunks // per), per)
                    try:
                        ms = timer.ms(lambda: dm.dequant_gemm(x, w, "std"))
                    finally:
                        dm._split_k = auto
                    emit({"tree": tag, "kernel": "B2 std", "linear": lname,
                          "M": m, "split": split, "ms": ms,
                          "auto_split": auto("dequant_gemm", m, n, w.kp, 0,
                                             1, dev)[0]})
        if sweep and lname == "gate_up_proj":
            x = randn(128, k).to(torch.bfloat16)
            enc = _native.kernel("dequant_gemm",
                                 "bigdl_dequant_gemm_encode_ns")
            for planes in (1, 0):
                ns = enc(x.data_ptr(), w.data.data_ptr(), w.scale.data_ptr(),
                         None, 128, k, n, 32, 0, planes, 2000)
                emit({"tree": tag, "kernel": "B2 tensor-map encode",
                      "linear": lname, "M": 128,
                      "maps": "x, codes, scales" if planes else "x",
                      "host_us_per_launch": ns / 1e3})
        del w, wm
    experts = cs.MIXTRAL_EXPERT_LINEARS
    if defines:
        experts = {"gate_up": experts["gate_up"]}
    for (lname, (k, n)), qtype in ((e, q) for e in experts.items()
                                   for q in ("sym_int4", "bf16")):
        dense = qtype == "bf16"
        w = (randn(8, k, n, scale=0.02).to(torch.bfloat16) if dense
             else cs._stack_q(randn, 8, k, n, qtype))
        wbytes = 8 * k * n * 2 if dense else w.nbytes
        kname = "B6 dense prefill" if dense else "B6 prefill"
        for rname, routing in (("skewed", cs._prefill_routing(dev)),
                               ("uniform", _uniform_routing(dev))):
            r = ragged_routing(routing, 8)
            x = torch.zeros((r.np_, k), dtype=torch.bfloat16, device=dev)
            x[r.dest] = randn(len(r.dest), k).to(torch.bfloat16)
            rows = r.tile_rows.tolist()
            used = len({e for e, c in zip(r.tile_expert.tolist(), rows)
                        if c})
            tiles = sum(1 for c in rows if c)
            nk = routing.numel()
            bound = cs.bound_ms(nk * k * 2 + r.np_ * n * 2
                                + used * wbytes // 8, 2.0 * nk * k * n)[0]
            ms = timer.ms(lambda: cmoe.ragged_expert_matmul(
                x, w, r.tile_expert, r.tile_rows, max_tile_rows=128))
            rec = {"tree": tag, "kernel": kname, "linear": lname,
                   "routing": rname, "tile_rows": rows, "ms": ms,
                   "ps_per_weight": ms * 1e9 / (tiles * k * n),
                   "bound_ms": bound}
            if dense and not defines:
                lib_name, lib = cs._grouped_library(x, r, 8)
                rec[lib_name.replace(" ", "_") + "_ms"] = timer.ms(
                    lambda: lib(w))
            emit(rec)
            if sweep and not dense:
                chunks = -(-k // 64)
                for split in range(1, 4):
                    per = -(-chunks // split)
                    sp = (-(-chunks // per), per)
                    ms = timer.ms(lambda: cmoe._launch(
                        x, w, r.tile_expert, r.tile_rows, split=sp,
                        max_tile_rows=128))
                    emit({"tree": tag, "kernel": "B6 prefill",
                          "linear": lname, "routing": rname, "split": split,
                          "ms": ms})
        del w


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="checkout of another commit, timed in "
                    "turns with this tree")
    ap.add_argument("--times-only", metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--tag", default="this tree", help=argparse.SUPPRESS)
    ap.add_argument("--define", action="append", default=[],
                    help=argparse.SUPPRESS)
    ap.add_argument("--sweep", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_gemm: no CUDA device", file=sys.stderr)
        return 1
    if args.times_only:
        _times(os.path.abspath(args.times_only), args.tag, sweep=args.sweep,
               defines=args.define)
        return 0
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    emit({"card": smi.stdout.strip(), "torch": torch.__version__})
    me = os.path.abspath(__file__)
    if args.parent:
        parent = os.path.abspath(args.parent)
        for root, tag in ((parent, "parent"), (ROOT, "this tree"),
                          (ROOT, "this tree"), (parent, "parent")):
            subprocess.run([sys.executable, me, "--times-only", root,
                            "--tag", tag], check=True)
    for defines in VARIANTS:
        cmd = [sys.executable, me, "--times-only", ROOT, "--tag",
               "this tree", "--sweep"]
        for d in defines:
            cmd += ["--define", d]
        subprocess.run(cmd, check=True)
    _times(ROOT, "this tree", sweep=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
