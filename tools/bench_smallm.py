"""Time the small-M dequant body of the PyTorch/CUDA port on one NVIDIA
GPU: B1's decode GEMVs (std, mxu, fold, mxuflat, mxu8) and B6's decode
entry, and the streaming rate of the body's weight loads alone.

    python3 tools/bench_smallm.py [--parent DIR]

Prints one JSON object a line:
- the card (``nvidia-smi`` name and power limit);
- B1 std (canonical sym_int4) and mxu (int4 layout) at M 1, 8, 16 and 32
  on the five Llama-2-7B linears, each the median of 10 cold-L2 launches
  (``chip_smoke.Timer``) beside its byte bound; on gate_up at the same M,
  mxu8 over the int4 layout and sym_int8, fold over the canonical
  sym_int4, nf4 and sym_int8, and mxuflat over the int4 layout;
- gate_up at M 8 at each K split from 1 to 8 (the wrapper picks one),
  std, mxu and mxu8;
- B6 on an 8-slot top-2 decode routing at Mixtral-8x7B's expert shapes,
  with the bound on a tile's real rows that the MoE layer passes
  (``min(N * k, 128)`` = 16) and with ``N`` = 8 (top-k experts are
  distinct, so no expert holds more than N rows), over sym_int4 stacks and
  (at 16) dense bf16 ones;
- the probe (``tools/smallm_probe.cu``): the body's loads over gate_up's
  codes, and over eight times as many, with no arithmetic, at each split.

With ``--parent DIR`` (a checkout of another commit) the B1 and B6 rows
run again from DIR's package, in turns: DIR, this tree, this tree, DIR.
Then the registers and spill bytes of the variants library's small-M
kernels (``nvcc -Xptxas -v``). Needs a GPU; exits 1 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LINEAR_MS = (1, 8, 16, 32)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _registers() -> None:
    """Registers and spill bytes of the variants library's small-M kernels
    (``nvcc -Xptxas -v``)."""
    import contextlib
    import io
    import re

    from bigdl_tpu_torch import _native

    flags = _native.NVCC_FLAGS
    _native.NVCC_FLAGS = flags + ["-Xptxas", "-v"]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            _native.build_all(("dequant_variants",))
    finally:
        _native.NVCC_FLAGS = flags
    names = {(0, 1, 0): "fold sym_int4", (2, 1, 0): "fold codebook",
             (3, 1, 0): "fold sym_int8", (5, 1, 0): "mxu",
             (5, 0, 0): "mxuflat", (5, 0, 1): "mxu8 int4",
             (3, 0, 1): "mxu8 sym_int8"}
    for part in buf.getvalue().split("Compiling entry function")[1:]:
        m = re.search(r"smallm_gemv_kernelILi(\d)ELi(\d)ELi(\d)ELb([01])"
                      r"ELb([01])E", part)
        used = re.search(r"Used (\d+) registers", part)
        if not (m and used):
            continue
        nt, cw, kind, fold, q8 = map(int, m.groups())
        spills = [int(v) for v in re.findall(
            r"(\d+) bytes spill (?:stores|loads)", part)]
        emit({"body": names.get((kind, fold, q8), f"kind {kind}"), "NT": nt,
              "CW": cw, "registers": int(used.group(1)),
              "spill_bytes": spills})


def _times(root: str, tag: str, sweep: bool) -> None:
    """B1 and B6 timings from the package under `root`."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from bigdl_tpu_torch import _native
    from bigdl_tpu_torch.ops.cuda import dequant_matmul as dm
    from bigdl_tpu_torch.ops.cuda import moe_dispatch as cmoe
    from bigdl_tpu_torch.ops.moe_dispatch import ragged_routing
    from bigdl_tpu_torch.ops.quant import quantize, to_mxu_layout

    # (a tree whose mxu8 body has a library of its own builds it too)
    _native.build_all([n for n in ("dequant_gemv", "dequant_variants",
                                   "dequant_mxu8", "moe_dispatch")
                       if n in _native.SOURCES])
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    timer = cs.Timer("cuda")

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=dev) * scale

    def row(kernel, lname, ww, m, fn, **extra):
        k, n = ww.shape
        x = randn(m, k).to(torch.bfloat16)
        emit({"tree": tag, "kernel": kernel, "linear": lname, **extra,
              "M": m, "ms": timer.ms(lambda: fn(x, ww)),
              "bound_ms": cs.bound_ms(m * k * 2 + ww.nbytes + m * n * 2,
                                      2.0 * m * k * n)[0]})

    def gemv(body):
        return lambda x, ww: dm.dequant_gemv(x, ww, body)

    k, n = cs.LLAMA2_7B_LINEARS["gate_up_proj"]
    for qtype in ("sym_int4", "nf4", "sym_int8"):
        w = quantize(randn(k, n, scale=0.02), qtype)
        for m in LINEAR_MS:
            row("B1 fold", "gate_up_proj", w, m, gemv("fold"), qtype=qtype)
        del w
    for lname, (k, n) in cs.LLAMA2_7B_LINEARS.items():
        w = quantize(randn(k, n, scale=0.02), "sym_int4")
        wm = to_mxu_layout(w)
        for m in LINEAR_MS:
            x = randn(m, k).to(torch.bfloat16)
            for body, ww in (("std", w), ("mxu", wm)):
                emit({"tree": tag, "kernel": f"B1 {body}", "linear": lname,
                      "M": m, "ms": timer.ms(
                          lambda: dm.dequant_gemv(x, ww, body)),
                      "bound_ms": cs.bound_ms(
                          m * k * 2 + ww.nbytes + m * n * 2,
                          2.0 * m * k * n)[0]})
        if sweep and lname == "gate_up_proj":
            x = randn(8, k).to(torch.bfloat16)
            chunks = -(-k // 64)
            auto = dm._split_k
            for body, ww in (("std", w), ("mxu", wm), ("mxu8", wm)):
                for split in range(1, 9):
                    per = -(-chunks // split)
                    dm._split_k = lambda *a, per=per, **kw: (
                        -(-chunks // per), per)
                    try:
                        ms = timer.ms(lambda: dm.dequant_gemv(x, ww, body))
                    finally:
                        dm._split_k = auto
                    emit({"tree": tag, "kernel": f"B1 {body}",
                          "linear": lname, "M": 8, "split": split,
                          "ms": ms})
        if lname == "gate_up_proj":
            w8 = quantize(randn(k, n, scale=0.02), "sym_int8")
            for ww in (wm, w8):
                for m in LINEAR_MS:
                    row("B1 mxu8", lname, ww, m, gemv("mxu8"),
                        qtype=ww.qtype, layout=ww.layout)
            del w8
            for m in LINEAR_MS:
                row("B1 mxuflat", lname, wm, m, gemv("mxuflat"))
        del w, wm
    rows_kw = "max_tile_rows" in cmoe.ragged_expert_matmul.__code__.co_varnames
    for lname, (k, n) in cs.MIXTRAL_EXPERT_LINEARS.items():
        w = cs._stack_q(randn, 8, k, n, "sym_int4")
        r = ragged_routing(cs._decode_routing(gen, dev), 8)
        x = torch.zeros((r.np_, k), dtype=torch.bfloat16, device=dev)
        x[r.dest] = randn(len(r.dest), k).to(torch.bfloat16)
        used = len({e for e, rows in zip(r.tile_expert.tolist(),
                                          r.tile_rows.tolist()) if rows})
        bound = cs.bound_ms(16 * k * 2 + r.np_ * n * 2 + used * w.nbytes // 8,
                            2.0 * 16 * k * n)[0]
        for rows in ((16, 8) if rows_kw else (None,)):
            kw = {"max_tile_rows": rows} if rows else {}
            emit({"tree": tag, "kernel": "B6 decode", "linear": lname,
                  "max_tile_rows": rows,
                  "ms": timer.ms(lambda: cmoe.ragged_expert_matmul(
                      x, w, r.tile_expert, r.tile_rows, **kw)),
                  "bound_ms": bound})
        del w
        # the same routing over a dense bf16 stack (a bf16 Mixtral load)
        wd = randn(8, k, n, scale=0.02).to(torch.bfloat16)
        kw = {"max_tile_rows": 16} if rows_kw else {}
        emit({"tree": tag, "kernel": "B6 dense decode", "linear": lname,
              "max_tile_rows": kw.get("max_tile_rows"),
              "entry": (cmoe.ragged_entry(wd, 16) if rows_kw else "tiles"),
              "ms": timer.ms(lambda: cmoe.ragged_expert_matmul(
                  x, wd, r.tile_expert, r.tile_rows, **kw)),
              "bound_ms": cs.bound_ms(
                  16 * k * 2 + r.np_ * n * 2 + used * k * n * 2,
                  2.0 * 16 * k * n)[0]})
        del wd


def _probe() -> None:
    import torch

    import chip_smoke as cs
    from bigdl_tpu_torch import _native

    out_dir = os.path.join(_native.BUILD_ROOT, "probe")
    os.makedirs(out_dir, exist_ok=True)
    lib_path = os.path.join(out_dir, "libsmallm_probe.so")
    subprocess.run([_native.find_nvcc(), *_native.NVCC_FLAGS, "-o", lib_path,
                    os.path.join(ROOT, "tools", "smallm_probe.cu")],
                   check=True)
    lib = ctypes.CDLL(lib_path)
    lib.smallm_probe.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_int] * 4
                                 + [ctypes.c_void_p])
    timer = cs.Timer("cuda")
    for k, n in ((4096, 22016), (4096, 8 * 14336)):
        data = torch.randint(0, 255, (k // 2, n), dtype=torch.uint8,
                             device="cuda")
        chunks = k // 64
        out = torch.empty(n // 128 * chunks * 128, dtype=torch.int32,
                          device="cuda")
        stream = torch.cuda.current_stream().cuda_stream
        for split in range(1, 9):
            per = -(-chunks // split)

            def run():
                err = lib.smallm_probe(data.data_ptr(), out.data_ptr(), k, n,
                                       -(-chunks // per), per, stream)
                if err:
                    raise RuntimeError(f"smallm_probe: cudaError_t {err}")
            ms = timer.ms(run)
            emit({"kernel": "probe", "K": k, "N": n, "bytes": data.numel(),
                  "split": split, "ms": ms,
                  "TB_per_s": data.numel() / ms / 1e9})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="checkout of another commit, timed in "
                    "turns with this tree")
    ap.add_argument("--times-only", metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--tag", default="this tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_smallm: no CUDA device", file=sys.stderr)
        return 1
    if args.times_only:
        _times(os.path.abspath(args.times_only), args.tag, sweep=False)
        return 0
    os.chdir(ROOT)
    sys.path.insert(0, ROOT)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    emit({"card": smi.stdout.strip(), "torch": torch.__version__})
    if args.parent:
        parent = os.path.abspath(args.parent)
        for root, tag in ((parent, "parent"), (ROOT, "this tree"),
                          (ROOT, "this tree"), (parent, "parent")):
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--times-only", root, "--tag", tag], check=True)
    _registers()
    _times(ROOT, "this tree", sweep=True)
    _probe()
    return 0


if __name__ == "__main__":
    sys.exit(main())
