"""Time the decode attention body of the PyTorch/CUDA port
(``bigdl_tpu_torch/csrc/decode_attention.cuh``) on one NVIDIA GPU: B3
(slab cache) and B5 (paged arena) at every KV storage kind.

    python3 tools/bench_attention.py [--parent DIR]

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
- with ``--probe``, this tree's probe builds (``-DBIGDL_DA_PROBE=1``: the
  tiles staged, no arithmetic; ``=2``: the arithmetic, nothing staged;
  ``=3``: no tile, the launch and the merges alone), swept too: their out
  is not the attention, only their time is read.

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
# the body's probe builds (BIGDL_DA_PROBE in csrc/decode_attention.cuh)
PROBES = (("BIGDL_DA_PROBE=1",), ("BIGDL_DA_PROBE=2",), ("BIGDL_DA_PROBE=3",))


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def _positions(seed: int, idle_last: bool):
    import numpy as np

    pos = [int(p) for p in np.random.default_rng(seed).integers(1, S, B)]
    pos[0] = S - 1
    if idle_last:
        pos[-1] = S + 37
    return pos


def _times(root: str, tag: str, sweep: bool, defines=()) -> None:
    """B3 and B5 timings from the package under `root` (built with the
    given -D defines)."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from bigdl_tpu_torch import _native
    from bigdl_tpu_torch.ops.cuda import decode_attention as da
    from bigdl_tpu_torch.ops.cuda import paged_decode_attention as pda
    from bigdl_tpu_torch.ops.paged import _gather_dense

    if defines:
        _native.NVCC_FLAGS = _native.NVCC_FLAGS + [f"-D{d}" for d in defines]
        tag = f"{tag} {' '.join(defines)}"
    probe = bool(defines)
    dev = torch.device("cuda")
    timer = cs.Timer(dev)
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
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("bench_attention: no CUDA device", file=sys.stderr)
        return 1
    if args.times_only:
        _times(os.path.abspath(args.times_only), args.tag, sweep=args.sweep,
               defines=args.define)
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
    for root, tag in runs:
        subprocess.run([sys.executable, me, "--times-only", root, "--tag",
                        tag], check=True)
    subprocess.run([sys.executable, me, "--times-only", ROOT, "--tag",
                    "this tree", "--sweep"], check=True)
    if args.probe:
        for defines in PROBES:
            cmd = [sys.executable, me, "--times-only", ROOT, "--tag",
                   "this tree", "--sweep"]
            for d in defines:
                cmd += ["--define", d]
            subprocess.run(cmd, check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
