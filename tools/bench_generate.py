"""Time the Quick start's ``generate`` on one NVIDIA GPU.

    python3 tools/bench_generate.py [--layers N] [--reps R] [--phases]
                                    [--qtype Q] [--parent DIR]

Builds Llama-2-7B at full width and N layers (default 32; random weights
from seed 0 at qtype Q, default sym_int4, or dense at bf16; merged,
prepacked on the card) as a ``TpuCausalLM`` and runs ``generate`` at bs 1,
64 new tokens, over prompts of 100, 1000 and 16 tokens in turns, R times
(default 3): TTFT, and the mean, median, 10th and 90th percentile of the
next-token ms. Then a torch.profiler
window of 6 decode steps after the 100-token and after the 1000-token
prompt: wall ms a step, and device ms and records a step by kernel group.
With ``--phases`` it first runs ``chip_smoke.py``'s ``hf_load``,
``generate`` (at N layers) and ``hf_load_moe`` phases alone. With
``--parent DIR`` (a checkout of another commit) only the timed runs and
windows run, from DIR's package and this tree's in turns: DIR, this tree,
this tree, DIR. Every line is JSON, also appended to the file ``OUT``
names. Needs a GPU; exits 1 without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out", "bench_generate.jsonl")
PROMPTS = (100, 1000, 16)
NEW = 64
WINDOW = 6


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def _window(cs, model, ids):
    """WINDOW decode steps of a stream under torch.profiler, after 12
    warm steps: wall ms a step, and device ms and launches a step by
    kernel group (the smoke's ``_device_ms_by_group``)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.generation import GenerationConfig

    gen = model.generator.stream(ids, GenerationConfig(
        max_new_tokens=12 + WINDOW + 1))
    for _ in range(12):
        next(gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(WINDOW):
            next(gen)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for _ in gen:
        pass
    groups, launches, _ = cs._device_ms_by_group(prof, WINDOW)
    return {"wall_ms_per_step": 1e3 * wall / WINDOW,
            "device_ms_per_step": sum(groups.values()),
            "device_ms_by_group": groups,
            "device_records_per_step": launches}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--phases", action="store_true")
    ap.add_argument("--qtype", default="sym_int4")
    ap.add_argument("--parent", help="checkout of another commit, timed in "
                    "turns with this tree")
    ap.add_argument("--times-only", metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--tag", default="this tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.parent:
        parent = os.path.abspath(args.parent)
        for root, tag in ((parent, "parent"), (ROOT, "this tree"),
                          (ROOT, "this tree"), (parent, "parent")):
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--times-only", root, "--tag", tag,
                            "--qtype", args.qtype, "--layers",
                            str(args.layers), "--reps", str(args.reps)],
                           check=True)
        return 0
    sys.path.insert(0, os.path.abspath(args.times_only or ROOT))
    import torch

    import chip_smoke as cs
    from bigdl_tpu_torch.generation import GenerationStats
    from bigdl_tpu_torch.models import llama
    from bigdl_tpu_torch.transformers.model import TpuCausalLM
    from bigdl_tpu_torch.utils.testing import (LLAMA2_7B, MIXTRAL_8X7B,
                                               random_llama_params)

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    cs.emit = emit
    try:
        card = cs.phase_device()
        cs.phase_build()
        cfg = dataclasses.replace(LLAMA2_7B, num_hidden_layers=args.layers)
        params = llama.merge_projections(random_llama_params(
            cfg, args.qtype, seed=0, device="cuda"), cfg)
        if args.phases and not args.times_only:
            cs.phase_hf_load(LLAMA2_7B)
            cs.phase_generate(params, cfg, card)
        model = TpuCausalLM(params, cfg, llama, cs._hf_config(cfg),
                            args.qtype, max_seq=2048)
        rng = np.random.default_rng(9)
        prompts = {n: rng.integers(3, cfg.vocab_size, (1, n))
                   for n in PROMPTS}
        model.generate(prompts[16], max_new_tokens=8)          # warm-up
        for rep in range(args.reps):
            for n in PROMPTS:
                stats = GenerationStats()
                t0 = time.perf_counter()
                model.generate(prompts[n], max_new_tokens=NEW, stats=stats)
                wall = time.perf_counter() - t0
                ms = 1e3 * np.array(stats.rest_token_s)
                emit({"tree": args.tag, "qtype": args.qtype, "rep": rep,
                      "prompt": n, "layers": args.layers,
                      "ttft_s": stats.first_token_s, "wall_s": wall,
                      "next_token_ms_mean": float(ms.mean()),
                      "median": float(np.median(ms)),
                      "p10": float(np.percentile(ms, 10)),
                      "p90": float(np.percentile(ms, 90))})
        if args.reps:
            for n in PROMPTS[:2]:
                emit({"tree": args.tag, "qtype": args.qtype,
                      "window_after_prompt": n,
                      **_window(cs, model, prompts[n])})
        del model, params
        if args.phases and not args.times_only:
            cs.phase_hf_load_moe(MIXTRAL_8X7B)
        emit({"card": card, "torch": torch.__version__})
    except cs.SmokeFailure as e:
        print(f"bench_generate FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
