"""Repeat ``chip_smoke.py``'s ``decode_profile`` window on one NVIDIA GPU
and report, window by window, what torch.profiler recorded in it.

    python3 tools/profile_decode.py [--parent DIR] [--windows N]

The smoke's window: the engine phase's eight requests are admitted, then
four pure-decode steps run under torch.profiler, then the requests drain.
The smoke requires one B3-group kernel record for each B3/B5 call, and it
reports the kernel records a step. This tool builds the smoke's engines
(Llama-2-7B at full depth, sym_int4, slab cache at each KV storage kind;
Mixtral-8x7B, bf16 KV), runs each once to warm it, then runs N such
windows (default 6) and prints one JSON object a window:
- ``b3_calls``: the B3/B5 wrappers' launch counters over the window;
- ``b3_kernels``: the profiler's device records of the B3 group;
- ``device_records``: every device record (kernels, copies, sets), the
  number the smoke divides by the steps;
- ``launch_api``: the host-side launch calls the profiler recorded
  (``cudaLaunchKernel*`` / ``cuLaunchKernel*``);
- ``odd``: the device records whose count is not a multiple of the steps
  (what a step did once in the window), by name;
- ``finished``: the requests that finished inside the window (a finished
  slot's position is reset on the card: one small kernel).

With ``--parent DIR`` (a checkout of another commit) the windows run from
DIR's package and DIR's ``chip_smoke.py`` first, then from this tree's, each
in a process of its own. Writes every line to
``chiprun_out/profile_decode.jsonl`` as well. Needs a GPU; exits 1 without
one.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "chiprun_out", "profile_decode.jsonl")
STEPS = 4                      # the smoke's window (_profile_decode)
LAUNCH_API = ("cudaLaunchKernel", "cuLaunchKernel")


def emit(obj) -> None:
    line = json.dumps(obj)
    print(line, flush=True)
    with open(OUT, "a") as f:
        f.write(line + "\n")


def _window(cs, eng, requests, tag: str):
    """One window as the smoke's _profile_decode runs it: admit, profile
    STEPS pure-decode steps, drain. Returns its record."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from bigdl_tpu_torch.ops.cuda import launch_counts

    def b3_calls():
        return sum(v for k, v in launch_counts().items()
                   if k.startswith(("decode_attention",
                                    "paged_decode_attention")))

    ids = [rid + tag for rid, _, _ in requests]
    for rid, (_, prompt, sp) in zip(ids, requests):
        eng.add_request(rid, prompt, sp)
    while eng.waiting or eng._admitting is not None:
        eng.step()
    torch.cuda.synchronize()
    active0 = sum(s.active for s in eng.slots)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.__enter__()
    calls0 = b3_calls()
    finished = []
    for _ in range(STEPS):
        eng.step()
        for rid in ids:
            if any(o.finished for o in eng.get_outputs(rid)):
                finished.append(rid)
    torch.cuda.synchronize()
    calls = b3_calls() - calls0
    prof.__exit__(None, None, None)
    dev, api = collections.Counter(), collections.Counter()
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA:
            if not e.key.startswith("bigdl."):
                dev[e.key] += e.count
        elif e.key.startswith(LAUNCH_API):
            api[e.key] += e.count
    b3 = sum(n for k, n in dev.items()
             if cs._kernel_group(k) == "decode_attention (B3)")
    while eng.has_unfinished():
        eng.step()
        for rid in ids:
            eng.get_outputs(rid)
    return {"active_at_start": active0, "b3_calls": calls, "b3_kernels": b3,
            "device_records": sum(dev.values()),
            "launch_api": sum(api.values()),
            "odd": {k: n for k, n in sorted(dev.items()) if n % STEPS},
            "finished": finished}


def _run(root: str, tag: str, windows: int) -> None:
    """Every engine's windows from the package and smoke under `root`."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from bigdl_tpu_torch.models import mixtral
    from bigdl_tpu_torch.models.llama import merge_projections
    from bigdl_tpu_torch.serving.engine import EngineConfig, LLMEngine
    from bigdl_tpu_torch.utils.testing import (LLAMA2_7B, SyntheticCausalLM,
                                               random_llama_params)

    cfg = LLAMA2_7B
    params = merge_projections(random_llama_params(
        cfg, "sym_int4", seed=0, device="cuda"), cfg)
    _, requests = cs._engine_requests(cfg, 32)
    engines = [("llama2-7b", kind, lambda kind=kind: LLMEngine(
        SyntheticCausalLM(params, cfg),
        EngineConfig(max_batch=8, max_seq=2048, kv_cache_dtype=kind),
        device="cuda")) for kind in ("bf16",) + cs.QUANT_KV_KINDS]
    for model, kind, make in engines:
        eng = make()
        cs._run_requests(eng, requests)
        for w in range(windows):
            emit({"tree": tag, "model": model, "kv": kind, "window": w,
                  "steps": STEPS, **_window(cs, eng, requests, f"-w{w}")})
        del eng
        gc.collect()
        torch.cuda.empty_cache()
    del params, engines
    gc.collect()
    torch.cuda.empty_cache()
    moe_params, moe_cfg = cs.phase_model_moe()
    _, requests = cs._engine_requests(moe_cfg, 32)
    eng = LLMEngine(SyntheticCausalLM(moe_params, moe_cfg, family=mixtral),
                    EngineConfig(max_batch=8, max_seq=2048), device="cuda")
    cs._run_requests(eng, requests)
    for w in range(windows):
        emit({"tree": tag, "model": "mixtral-8x7b", "kv": "bf16",
              "window": w, "steps": STEPS,
              **_window(cs, eng, requests, f"-w{w}")})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="checkout of another commit, run first")
    ap.add_argument("--windows", type=int, default=6)
    ap.add_argument("--run", metavar="ROOT", help=argparse.SUPPRESS)
    ap.add_argument("--tag", default="this tree", help=argparse.SUPPRESS)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device", file=sys.stderr)
        return 1
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    if args.run:
        _run(os.path.abspath(args.run), args.tag, args.windows)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    emit({"card": smi.stdout.strip(), "torch": torch.__version__})
    runs = [(ROOT, "this tree")]
    if args.parent:
        runs.insert(0, (os.path.abspath(args.parent), "parent"))
    me = os.path.abspath(__file__)
    for root, tag in runs:
        subprocess.run([sys.executable, me, "--run", root, "--tag", tag,
                        "--windows", str(args.windows)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
