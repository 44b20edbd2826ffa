"""Where the OpenAI server's decode step time goes, on one NVIDIA GPU.

    python3 tools/bench_server.py [--layers N] [--reps R] [--profile-first]

Builds Llama-2-7B at full width and N layers (default 32; random sym_int4
weights from seed 0, merged) and serves ``chip_smoke.py``'s eight engine
requests (32 new tokens each) in four ways, R times in turns (default 1:
direct, loop, poll, server, server, poll, loop, direct):

- direct: ``engine.step()`` on the main thread, as the smoke's engine
  phase drives it (``_run_requests``);
- loop: the server's engine loop thread steps, the main thread waits;
- poll: the loop, plus one thread a request polling ``get_outputs`` every
  2 ms, as ``OpenAIServer._run_request`` does, without HTTP;
- server: eight HTTP clients at once through ``OpenAIServer``
  (non-streamed), as the smoke's ``server`` phase sends them.

With ``--profile-first`` the smoke's profiled decode window
(``_profile_decode``, torch.profiler) runs on the direct engine before
the turns, as the smoke's engine phase runs it before its server phase.
Each run prints the pure-decode step ms (a step with no admission pending
and nothing queued), the decode tokens/s, the wall time and whether every
stream equals the direct run's. Every line is JSON on standard output.
Needs a GPU; exits 1 without one.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("direct", "loop", "poll", "server")


def _poll(eng, rid, toks):
    """``_run_request``'s wait: read outputs, sleep 2 ms when none."""
    while True:
        outs = eng.get_outputs(rid)
        if not outs:
            time.sleep(0.002)
            continue
        for o in outs:
            toks[rid].extend(o.new_token_ids)
        if any(o.finished for o in outs):
            return


def run_mode(cs, mode, direct_eng, srv, requests, tag):
    """One pass of the requests; ids carry `tag` so none repeats."""
    reqs = [(f"{rid}-{tag}", p, sp) for rid, p, sp in requests]
    t0 = time.perf_counter()
    if mode == "direct":
        toks, _, _, perf = cs._run_requests(direct_eng, reqs)
        perf = {k: perf[k] for k in ("decode_steps", "decode_step_ms",
                                     "decode_tokens_per_s")}
    elif mode == "server":
        outs = srv.concurrent([cs._body(p, sp) for _, p, sp in reqs])
        toks = {rid: o[0] for (rid, _, _), o in zip(reqs, outs)}
        perf = srv.decode_perf()
    else:
        eng = srv.engine
        toks = {rid: [] for rid, _, _ in reqs}
        for rid, p, sp in reqs:
            eng.add_request(rid, p, sp)
        srv.server.loop.notify()
        if mode == "poll":
            threads = [threading.Thread(target=_poll, args=(eng, rid, toks))
                       for rid, _, _ in reqs]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        else:
            while eng.has_unfinished():
                time.sleep(0.05)
            for rid in toks:
                for o in eng.get_outputs(rid):
                    toks[rid].extend(o.new_token_ids)
        perf = srv.decode_perf()
    wall = time.perf_counter() - t0
    return {k[:-len(tag) - 1]: v for k, v in toks.items()}, dict(
        perf, wall_s=wall)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", type=int, default=32)
    ap.add_argument("--reps", type=int, default=1)
    ap.add_argument("--profile-first", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    import chip_smoke as cs
    from bigdl_tpu_torch.models import llama
    from bigdl_tpu_torch.serving.engine import EngineConfig, LLMEngine
    from bigdl_tpu_torch.utils.testing import (LLAMA2_7B, SyntheticCausalLM,
                                               random_llama_params)

    try:
        card = cs.phase_device()
        cs.phase_build()
        cfg = dataclasses.replace(LLAMA2_7B, num_hidden_layers=args.layers)
        params = llama.merge_projections(random_llama_params(
            cfg, "sym_int4", seed=0, device="cuda"), cfg)
        model = SyntheticCausalLM(params, cfg)
        ecfg = EngineConfig(max_batch=8, max_seq=2048)
        direct = LLMEngine(model, ecfg, device="cuda")
        srv = cs._Served(model, ecfg)
        _, requests = cs._engine_requests(cfg, 32)
        want = None
        try:
            run_mode(cs, "direct", direct, srv, requests, "warm")
            if args.profile_first:
                cs.emit({"bench": "server", "decode_profile":
                      cs._profile_decode(direct, requests)})
            run_mode(cs, "server", direct, srv, requests, "warm")
            order = MODES + MODES[::-1]
            for rep in range(args.reps):
                for i, mode in enumerate(order):
                    toks, perf = run_mode(cs, mode, direct, srv, requests,
                                          f"{rep}.{i}")
                    if want is None:
                        want = toks
                    cs.emit({"bench": "server", "mode": mode, "rep": rep,
                          "layers": args.layers, "card": card,
                          "profile_first": args.profile_first,
                          "switch_interval_s": sys.getswitchinterval(),
                          "equal_to_first": toks == want, **perf})
        finally:
            srv.close()
        torch.cuda.synchronize()
    except cs.SmokeFailure as e:
        print(f"bench_server FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
