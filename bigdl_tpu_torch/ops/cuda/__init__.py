"""Python wrappers of the hand-written CUDA kernels, each beside its plain
PyTorch version.

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel or raises; it never falls back. Every
launch adds one to the wrapper's entry in ``LAUNCHES``, so a run can show
which kernels its main path went through.

A CUDA graph replays its kernels without running the wrappers, so a
capture runs under ``capturing_launches``: the launches the wrappers
count while it records are taken back out of ``LAUNCHES`` (a capture
launches nothing) and kept with the graph, and ``replayed`` adds them
again on each replay and counts the replay in ``REPLAYS``.
"""

import contextlib
from typing import Dict, Iterator

QUANT_KV_KINDS = ("fp8_e5m2", "int8", "int4")
ATTENTION_KERNELS = ("decode_attention", "prefill_attention",
                     "paged_decode_attention")

# the dequant-matmul bodies (ops/cuda/dequant_matmul.py)
DEQUANT_KERNELS = ("dequant_gemv", "dequant_gemv_mxu", "dequant_gemv_fold",
                   "dequant_gemv_mxuflat", "dequant_gemv_mxu8",
                   "dequant_gemm", "dequant_gemm_i4")

LAUNCHES: Dict[str, int] = {
    **{name: 0 for name in DEQUANT_KERNELS},
    **{name: 0 for name in ATTENTION_KERNELS},
    "ragged_expert_matmul": 0,
    "ragged_expert_matmul_dense": 0,
    **{f"{name}_{kind}": 0 for name in ATTENTION_KERNELS
       for kind in QUANT_KV_KINDS},
}


# replays of each kind of captured step (a graph owner's name)
REPLAYS: Dict[str, int] = {}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    REPLAYS.clear()


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def replay_counts() -> Dict[str, int]:
    return dict(REPLAYS)


@contextlib.contextmanager
def capturing_launches() -> Iterator[Dict[str, int]]:
    """Around a graph capture: yields a dict that holds, on exit, the
    launches each wrapper counted inside (its kernels in the graph), and
    leaves ``LAUNCHES`` as it was before."""
    before = dict(LAUNCHES)
    captured: Dict[str, int] = {}
    try:
        yield captured
    finally:
        for k, v in LAUNCHES.items():
            if v != before[k]:
                captured[k] = v - before[k]
                LAUNCHES[k] = before[k]


def replayed(name: str, captured: Dict[str, int]) -> None:
    """One replay of a graph of kind `name` that holds `captured`'s
    launches."""
    for k, v in captured.items():
        LAUNCHES[k] += v
    REPLAYS[name] = REPLAYS.get(name, 0) + 1
