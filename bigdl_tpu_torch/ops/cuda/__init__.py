"""Python wrappers of the hand-written CUDA kernels, each beside its plain
PyTorch version.

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel or raises; it never falls back. Every
launch adds one to the wrapper's entry in ``LAUNCHES``, so a run can show
which kernels its main path went through.
"""

from typing import Dict

LAUNCHES: Dict[str, int] = {
    "dequant_gemv": 0,
    "dequant_gemm": 0,
    "decode_attention": 0,
    "prefill_attention": 0,
    "paged_decode_attention": 0,
    "ragged_expert_matmul": 0,
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)
