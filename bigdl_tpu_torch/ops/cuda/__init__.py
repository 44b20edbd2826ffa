"""Python wrappers of the hand-written CUDA kernels, each beside its plain
PyTorch version.

A wrapper takes the plain version only for tensors on the CPU. For CUDA
tensors it launches its kernel or raises; it never falls back. Every
launch adds one to the wrapper's entry in ``LAUNCHES``, so a run can show
which kernels its main path went through.
"""

from typing import Dict

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


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)
