"""Runtime flags of the port, read from the environment at each call.

Only the knobs the serving path reads:

- ``BIGDL_TPU_TORCH_MATMUL_MAX_M`` (default 128, at most 128, the rows one
  dequant-GEMM launch takes): quantized linears with more rows than this
  skip the dequant kernels and run as dequantize then ``torch.matmul``
  (``matmul_pallas_max_m`` in the JAX package).
- ``BIGDL_TPU_TORCH_ATTENTION_BACKEND`` (default ``auto``): ``auto`` sends
  supported shapes to the attention kernels, ``plain`` keeps every call on
  the plain version.
"""

from __future__ import annotations

import dataclasses
import os

# rows one dequant-GEMM launch takes (GEMM_MAX_M of ops/cuda/dequant_matmul)
MATMUL_MAX_M_CEILING = 128


@dataclasses.dataclass(frozen=True)
class Flags:
    matmul_max_m: int = MATMUL_MAX_M_CEILING
    attention_backend: str = "auto"


def flags() -> Flags:
    be = os.environ.get("BIGDL_TPU_TORCH_ATTENTION_BACKEND", "auto")
    if be not in ("auto", "plain"):
        raise ValueError(f"BIGDL_TPU_TORCH_ATTENTION_BACKEND must be auto or "
                         f"plain, got {be!r}")
    max_m = int(os.environ.get("BIGDL_TPU_TORCH_MATMUL_MAX_M",
                               str(MATMUL_MAX_M_CEILING)))
    if not 0 <= max_m <= MATMUL_MAX_M_CEILING:
        raise ValueError(f"BIGDL_TPU_TORCH_MATMUL_MAX_M must be in "
                         f"[0, {MATMUL_MAX_M_CEILING}], got {max_m}")
    return Flags(matmul_max_m=max_m, attention_backend=be)
