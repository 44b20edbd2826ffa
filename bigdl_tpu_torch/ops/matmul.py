"""Quantized linear: ``q_matmul`` / ``linear`` / ``q_linear``
(counterpart of ``bigdl_tpu/ops/matmul.py``).

Kernel dispatch (the default backend) mirrors ``_q_matmul_dispatch`` and
``q_matmul_pallas_impl``: with M the number of rows,

- M <= 32: the decode GEMV kernel B1 (``ops/cuda/dequant_matmul``), whose
  body ``matmul_gemv`` (``BIGDL_TPU_TORCH_MATMUL_GEMV``) and the weight's
  layout pick (``pick_gemv_body``: ``mxu`` on a prepacked int4-layout
  weight, the standard body on the canonical packing, by default); with
  ``matmul_gemv`` ``off`` these rows go to B2;
- 32 < M <= ``flags().matmul_max_m`` (128): the tiled dequant GEMM B2,
  its ``i4`` body on the int4 layout;
- larger M: dequantize to bf16, then a plain ``torch.matmul`` (the JAX
  package leaves this case to XLA's dequantize-then-matmul plan too).

On CPU tensors the kernel wrappers run their bodies' plain versions. On a
CUDA tensor they launch their kernel or raise (a qtype, layout or shape a
body does not take is an error, not a reason to fall back).

``backend="xla"`` runs the plain dequantize-then-matmul path at every M
and ``backend="xla_fused"`` the scale-folded plain path
(``_q_matmul_xla_fused`` of the JAX package, which raises
``NotImplementedError`` for a qtype whose dequant does not factor, fp4),
on any device: the JAX package's backend switch, for comparisons.
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.config import flags
from bigdl_tpu_torch.ops.cuda.dequant_matmul import (GEMV_MAX_M,
                                                     dequant_gemm,
                                                     dequant_gemv,
                                                     pick_gemv_body,
                                                     plain_q_matmul,
                                                     plain_q_matmul_fused)
from bigdl_tpu_torch.ops.quant import QTensor

BACKENDS = ("auto", "xla", "xla_fused")
# the torch.profiler range around the large-M dequantize-then-matmul path
DEQUANT_THEN_MATMUL = "bigdl.dequant_then_matmul"


def q_matmul(x: torch.Tensor, w: QTensor, *,
             backend: Optional[str] = None) -> torch.Tensor:
    """x [..., K] @ W for a quantized W of logical shape [K, N]; returns
    [..., N] in x.dtype. `backend`: None or "auto" (the kernels), "xla"
    or "xla_fused" (the plain paths)."""
    be = backend or "auto"
    if be not in BACKENDS:
        raise ValueError(f"unknown matmul backend {backend!r}; choose from "
                         f"{BACKENDS}")
    k, n = w.shape
    batch = x.shape[:-1]
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    f = flags()
    if be == "xla":
        y = plain_q_matmul(x2, w)
    elif be == "xla_fused":
        y = plain_q_matmul_fused(x2, w)
    elif m <= GEMV_MAX_M and f.matmul_gemv != "off":
        y = dequant_gemv(x2, w, pick_gemv_body(f.matmul_gemv, w))
    elif m <= f.matmul_max_m:
        y = dequant_gemm(x2, w, "i4" if w.is_int4 else "std")
    else:
        # a profiler range names the path's kernels (chip_smoke.py reads
        # its device time)
        with torch.profiler.record_function(DEQUANT_THEN_MATMUL):
            y = plain_q_matmul(x2, w)
    return y.to(x.dtype).reshape(*batch, n)


def q_linear(x: torch.Tensor, w: QTensor,
             bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    y = q_matmul(x, w)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y


def linear(x: torch.Tensor, w, bias: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """Linear over a QTensor or a dense contraction-major [K, N] weight
    (dense: the weight in x.dtype, products summed in f32, output in
    x.dtype). On the card a bf16 x and weight go to one product that sums
    in f32 and rounds once (``jnp.dot(..., preferred_element_type=f32)``)
    with no f32 copy of the weight; elsewhere both are widened to f32."""
    if isinstance(w, QTensor):
        return q_linear(x, w, bias)
    if x.is_cuda and x.dtype == w.dtype == torch.bfloat16:
        y = torch.mm(x.reshape(-1, x.shape[-1]), w, out_dtype=torch.float32)
        y = y.reshape(*x.shape[:-1], w.shape[-1])
    else:
        y = torch.matmul(x.to(torch.float32),
                         w.to(x.dtype).to(torch.float32))
    y = y.to(x.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
