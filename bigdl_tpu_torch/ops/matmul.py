"""Quantized linear: ``q_matmul`` / ``linear`` / ``q_linear``
(counterpart of ``bigdl_tpu/ops/matmul.py``).

Dispatch mirrors ``_q_matmul_dispatch``: with M the number of rows,

- M <= 32: the decode GEMV kernel B1 (``ops/cuda/dequant_matmul``);
- 32 < M <= ``flags().matmul_max_m`` (128): the tiled dequant GEMM B2;
- larger M: dequantize to bf16, then a plain ``torch.matmul`` (the JAX
  package leaves this case to XLA's dequantize-then-matmul plan too).

On CPU tensors the two kernel wrappers run their plain version, which is
the same function as the large-M path. On a CUDA tensor they launch their
kernel or raise (a qtype or shape the kernels do not take is an error,
not a reason to fall back).
"""

from __future__ import annotations

from typing import Optional

import torch

from bigdl_tpu_torch.config import flags
from bigdl_tpu_torch.ops.cuda.dequant_matmul import (GEMV_MAX_M,
                                                     dequant_gemm,
                                                     dequant_gemv,
                                                     plain_q_matmul)
from bigdl_tpu_torch.ops.quant import QTensor


def q_matmul(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """x [..., K] @ W for a quantized W of logical shape [K, N]; returns
    [..., N] in x.dtype."""
    k, n = w.shape
    batch = x.shape[:-1]
    x2 = x.reshape(-1, k)
    m = x2.shape[0]
    if m <= GEMV_MAX_M:
        y = dequant_gemv(x2, w)
    elif m <= flags().matmul_max_m:
        y = dequant_gemm(x2, w)
    else:
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
    (dense: f32 accumulation, output in x.dtype)."""
    if isinstance(w, QTensor):
        return q_linear(x, w, bias)
    y = torch.matmul(x.to(torch.float32), w.to(x.dtype).to(torch.float32))
    y = y.to(x.dtype)
    if bias is not None:
        y = y + bias.to(y.dtype)
    return y
