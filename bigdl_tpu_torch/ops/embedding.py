"""Embedding lookup (counterpart of
``bigdl_tpu/ops/embedding.py::embedding_lookup``)."""

from __future__ import annotations

import torch

from bigdl_tpu_torch.ops.quant import QTensor, dequantize


def embedding_lookup(table, ids: torch.Tensor,
                     dtype=torch.bfloat16) -> torch.Tensor:
    """ids [...] -> embeddings [..., D]. `table` is a dense [V, D] tensor
    or a QTensor of logical shape [D, V] (blocks along D): only the
    gathered columns are dequantized."""
    if not isinstance(table, QTensor):
        return table[ids].to(dtype)
    flat = ids.reshape(-1)
    gathered = QTensor(
        table.data[:, flat].contiguous(), table.scale[:, flat].contiguous(),
        None if table.zero is None else table.zero[:, flat].contiguous(),
        table.qtype, (table.k, flat.shape[0]))
    dense = dequantize(gathered, dtype=dtype)        # [D, n]
    return dense.t().reshape(*ids.shape, table.k)
