"""Carry the JAX package's parameters across to the port.

Input is a parameter tree whose leaves are numpy arrays, as
``jax.tree.map(numpy.asarray, params)`` gives it. A quantized leaf is any
object with ``data``, ``scale``, ``zero``, ``qtype`` and ``shape``
attributes (the JAX package's QTensor after that map); its planes are
copied byte for byte, stacked ``[L, ...]`` layer planes included. bf16
leaves may arrive as a ``bfloat16`` numpy dtype or as their uint16 bit
view; both become ``torch.bfloat16`` with the same bits. No module of the
JAX package is imported here: the tree is duck-typed.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from bigdl_tpu_torch.ops.quant import QTensor, get_qtype


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """numpy array -> torch tensor with the same bytes. bfloat16 arrays
    (and uint16 bit views of them) become torch.bfloat16."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or a.dtype == np.uint16:
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    if a.dtype.kind == "V" or a.dtype.name.startswith("float8"):
        raise TypeError(f"unsupported leaf dtype {a.dtype}")
    return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)


def _is_qtensor(leaf) -> bool:
    # (a numpy array has a .data buffer attribute of its own)
    return not isinstance(leaf, np.ndarray) and all(
        hasattr(leaf, f) for f in ("data", "scale", "zero", "qtype",
                                   "shape"))


def qtensor_from_numpy(leaf, device="cuda") -> QTensor:
    qt = get_qtype(leaf.qtype)
    data = tensor_from_numpy(leaf.data, device)
    want = torch.int8 if qt.storage_bits == 8 else torch.uint8
    if data.dtype != want:
        raise TypeError(f"{leaf.qtype} data plane is {data.dtype}, expected "
                        f"{want} (the TPU-only int4 layout is not carried)")
    if getattr(leaf, "aux", None) is not None:
        raise TypeError(f"{leaf.qtype}: aux planes are not ported")
    return QTensor(data, tensor_from_numpy(leaf.scale, device),
                   None if leaf.zero is None
                   else tensor_from_numpy(leaf.zero, device),
                   qt.name, tuple(int(s) for s in leaf.shape))


def params_from_numpy(tree: Any, device="cuda") -> Any:
    """Convert a nested dict/list parameter tree (numpy leaves, quantized
    leaves duck-typed as above) into the port's layout."""
    if _is_qtensor(tree):
        return qtensor_from_numpy(tree, device)
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    if tree is None:
        return None
    return tensor_from_numpy(tree, device)
