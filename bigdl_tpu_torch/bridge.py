"""Carry the JAX package's parameters across to the port.

Input is a parameter tree whose leaves are numpy arrays, as
``jax.tree.map(numpy.asarray, params)`` gives it. A quantized leaf is any
object with ``data``, ``scale``, ``zero``, ``qtype`` and ``shape``
attributes (the JAX package's QTensor after that map); its planes are
copied byte for byte, stacked ``[L, ...]`` layer planes included. A
prepacked sym_int4 leaf, whose data is ``ml_dtypes.int4`` ``[..., Kp, N]``
(the JAX package's int4-dtype layout), becomes the port's int4 layout:
the same signed codes packed two a byte (``ops/quant.pack_int4_rows``);
``qtensor_to_numpy`` carries a port QTensor back, int4-layout codes as
int8 or as a dtype the caller names. bf16
leaves may arrive as a ``bfloat16`` numpy dtype or as their uint16 bit
view; both become ``torch.bfloat16`` with the same bits. No module of the
JAX package is imported here: the tree is duck-typed.

KV caches cross too (``kv_cache_from_numpy``): a JAX ``KVCache`` or
``PagedKVCache`` whose planes are numpy arrays becomes the port's cache
with the same codes, scales and positions, int4 codes (``ml_dtypes.int4``)
packed two to a byte; ``kv_cache_to_numpy`` reads one back for
comparison.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from bigdl_tpu_torch.ops.kvcache import KVCache, pack_int4, unpack_int4
from bigdl_tpu_torch.ops.paged import PagedKVCache
import types

from bigdl_tpu_torch.ops.quant import (LAYOUT_INT4, QTensor, get_qtype,
                                       pack_int4_rows, unpack_int4_rows)


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
    if getattr(leaf, "aux", None) is not None:
        raise TypeError(f"{leaf.qtype}: aux planes are not ported")
    layout = "canonical"
    raw = np.asarray(leaf.data)
    if raw.dtype.name == "int4":
        if qt.name != "sym_int4":
            raise TypeError(f"int4-dtype data for {leaf.qtype}: only "
                            "sym_int4 has the int4 layout")
        codes = torch.from_numpy(np.ascontiguousarray(raw.astype(np.int8)))
        data, layout = pack_int4_rows(codes).to(device), LAYOUT_INT4
    else:
        data = tensor_from_numpy(raw, device)
        want = torch.int8 if qt.storage_bits == 8 else torch.uint8
        if data.dtype != want:
            raise TypeError(f"{leaf.qtype} data plane is {data.dtype}, "
                            f"expected {want}")
    return QTensor(data, tensor_from_numpy(leaf.scale, device),
                   None if leaf.zero is None
                   else tensor_from_numpy(leaf.zero, device),
                   qt.name, tuple(int(s) for s in leaf.shape), layout)


def qtensor_to_numpy(qt: QTensor, int4_dtype=None):
    """A port QTensor as numpy planes (a namespace with ``data``,
    ``scale``, ``zero``, ``qtype``, ``shape``): bf16 as its uint16 bits;
    int4-layout data as the signed codes ``[..., Kp, N]``, int8 or
    ``int4_dtype`` (e.g. ``ml_dtypes.int4``, the JAX package's layout)."""
    def bits(t):
        return None if t is None else (
            t.detach().cpu().contiguous().view(torch.int16).numpy()
            .view(np.uint16))

    if qt.is_int4:
        data = unpack_int4_rows(qt.data.detach().cpu()).numpy()
        if int4_dtype is not None:
            data = data.astype(int4_dtype)
    else:
        data = qt.data.detach().cpu().numpy()
    return types.SimpleNamespace(data=data, scale=bits(qt.scale),
                                 zero=bits(qt.zero), qtype=qt.qtype,
                                 shape=tuple(qt.shape))


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


def kv_plane_from_numpy(a, device="cuda") -> torch.Tensor:
    """One KV code or scale plane: bf16, float8_e5m2 (same bytes), int8,
    int4 (packed, ``ops/kvcache.pack_int4``) or f32."""
    a = np.asarray(a)
    name = a.dtype.name
    if name == "float8_e5m2":
        bits = np.ascontiguousarray(a).view(np.uint8)
        return torch.from_numpy(bits.copy()).view(torch.float8_e5m2).to(
            device)
    if name == "int4":
        return pack_int4(torch.from_numpy(a.astype(np.int8))).to(device)
    return tensor_from_numpy(a, device)


def kv_cache_from_numpy(cache, device="cuda"):
    """A JAX ``KVCache`` / ``PagedKVCache`` (duck-typed: ``k``, ``v``,
    ``pos``, ``k_scale``, ``v_scale`` as numpy arrays; a paged cache is
    recognised by its class name) -> the port's cache of the same
    kind."""
    planes = [None if p is None else kv_plane_from_numpy(p, device)
              for p in (cache.k, cache.v, cache.pos, cache.k_scale,
                        cache.v_scale)]
    cls = PagedKVCache if type(cache).__name__ == "PagedKVCache" else KVCache
    return cls(*planes)


def kv_plane_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A port KV plane as numpy: bf16 as its uint16 bits, float8_e5m2 as
    its bytes, int4 unpacked to int8 codes, int8 and f32 as they are."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    if t.dtype == torch.float8_e5m2:
        return t.view(torch.uint8).numpy()
    if t.dtype == torch.uint8:
        return unpack_int4(t).numpy()
    return t.numpy()


def kv_cache_to_numpy(cache) -> dict:
    """Inverse of ``kv_cache_from_numpy`` for comparison: the planes of a
    port cache by name (``kv_plane_to_numpy``; missing scales None)."""
    return {f: None if getattr(cache, f) is None
            else kv_plane_to_numpy(getattr(cache, f))
            for f in ("k", "v", "pos", "k_scale", "v_scale")}
