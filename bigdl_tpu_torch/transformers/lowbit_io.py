"""Quantized checkpoint directories: save_low_bit / load_low_bit
(counterpart of ``bigdl_tpu/transformers/lowbit_io.py``).

A directory holds

  low_bit_weights.safetensors: every tensor leaf of the parameter tree
      under its "path.to.leaf" key (a QTensor's planes as <key>#data,
      #scale, #zero). bfloat16 is stored as its uint16 view and fp8 as
      its uint8 view; the manifest names the logical dtype.
  low_bit_manifest.json: per-leaf kind and dtype, each QTensor's qtype and
      logical shape, the config dict, the family name, the low-bit marker.

The names, the manifest and the bytes are the JAX package's, so a
directory written by either package loads in the other. QTensors are
written in the canonical split-block layout whatever their layout in
memory (``from_mxu_layout``, one leaf at a time).

The safetensors file is read and written here with numpy and json only
(the format: an 8-byte little-endian header length, a JSON header of
dtype / shape / data_offsets per tensor, padded with spaces to 8 bytes,
then the raw bytes), byte for byte as ``safetensors.numpy`` writes it:
tensors ordered by dtype, widest first, then by name.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Callable, Dict, Iterator, List, Tuple

import numpy as np
import torch

from bigdl_tpu_torch import __version__
from bigdl_tpu_torch.ops.quant import QTensor, from_mxu_layout

_WEIGHTS = "low_bit_weights.safetensors"
_MANIFEST = "low_bit_manifest.json"
MARKER = "bigdl_tpu_low_bit"

# safetensors dtype names, in the order of the format's dtype enum (its
# writer puts wider dtypes first: descending in this order)
_ST_ORDER = ("BOOL", "U8", "I8", "F8_E5M2", "F8_E4M3", "I16", "U16", "F16",
             "BF16", "I32", "U32", "F32", "F64", "I64", "U64")
_ST_NAME = {np.dtype(np.bool_): "BOOL", np.dtype(np.uint8): "U8",
            np.dtype(np.int8): "I8", np.dtype(np.int16): "I16",
            np.dtype(np.uint16): "U16", np.dtype(np.float16): "F16",
            np.dtype(np.int32): "I32", np.dtype(np.uint32): "U32",
            np.dtype(np.float32): "F32", np.dtype(np.float64): "F64",
            np.dtype(np.int64): "I64", np.dtype(np.uint64): "U64"}
_NP_DTYPE = {v: k for k, v in _ST_NAME.items()}
# numpy has no bfloat16: BF16 tensors are written from and read as their
# uint16 bits (``read_safetensors``), and come out of ``iter_safetensors``
# as torch.bfloat16
_NP_DTYPE["BF16"] = np.dtype(np.uint16)
_TORCH_VIEW = {"BF16": (torch.int16, torch.bfloat16)}

# torch dtype -> (logical dtype name of the manifest, stored numpy dtype)
_STORE = {torch.bfloat16: ("bfloat16", np.uint16),
          torch.float8_e5m2: ("float8_e5m2", np.uint8),
          torch.float8_e4m3fn: ("float8_e4m3fn", np.uint8),
          torch.float16: ("float16", np.float16),
          torch.float32: ("float32", np.float32),
          torch.float64: ("float64", np.float64),
          torch.uint8: ("uint8", np.uint8), torch.int8: ("int8", np.int8),
          torch.int16: ("int16", np.int16), torch.int32: ("int32", np.int32),
          torch.int64: ("int64", np.int64), torch.bool: ("bool", np.bool_)}
_VIEW = {"bfloat16": (np.int16, torch.bfloat16),
         "float8_e5m2": (np.uint8, torch.float8_e5m2),
         "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


# -- safetensors, numpy only ---------------------------------------------------

def _st_sorted(infos: Dict[str, Tuple[str, tuple]]) -> List[str]:
    """Tensor names in the order safetensors' writer lays them out."""
    return sorted(infos, key=lambda k: (-_ST_ORDER.index(infos[k][0]), k))


def _st_name(dt) -> str:
    return dt if isinstance(dt, str) else _ST_NAME[np.dtype(dt)]


def write_safetensors(path: str,
                      tensors: Dict[str, Tuple[np.dtype, tuple, Callable]]
                      ) -> None:
    """Write a safetensors file from {name: (dtype, shape, fetch)}:
    `fetch()` returns the tensor's C-ordered numpy array when its turn
    comes, so one tensor at a time is on the host. The dtype is a numpy
    dtype or a safetensors dtype name ("BF16": fetch gives the uint16
    bits)."""
    infos = {k: (_st_name(dt), tuple(int(d) for d in shape))
             for k, (dt, shape, _) in tensors.items()}
    order = _st_sorted(infos)
    header, off = {}, 0
    for k in order:
        name, shape = infos[k]
        nbytes = int(np.prod(shape, dtype=np.int64)) * np.dtype(
            _NP_DTYPE[name]).itemsize
        header[k] = {"dtype": name, "shape": list(shape),
                     "data_offsets": [off, off + nbytes]}
        off += nbytes
    blob = json.dumps(header, separators=(",", ":"),
                      ensure_ascii=False).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for k in order:
            arr = np.ascontiguousarray(tensors[k][2]())
            want = header[k]
            if (arr.dtype != _NP_DTYPE[want["dtype"]]
                    or list(arr.shape) != want["shape"]):
                raise ValueError(f"{k}: fetched {arr.dtype} {arr.shape}, "
                                 f"declared {want['dtype']} {want['shape']}")
            f.write(arr.tobytes())


def _read_header(path: str) -> Tuple[int, Dict[str, Any]]:
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return 8 + n, header


def read_safetensors(path: str) -> Dict[str, np.ndarray]:
    """{name: read-only numpy array} of a safetensors file, mapped from
    disk (nothing is read until a tensor is used). BF16 tensors come as
    their uint16 bits."""
    start, header = _read_header(path)
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    out = {}
    for k, info in header.items():
        b, e = info["data_offsets"]
        dt = np.dtype(_NP_DTYPE[info["dtype"]])
        out[k] = raw[start + b:start + e].view(dt).reshape(info["shape"])
    return out


def iter_safetensors(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """(name, CPU tensor) for every tensor of a safetensors file in name
    order, each read from disk when its turn comes, in its stored dtype
    (BF16 as torch.bfloat16, F16 as torch.float16)."""
    start, header = _read_header(path)
    raw = np.memmap(path, dtype=np.uint8, mode="r")
    for k in sorted(header):
        info = header[k]
        b, e = info["data_offsets"]
        arr = np.array(raw[start + b:start + e])        # one tensor's copy
        name = info["dtype"]
        if name in _TORCH_VIEW:
            view, dtype = _TORCH_VIEW[name]
            t = torch.from_numpy(arr.view(np.int16)).view(dtype)
        else:
            t = torch.from_numpy(arr.view(_NP_DTYPE[name]))
        yield k, t.reshape(info["shape"])


# -- the parameter tree --------------------------------------------------------

def _walk(tree: Any, prefix, arrays, meta) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            _walk(v, prefix + (str(k),), arrays, meta)
    elif isinstance(tree, QTensor):
        key = ".".join(prefix)
        meta[key] = {"kind": "qtensor", "qtype": tree.qtype,
                     "shape": list(tree.shape)}
        arrays[key] = tree
    elif tree is None:
        pass
    else:
        key = ".".join(prefix)
        meta[key] = {"kind": "array"}
        arrays[key] = tree


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor's stored numpy form (bf16 as uint16, fp8 as uint8)."""
    name, np_dt = _STORE[t.dtype]
    t = t.detach().contiguous().cpu()
    if name in _VIEW:
        t = t.view(torch.int16 if np_dt == np.uint16 else torch.uint8)
        return t.numpy().view(np_dt)
    return t.numpy()


def save_low_bit(params: Any, path: str, config: Dict[str, Any] = None,
                 family: str = None, qtype: str = None,
                 extra: Dict[str, Any] = None) -> None:
    """Persist a (possibly quantized) parameter tree to directory `path`,
    QTensors in the canonical layout."""
    os.makedirs(path, exist_ok=True)
    leaves: Dict[str, Any] = {}
    meta: Dict[str, Any] = {}
    _walk(params, (), leaves, meta)

    tensors: Dict[str, tuple] = {}
    dtypes: Dict[str, str] = {}

    def add(key, t, fetch):
        name, np_dt = _STORE[t.dtype]
        tensors[key] = (np_dt, tuple(t.shape), fetch)
        dtypes[key] = name

    for key, leaf in leaves.items():
        if isinstance(leaf, QTensor):
            # the data plane is relaid (if prepacked) only when written
            add(f"{key}#data", leaf.data,
                lambda q=leaf: _to_numpy(from_mxu_layout(q).data))
            add(f"{key}#scale", leaf.scale,
                lambda t=leaf.scale: _to_numpy(t))
            if leaf.zero is not None:
                add(f"{key}#zero", leaf.zero,
                    lambda t=leaf.zero: _to_numpy(t))
        else:
            add(key, leaf, lambda t=leaf: _to_numpy(t))
    write_safetensors(os.path.join(path, _WEIGHTS), tensors)

    manifest = {
        "format_version": 1,
        "bigdl_tpu_version": __version__,
        MARKER: qtype or "unknown",
        "family": family,
        "config": config or {},
        "leaves": meta,
        "dtypes": dtypes,
        "extra": extra or {},
    }
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)


def is_low_bit_dir(path: str) -> bool:
    return os.path.exists(os.path.join(path, _MANIFEST))


def load_manifest(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, _MANIFEST)) as f:
        return json.load(f)


def _from_numpy(arr: np.ndarray, dtype: str, device) -> torch.Tensor:
    if dtype in _VIEW:
        view_np, view_t = _VIEW[dtype]
        t = torch.from_numpy(np.array(arr).view(view_np))
        return t.view(view_t).to(device)
    return torch.from_numpy(np.array(arr, dtype=np.dtype(dtype))).to(device)


def load_low_bit(path: str, device="cuda") -> Tuple[Any, Dict[str, Any]]:
    """Load (params tree, manifest) saved by save_low_bit, each leaf put on
    `device` as it is read. QTensors come back canonical."""
    manifest = load_manifest(path)
    store = read_safetensors(os.path.join(path, _WEIGHTS))
    dtypes = manifest["dtypes"]

    def get(key):
        return _from_numpy(store[key], dtypes[key], device)

    params: Dict[str, Any] = {}
    for key, info in manifest["leaves"].items():
        parts = key.split(".")
        node = params
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        if info["kind"] == "qtensor":
            if f"{key}#aux" in store:
                raise NotImplementedError(
                    f"{key}: {info['qtype']} carries an aux plane; its "
                    "qtype is not ported")
            node[parts[-1]] = QTensor(
                get(f"{key}#data"), get(f"{key}#scale"),
                get(f"{key}#zero") if f"{key}#zero" in store else None,
                info["qtype"], tuple(info["shape"]))
        else:
            node[parts[-1]] = get(key)
    return params, manifest
