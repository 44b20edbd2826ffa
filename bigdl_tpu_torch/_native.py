"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface and loaded with ctypes. Builds
happen at first use, all sources at once (one ``nvcc`` process each,
started together), into ``bigdl_tpu_torch/_build/<hash>/``; the hash
covers the sources and the flags, so an edited source rebuilds and an
unchanged one loads from the cache. A missing ``nvcc`` or a failed build
raises: nothing runs without its kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict, Optional, Tuple

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
SOURCES = ("dequant_gemv", "dequant_gemm", "decode_attention",
           "prefill_attention", "paged_decode_attention", "moe_dispatch")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-lineinfo", "-shared",
                           "-Xcompiler", "-fPIC"]

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int
_c_float = ctypes.c_float
_c_int64 = ctypes.c_longlong

# C entry points of each library: the launch (returns a cudaError_t) first
SIGNATURES = {
    "dequant_gemv": {
        "bigdl_dequant_gemv": [_c_void_p] * 7 + [_c_int] * 8 + [_c_void_p],
        "bigdl_dequant_gemv_blocks_per_sm": [_c_int] * 3},
    "dequant_gemm": {
        "bigdl_dequant_gemm": [_c_void_p] * 7 + [_c_int] * 8 + [_c_void_p],
        "bigdl_dequant_gemm_blocks_per_sm": [_c_int] * 3},
    "decode_attention": {
        "bigdl_decode_attention": [_c_void_p] * 6 + [_c_int] * 5
        + [_c_float, _c_void_p]},
    "prefill_attention": {
        "bigdl_prefill_attention": [_c_void_p] * 5 + [_c_int] * 6
        + [_c_float, _c_void_p]},
    "paged_decode_attention": {
        "bigdl_paged_decode_attention": [_c_void_p] * 7 + [_c_int] * 7
        + [_c_float, _c_void_p]},
    "moe_dispatch": {
        "bigdl_ragged_expert_matmul": [_c_void_p] * 9 + [_c_int] * 6
        + [_c_int64] * 2 + [_c_int] * 2 + [_c_void_p],
        "bigdl_moe_dispatch_blocks_per_sm": [_c_int] * 3},
}

_lock = threading.Lock()
_funcs: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}


def find_nvcc() -> str:
    cands = [os.environ.get("NVCC"), shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                          "bin", "nvcc")]
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set $NVCC or $CUDA_HOME): the CUDA kernels of "
        "bigdl_tpu_torch cannot be built")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for fn in sorted(os.listdir(CSRC)):
        if fn == f"{name}.cu" or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode() + b"\0" + f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_ROOT, _digest(name), f"lib{name}.so")


def build_all(names=SOURCES) -> Dict[str, str]:
    """Compile every source that has no cached library, one nvcc per
    source, all running at once. Returns {name: library path}; raises
    with nvcc's output if any build fails."""
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n in names if not os.path.isfile(paths[n])]
    if not todo:
        return paths
    nvcc = find_nvcc()
    procs = {}
    for n in todo:
        os.makedirs(os.path.dirname(paths[n]), exist_ok=True)
        tmp = paths[n] + f".tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(
            cmd, cwd=CSRC, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    errors = []
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"--- nvcc {n}.cu (exit {proc.returncode}) ---\n"
                          f"{out}")
            continue
        if out.strip():
            print(f"[nvcc {n}.cu]\n{out}", flush=True)
        os.replace(tmp, paths[n])
    if errors:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(errors))
    return paths


def kernel(name: str, symbol: Optional[str] = None):
    """The ctypes function `symbol` (default: the launch entry point) of
    kernel library `name`, building and loading it on first use."""
    syms = SIGNATURES[name]
    symbol = symbol or next(iter(syms))
    fn = _funcs.get((name, symbol))
    if fn is not None:
        return fn
    with _lock:
        fn = _funcs.get((name, symbol))
        if fn is None:
            lib = ctypes.CDLL(build_all((name,))[name])
            for sym, argtypes in syms.items():
                f = getattr(lib, sym)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
                _funcs[(name, sym)] = f
            fn = _funcs[(name, symbol)]
    return fn


def check(name: str, err: int) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed with cudaError_t "
                           f"{err}")
