"""Runtime flags of the port, read from the environment at each call.

Only the knobs the serving path reads:

- ``BIGDL_TPU_TORCH_MATMUL_MAX_M`` (default 128, at most 128, the rows one
  dequant-GEMM launch takes): quantized linears with more rows than this
  skip the dequant kernels and run as dequantize then ``torch.matmul``
  (``matmul_pallas_max_m`` in the JAX package).
- ``BIGDL_TPU_TORCH_ATTENTION_BACKEND`` (default ``auto``): ``auto`` sends
  supported shapes to the attention kernels, ``plain`` keeps every call on
  the plain version.
- ``BIGDL_TPU_TORCH_KV_PAGE_SIZE`` (default 0 = slab), ``_KV_PAGES``
  (default 0 = auto) and ``_PREFIX_SHARING`` (default ``auto``): the
  engine's paged KV mode, read when an ``EngineConfig`` field is None
  (``kv_page_size`` / ``kv_pages`` / ``prefix_sharing`` of the JAX
  package, ``bigdl_tpu/config.py``).
- ``BIGDL_TPU_TORCH_KV_CACHE_DTYPE`` (default ``bf16``): the engine's KV
  storage (``bf16``, ``fp8_e5m2``, ``int8`` or ``int4``, and the aliases
  of ``ops/kvcache.resolve_kv_cache_dtype``), read when
  ``EngineConfig.kv_cache_dtype`` is None (``kv_cache_dtype`` of the JAX
  package).
- ``BIGDL_TPU_TORCH_MOE_DISPATCH`` (default ``auto``): how a sparse-MoE
  MLP combines its experts when more token-choices arrive than there are
  experts (fewer always gather the chosen experts). ``auto`` runs the
  ragged dispatch (kernel B6) on the card and the dense one-hot combine on
  the CPU; ``ragged`` forces the ragged dispatch (on the CPU through B6's
  plain version); ``dense`` forces the dense combine (``moe_dispatch`` in
  the JAX package).
- ``BIGDL_TPU_TORCH_MATMUL_GEMV`` (default ``auto``): the body of the
  decode GEMV (B1, M <= 32), ``matmul_gemv`` of the JAX package.
  ``auto`` takes the ``mxu`` body on int4-layout weights and the standard
  body on the canonical packing; ``fold`` takes the scale-folded body on
  the canonical packing (non-asym) and ``mxu`` on the int4 layout;
  ``mxuflat`` the int4-layout body with a per-weight scale; ``mxu8``
  8-bit activations against int4-layout or sym_int8 weights (sym kinds);
  ``off`` sends M <= 32 to the dequant GEMM (B2). A value that names a
  body the weight cannot take picks the body the JAX package would pick.
  "mxu" names the int4 layout and the body that reads it, after the TPU's
  matrix unit; the H100 has no such unit, and the port's bodies run on its
  tensor cores.
- ``BIGDL_TPU_TORCH_PREPACK`` and ``BIGDL_TPU_TORCH_MXU_LAYOUT`` (default
  ``auto``; ``on``, ``off`` and the 1/true/0/false aliases): whether a
  loaded model's sym_int4 weights are relaid into the int4 layout
  (``ops/quant.prepack_tree``). ``auto`` prepacks when the parameters
  live on a CUDA device; either flag set to ``off`` disables the prepack,
  and either set to ``on`` forces it, on the CPU too (``prepack`` and
  ``mxu_layout`` of the JAX package).
"""

from __future__ import annotations

import dataclasses
import os

from bigdl_tpu_torch.ops.kvcache import resolve_kv_cache_dtype

# rows one dequant-GEMM launch takes (GEMM_MAX_M of ops/cuda/dequant_matmul)
MATMUL_MAX_M_CEILING = 128

_TRISTATE = ("auto", "on", "off")
MOE_DISPATCH_MODES = ("auto", "ragged", "dense")
MATMUL_GEMV_MODES = ("auto", "fold", "mxu", "mxuflat", "mxu8", "off")


def resolve_kv_page_size(spec) -> int:
    """0 disables paging, otherwise a power-of-two count of token
    positions per page."""
    try:
        n = int(str(spec).strip() or 0)
    except (TypeError, ValueError):
        raise ValueError(f"kv_page_size must be an integer, got {spec!r}")
    if n < 0 or (n and n & (n - 1)):
        raise ValueError(f"kv_page_size must be 0 (off) or a power of two, "
                         f"got {spec!r}")
    return n


def resolve_kv_pages(spec) -> int:
    """0 auto-sizes the arena, otherwise a total page count >= 2 (page 0
    is the pinned null page)."""
    try:
        n = int(str(spec).strip() or 0)
    except (TypeError, ValueError):
        raise ValueError(f"kv_pages must be an integer, got {spec!r}")
    if n < 0 or n == 1:
        raise ValueError(f"kv_pages must be 0 (auto) or >= 2 (page 0 is "
                         f"reserved), got {spec!r}")
    return n


def _tristate(spec, what: str) -> str:
    """"auto" | "on" | "off" (also 1/true/0/false)."""
    s = str(spec).strip().lower() if spec is not None else "auto"
    s = {"1": "on", "true": "on", "0": "off", "false": "off",
         "": "auto"}.get(s, s)
    if s not in _TRISTATE:
        raise ValueError(f"unknown {what} mode {spec!r}; choose from "
                         f"{_TRISTATE}")
    return s


def resolve_prefix_sharing(spec) -> str:
    """"auto" | "on" | "off" (also 1/true/0/false)."""
    return _tristate(spec, "prefix_sharing")


def resolve_prepack(spec) -> str:
    """"auto" | "on" | "off" (also 1/true/0/false): the load-time prepack
    of ``BIGDL_TPU_TORCH_PREPACK`` / ``_MXU_LAYOUT``."""
    return _tristate(spec, "prepack")


def resolve_decode_resident(spec) -> str:
    """Normalize a BIGDL_TPU_TORCH_DECODE_RESIDENT spec to "auto" | "on" |
    "off" (``resolve_decode_resident`` of the JAX package)."""
    s = str(spec).strip().lower() if spec is not None else "auto"
    s = {"1": "on", "true": "on", "0": "off", "false": "off",
         "": "auto"}.get(s, s)
    if s not in _TRISTATE:
        raise ValueError(
            f"unknown decode_resident mode {spec!r}; "
            f"choose from {_TRISTATE}")
    return s


def decode_resident_enabled() -> bool:
    """Effective resident-decode switch: "off" disables, "on"/"auto"
    enable (the per-step gate, penalties and logprob rows among it, lives
    at the call sites, which keep the eager step for host-side work)."""
    return flags().decode_resident != "off"


def resolve_matmul_gemv(spec) -> str:
    s = str(spec).strip().lower() if spec is not None else "auto"
    if s not in MATMUL_GEMV_MODES:
        raise ValueError(f"BIGDL_TPU_TORCH_MATMUL_GEMV must be one of "
                         f"{MATMUL_GEMV_MODES}, got {spec!r}")
    return s


@dataclasses.dataclass(frozen=True)
class Flags:
    matmul_max_m: int = MATMUL_MAX_M_CEILING
    attention_backend: str = "auto"
    kv_page_size: int = 0
    kv_pages: int = 0
    prefix_sharing: str = "auto"
    moe_dispatch: str = "auto"
    kv_cache_dtype: str = "bf16"
    matmul_gemv: str = "auto"
    prepack: str = "auto"
    mxu_layout: str = "auto"
    decode_resident: str = "auto"


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
    moe = os.environ.get("BIGDL_TPU_TORCH_MOE_DISPATCH", "auto")
    if moe not in MOE_DISPATCH_MODES:
        raise ValueError(f"BIGDL_TPU_TORCH_MOE_DISPATCH must be one of "
                         f"{MOE_DISPATCH_MODES}, got {moe!r}")
    env = os.environ.get
    return Flags(
        matmul_max_m=max_m, attention_backend=be,
        kv_page_size=resolve_kv_page_size(
            env("BIGDL_TPU_TORCH_KV_PAGE_SIZE", "0")),
        kv_pages=resolve_kv_pages(env("BIGDL_TPU_TORCH_KV_PAGES", "0")),
        prefix_sharing=resolve_prefix_sharing(
            env("BIGDL_TPU_TORCH_PREFIX_SHARING", "auto")),
        moe_dispatch=moe,
        kv_cache_dtype=resolve_kv_cache_dtype(
            env("BIGDL_TPU_TORCH_KV_CACHE_DTYPE", "bf16")),
        matmul_gemv=resolve_matmul_gemv(
            env("BIGDL_TPU_TORCH_MATMUL_GEMV", "auto")),
        prepack=resolve_prepack(env("BIGDL_TPU_TORCH_PREPACK", "auto")),
        mxu_layout=_tristate(env("BIGDL_TPU_TORCH_MXU_LAYOUT", "auto"),
                             "mxu_layout"),
        decode_resident=resolve_decode_resident(
            env("BIGDL_TPU_TORCH_DECODE_RESIDENT", "auto")))
