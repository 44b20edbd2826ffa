"""Dequant-matmul kernels B1 (decode GEMV, M <= 32) and B2 (tiled GEMM,
32 < M <= 128) over block-quantized weights, with their plain version.

Counterpart of ``bigdl_tpu/ops/pallas/dequant_matmul.py``
(``_q_gemv_pallas`` and ``_q_matmul_generic``). Sources:
``csrc/dequant_gemv.cu`` and ``csrc/dequant_gemm.cu``, two tilings of the
tensor-core dequant matmul in ``csrc/dequant_mma.cuh``.

Both kernels compute what the plain version computes: every weight is
dequantized in f32 (code times block scale, plus block zero for asym) and
rounded once to bf16, x is rounded to bf16, and the product accumulates in
f32; the output is bf16. The kernels read the packed planes directly and
never materialize the dense weight.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from bigdl_tpu_torch import _native
from bigdl_tpu_torch.config import MATMUL_MAX_M_CEILING
from bigdl_tpu_torch.ops.codebooks import padded_lut
from bigdl_tpu_torch.ops.cuda import LAUNCHES
from bigdl_tpu_torch.ops.quant import QTensor, dequantize

# decode-GEMV row ceiling (the engine's decode batch and short prefills)
GEMV_MAX_M = 32
# rows of one dequant-GEMM launch
GEMM_MAX_M = MATMUL_MAX_M_CEILING
# K rows per staged chunk and warps per block (kChunk, kWarps in
# csrc/dequant_mma.cuh)
_CHUNK = 64
_WARPS = 4
# qtypes the kernels take (all six ported formats)
KERNEL_QTYPES = frozenset(
    {"sym_int4", "asym_int4", "nf4", "fp4", "nf3", "sym_int8"})
_KIND = {"sym": 0, "asym": 1, "codebook": 2}
_KIND_SYM8 = 3

_luts: Dict[Tuple[str, int], torch.Tensor] = {}
_sms: Dict[int, int] = {}
_occupancy: Dict[tuple, int] = {}


def plain_q_matmul(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """x [M, K] @ dequantize(W) -> [M, N] bf16: the weight dequantized to
    bf16, x rounded to bf16, the product summed in f32 (the plain form of
    ``_q_matmul_xla``)."""
    dense = dequantize(w, torch.bfloat16)
    y = torch.matmul(x.to(torch.bfloat16).to(torch.float32),
                     dense.to(torch.float32))
    return y.to(torch.bfloat16)


def _kind(w: QTensor) -> int:
    qt = w.qt
    if qt.storage_bits == 8:
        return _KIND_SYM8
    return _KIND[qt.kind]


def _lut_ptr(w: QTensor, device: torch.device):
    qt = w.qt
    if qt.kind != "codebook":
        return None
    key = (qt.codebook, device.index)
    lut = _luts.get(key)
    if lut is None:
        lut = torch.from_numpy(padded_lut(qt.codebook)).to(device)
        _luts[key] = lut
    return lut.data_ptr()


def _sm_count(device: torch.device) -> int:
    n = _sms.get(device.index)
    if n is None:
        n = torch.cuda.get_device_properties(device).multi_processor_count
        _sms[device.index] = n
    return n


def _prepare(x: torch.Tensor, w: QTensor, name: str) -> torch.Tensor:
    """Validate a kernel call and return x as contiguous bf16 [M, Kp],
    zero-padded past the logical K."""
    if not x.is_cuda:
        raise ValueError(f"{name}: x must be a CUDA or CPU tensor, got "
                         f"{x.device}")
    if w.qt.name not in KERNEL_QTYPES:        # aliases resolve to their qtype
        raise ValueError(f"{name}: no kernel for qtype {w.qtype}")
    if x.dim() != 2 or x.shape[1] != w.k:
        raise ValueError(f"{name}: x must be [M, {w.k}], got "
                         f"{tuple(x.shape)}")
    if x.dtype not in (torch.bfloat16, torch.float16, torch.float32):
        raise ValueError(f"{name}: x must be floating, got {x.dtype}")
    qt = w.qt
    kp = w.kp
    want_data = (kp if qt.storage_bits == 8 else kp // 2, w.n)
    planes = [("data", w.data), ("scale", w.scale)]
    if qt.kind == "asym":
        if w.zero is None:
            raise ValueError(f"{name}: asym weight without a zero plane")
        planes.append(("zero", w.zero))
    for pname, t in planes:
        if t.device != x.device:
            raise ValueError(f"{name}: {pname} on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {pname} plane must be contiguous")
    if tuple(w.data.shape) != want_data:
        raise ValueError(f"{name}: data plane {tuple(w.data.shape)} != "
                         f"{want_data}")
    if w.data.dtype != (torch.int8 if qt.storage_bits == 8 else torch.uint8):
        raise ValueError(f"{name}: data dtype {w.data.dtype} for {w.qtype}")
    if w.scale.dtype != torch.bfloat16 or (
            w.zero is not None and w.zero.dtype != torch.bfloat16):
        raise ValueError(f"{name}: scale/zero planes must be bfloat16")
    if w.n % 4:
        raise ValueError(f"{name}: N={w.n} must be a multiple of 4")
    if _CHUNK % qt.block_size or qt.block_size % 32:
        raise ValueError(f"{name}: block size {qt.block_size} must divide "
                         f"{_CHUNK} and be a multiple of 32")
    if w.data.data_ptr() % 4 or w.scale.data_ptr() % 8 or (
            w.zero is not None and w.zero.data_ptr() % 8):
        raise ValueError(f"{name}: weight planes are not aligned for "
                         "vector loads")
    x = x.to(torch.bfloat16)
    if kp != w.k:
        x = torch.nn.functional.pad(x, (0, kp - w.k))
    x = x.contiguous()
    if x.data_ptr() % 16:                    # staged with 16-byte loads
        x = x.clone()
    return x


def _cw(name: str, n: int) -> int:
    """32-bit words (4 columns each) a thread loads per packed row: 16-byte
    loads for B1 where the row allows them."""
    return 4 if name == "dequant_gemv" and n % 16 == 0 else 1


def _split_k(name: str, m: int, n: int, kp: int, kind: int, cw: int,
             device, tiles: int = 1) -> Tuple[int, int]:
    """(split, chunks per split): cut K (in 64-row chunks) into as many
    splits as keep every block of the launch (``tiles`` row tiles of
    column strips) resident at once (one wave), with no empty split."""
    tier = (m <= 16) if name == "dequant_gemv" else (m <= 64)  # m-tiles
    key = (name, tier, kind, cw, device.index)
    occ = _occupancy.get(key)
    if occ is None:
        occ = _native.kernel(name, f"bigdl_{name}_blocks_per_sm")(m, kind, cw)
        if occ <= 0:
            raise RuntimeError(f"{name}: occupancy query failed")
        _occupancy[key] = occ
    chunks = -(-kp // _CHUNK)
    blocks = tiles * -(-n // (_WARPS * 32 * cw))
    split = max(1, min(chunks, occ * _sm_count(device) // blocks))
    per = -(-chunks // split)
    return -(-chunks // per), per


def _launch(name: str, x: torch.Tensor, w: QTensor) -> torch.Tensor:
    x2 = _prepare(x, w, name)
    m, kp = x2.shape
    n = w.n
    kind = _kind(w)
    cw = _cw(name, n)
    split, per = _split_k(name, m, n, kp, kind, cw, x2.device)
    ws = (torch.empty((split, m, n), dtype=torch.float32, device=x2.device)
          if split > 1 else None)
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
    err = _native.kernel(name)(
        x2.data_ptr(), w.data.data_ptr(), w.scale.data_ptr(),
        None if w.zero is None else w.zero.data_ptr(),
        _lut_ptr(w, x2.device), None if ws is None else ws.data_ptr(),
        y.data_ptr(), m, kp, n, w.qt.block_size, kind, split, per, cw,
        torch.cuda.current_stream(x2.device).cuda_stream)
    _native.check(name, err)
    LAUNCHES[name] += 1
    return y


def dequant_gemv(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """B1: x [M <= 32, K] @ W [K, N] -> bf16 [M, N]."""
    if x.device.type == "cpu":
        return plain_q_matmul(x, w)
    if not 1 <= x.shape[0] <= GEMV_MAX_M:
        raise ValueError(f"dequant_gemv: M={x.shape[0]} outside "
                         f"[1, {GEMV_MAX_M}]")
    return _launch("dequant_gemv", x, w)


def dequant_gemm(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """B2: x [M <= 128, K] @ W [K, N] -> bf16 [M, N] (the engine sends it
    32 < M <= 128)."""
    if x.device.type == "cpu":
        return plain_q_matmul(x, w)
    if not 1 <= x.shape[0] <= GEMM_MAX_M:
        raise ValueError(f"dequant_gemm: M={x.shape[0]} outside "
                         f"[1, {GEMM_MAX_M}]")
    return _launch("dequant_gemm", x, w)
