"""Dequant-matmul kernels B1 (decode GEMV, M <= 32) and B2 (tiled GEMM,
32 < M <= 128) over block-quantized weights, each body beside its plain
version.

Counterpart of ``bigdl_tpu/ops/pallas/dequant_matmul.py``
(``_q_gemv_pallas`` and ``_q_matmul_generic``). Each Pallas body is a
CUDA body, B1's on the small-M body of ``csrc/dequant_smallm.cuh`` (*),
B2's on the Hopper GEMM body of ``csrc/dequant_wgmma.cuh`` (**), counting
its launches under its own name:

========================  ==========================  ===================
launch counter            Pallas body                 source
========================  ==========================  ===================
``dequant_gemv``          B1 ``_gemv_kernel``         dequant_gemv.cu (*)
``dequant_gemv_mxu``      B1 ``_gemv_kernel_mxu``     dequant_variants.cu
                                                      (*)
``dequant_gemv_fold``     B1 ``_gemv_kernel_fold``    dequant_variants.cu
                                                      (*)
``dequant_gemv_mxuflat``  B1 ``_gemv_kernel_mxuflat`` dequant_variants.cu
                                                      (*)
``dequant_gemv_mxu8``     B1 ``_gemv_kernel_mxu8``    dequant_variants.cu
                                                      (*)
``dequant_gemm``          B2 ``_kernel_4bit/_int8``   dequant_gemm.cu (**)
``dequant_gemm_i4``       B2 ``_kernel_i4``           dequant_gemm.cu (**)
========================  ==========================  ===================

(*) The small-M body makes the weights the mma A operand and x the B
operand in n8 tiles of tokens; a block is 4 warps on one strip of 32 * cw
columns, and a K split is summed in split order by the strip's last block
in the same launch (a ticket a strip and the f32 partials, from buffers
that live for the process). One launch a call, no host sync. mxu8
quantizes x inside that launch.

(**) The Hopper body makes the weights wgmma's A operand (from registers)
and x its B operand (from shared memory, by TMA), ``wgmma_tokens(M)``
tokens a wgmma; a block is two consumer warpgroups on one strip of
``WGMMA_COLS`` columns and a producer warp, and a K split is summed as on
the small-M body. B2's std and i4 bodies are one entry point, the weight
kind picking the decode. ``plane_loads`` says which operands arrive by TMA
and which by ``cp.async``.

The std bodies (``dequant_gemv``, ``dequant_gemm``), ``mxuflat`` and
``i4`` dequantize every weight in f32 (code times block scale, plus block
zero for asym) and round it once to bf16, round x to bf16 and sum in f32:
their plain version is ``plain_q_matmul``. ``mxu`` and ``fold`` feed the
raw codes (exact in bf16; a codebook value rounded to bf16) to the product
and scale each block's f32 partial once: ``plain_q_matmul_fused`` (mxu),
the port of ``_q_matmul_xla_fused``, and ``plain_q_matmul_fold``, which
also takes the codebooks that one refuses (fp4, nf3). ``mxu8`` quantizes
x to int8 per 32-K block, takes exact integer block products and scales
them in f32:
``plain_q_matmul_q8``, whose quantization ``quantize_x_q8`` runs on the
CPU only (the kernel quantizes x itself). The int4-layout bodies (mxu,
mxuflat, mxu8, i4) take only a prepacked sym_int4 weight
(``ops/quant.to_mxu_layout``), the others only the canonical packing. The kernels read the packed planes
directly and never materialize the dense weight.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from bigdl_tpu_torch import _native
from bigdl_tpu_torch.config import MATMUL_MAX_M_CEILING
from bigdl_tpu_torch.ops.codebooks import padded_lut
from bigdl_tpu_torch.ops.cuda import LAUNCHES
from bigdl_tpu_torch.ops.quant import (QTensor, _unpack4, dequantize,
                                       get_qtype, unpack_int4_rows)

# decode-GEMV row ceiling (the engine's decode batch and short prefills)
GEMV_MAX_M = 32
# rows of one dequant-GEMM launch
GEMM_MAX_M = MATMUL_MAX_M_CEILING
# K rows per staged chunk (kChunk in csrc/dequant_smallm.cuh)
_CHUNK = 64
# qtypes the kernels take (all six ported formats)
KERNEL_QTYPES = frozenset(
    {"sym_int4", "asym_int4", "nf4", "fp4", "nf3", "sym_int8"})
_KIND = {"sym": 0, "asym": 1, "codebook": 2}
_KIND_SYM8 = 3
_KIND_I4 = 5                       # the int4 layout (KIND_I4 in csrc)
# quantized kinds whose product folds the block scale out (as
# ``_FUSED_XLA_QTYPES`` of the JAX package)
FUSED_QTYPES = frozenset({"sym_int4", "asym_int4", "nf4", "sym_int8"})
Q8_BLOCK = 32                      # the activation block of mxu8

# the bodies of B1 and B2 by name -> their launch counters; counter -> the
# body id that csrc/dequant_variants.cu's entry point takes
_GEMV = {"std": "dequant_gemv", "mxu": "dequant_gemv_mxu",
         "fold": "dequant_gemv_fold", "mxuflat": "dequant_gemv_mxuflat",
         "mxu8": "dequant_gemv_mxu8"}
_GEMM = {"std": "dequant_gemm", "i4": "dequant_gemm_i4"}
_VARIANT_BODY = {"dequant_gemv_mxu": 0, "dequant_gemv_fold": 1,
                 "dequant_gemv_mxuflat": 2, "dequant_gemv_mxu8": 3}

# geometry names on the small-M body (dequant_smallm.cuh): every body of
# B1 and B6's small-M entry (ops/cuda/moe_dispatch.py)
_SMALLM = frozenset(set(_GEMV.values()) | {"moe_dispatch_smallm"})
# geometry names on the Hopper GEMM body (dequant_wgmma.cuh): B2's two
# bodies and B6's tiles entry (ops/cuda/moe_dispatch.py)
_WGMMA = frozenset({"dequant_gemm", "dequant_gemm_i4", "moe_dispatch"})
# output columns a block of the Hopper body computes (two warpgroups, two
# 64-column tiles each)
WGMMA_COLS = 256
# the Hopper body's K split: at most this many splits, at least this many
# 64-row chunks a split (wgmma_split)
WGMMA_MAX_SPLIT = 5
WGMMA_MIN_CHUNKS = 12
# the tickets a device's buffer holds at first (grown on demand)
_TICKETS_MIN = 4096

_luts: Dict[Tuple[str, int], torch.Tensor] = {}
_sms: Dict[int, int] = {}
_occupancy: Dict[tuple, int] = {}
_tickets: Dict[Tuple[str, int], torch.Tensor] = {}
_workspaces: Dict[Tuple[str, int], torch.Tensor] = {}


def plain_q_matmul(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """x [M, K] @ dequantize(W) -> [M, N] bf16: the weight dequantized to
    bf16, x rounded to bf16, the product summed in f32 (the plain form of
    ``_q_matmul_xla``)."""
    dense = dequantize(w, torch.bfloat16)
    y = torch.matmul(x.to(torch.bfloat16).to(torch.float32),
                     dense.to(torch.float32))
    return y.to(torch.bfloat16)


def _block_products(x: torch.Tensor, w: QTensor):
    """(x [r, M, B], part [r, M, N]): x as f32 of its bf16 values, cut into
    the r quant blocks of K (zero-padded to Kp), and each block's product
    with the raw codes as bf16 (int4-layout and int8 codes as they are,
    split-block codes minus 8 or, asym, as they are, a codebook value from
    ``padded_lut`` rounded to bf16), summed in f32."""
    qt = w.qt
    b, (k, n), kp = qt.block_size, w.shape, w.kp
    x2 = x.reshape(-1, k).to(torch.bfloat16).to(torch.float32)
    if kp != k:
        x2 = torch.nn.functional.pad(x2, (0, kp - k))
    m, rows = x2.shape[0], kp // b
    x3 = x2.reshape(m, rows, b).transpose(0, 1)              # [r, M, B]
    if w.is_int4:
        cb = unpack_int4_rows(w.data).to(torch.float32)
    elif qt.storage_bits == 8:
        cb = w.data.to(torch.float32)
    else:
        codes = _unpack4(w.data, b)
        if qt.kind == "codebook":
            lut = torch.from_numpy(padded_lut(qt.codebook)).to(codes.device)
            cb = lut.to(torch.bfloat16)[codes.long()].to(torch.float32)
        elif qt.kind == "sym":
            cb = codes.to(torch.float32) - 8.0
        else:                                                # asym
            cb = codes.to(torch.float32)
    return x3, torch.bmm(x3, cb.reshape(rows, b, n))


def plain_q_matmul_fused(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """x [M, K] @ W -> [M, N] bf16 with the scales folded out of the
    product (the port of ``_q_matmul_xla_fused``): ``_block_products``,
    times the f32 scale, summed over blocks, plus the asym zero term. The
    plain version of the mxu body."""
    qt = w.qt
    if qt.name not in FUSED_QTYPES:
        raise NotImplementedError(
            f"fused matmul does not support {w.qtype}")
    x3, part = _block_products(x, w)
    y = (part * w.scale.to(torch.float32)[:, None, :]).sum(dim=0)
    if qt.kind == "asym":
        xsum = x3.sum(dim=2).t()                             # [M, r]
        y = y + torch.matmul(xsum, w.zero.to(torch.float32))
    return y.to(torch.bfloat16)


def plain_q_matmul_fold(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """x [M, K] @ W -> [M, N] bf16 as ``_gemv_kernel_fold`` computes it, for
    every weight the fold body takes (sym_int4, nf4, fp4, nf3 and sym_int8
    in the canonical packing): ``_block_products``, times the f32 block
    scale, summed over blocks. The plain version of the fold body."""
    _check_body("fold", w)
    _, part = _block_products(x, w)
    y = (part * w.scale.to(torch.float32)[:, None, :]).sum(dim=0)
    return y.to(torch.bfloat16)


def quantize_x_q8(x2: torch.Tensor):
    """x [M, Kp] (Kp a multiple of 32) -> (xq int8 [M, Kp], sx f32
    [M, Kp / 32]): the mxu8 activation codes, the JAX package's expression
    (``_q_gemv_pallas``, L532-537): the f32 amax of each 32-block of the
    bf16 x, sx = amax * (1 / 127), inv = 1 / sx (0 where sx is 0), codes
    round(x * inv), half to even."""
    m, kp = x2.shape
    xf = x2.to(torch.bfloat16).to(torch.float32).reshape(m, kp // Q8_BLOCK,
                                                           Q8_BLOCK)
    sx = xf.abs().amax(dim=-1) * (1.0 / 127.0)   # an f32 constant, as JAX's
    inv = torch.where(sx == 0, 0.0, 1.0 / sx)
    xq = torch.round(xf * inv[..., None]).to(torch.int8)
    return xq.reshape(m, kp), sx


def plain_q_matmul_q8(x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """x [M, K] @ W -> [M, N] bf16 with 8-bit activations: the plain
    version of the mxu8 body. x is quantized by ``quantize_x_q8``; each
    block's product of int8 codes is an exact integer (|sum| < 2^24, so
    exact in f32 too), then times s[r, n] and sx[m, r] in f32, summed over
    blocks."""
    _check_body("mxu8", w)
    k, n = w.shape
    kp = w.kp
    x2 = x.reshape(-1, k).to(torch.bfloat16)
    if kp != k:
        x2 = torch.nn.functional.pad(x2, (0, kp - k))
    m, rows = x2.shape[0], kp // Q8_BLOCK
    xq, sx = quantize_x_q8(x2)
    cb = (unpack_int4_rows(w.data) if w.is_int4 else w.data).to(
        torch.float32).reshape(rows, Q8_BLOCK, n)
    part = torch.bmm(xq.to(torch.float32).reshape(m, rows, Q8_BLOCK)
                     .transpose(0, 1), cb)                   # [r, M, N]
    scaled = part * w.scale.to(torch.float32)[:, None, :]
    y = (scaled * sx.t()[:, :, None]).sum(dim=0)
    return y.to(torch.bfloat16)


_PLAIN = {"std": plain_q_matmul, "mxu": plain_q_matmul_fused,
          "fold": plain_q_matmul_fold, "mxuflat": plain_q_matmul,
          "mxu8": plain_q_matmul_q8, "i4": plain_q_matmul}


def _check_body(body: str, w: QTensor) -> None:
    """Raise unless `body` reads this weight's layout and qtype."""
    qt = w.qt
    if body in ("mxu", "mxuflat", "i4"):
        ok = w.is_int4
    elif body == "mxu8":
        ok = w.is_int4 or (qt.storage_bits == 8 and qt.kind == "sym")
    elif body == "fold":
        ok = not w.is_int4 and qt.kind != "asym"
    else:
        ok = not w.is_int4
    if not ok:
        raise ValueError(f"body {body!r} does not take a {w.qtype} weight "
                         f"in the {w.layout} layout")


def pick_gemv_body(mode: str, w: QTensor) -> str:
    """The decode-GEMV body for a ``matmul_gemv`` mode and a weight, as
    ``q_matmul_pallas_impl`` picks it: a mode naming a body the weight
    cannot take picks the JAX package's choice."""
    qt = w.qt
    if mode == "mxu8" and (w.is_int4 or qt.storage_bits == 8) \
            and qt.kind == "sym":
        return "mxu8"
    if mode == "mxuflat" and w.is_int4:
        return "mxuflat"
    if mode in ("auto", "mxu", "fold") and w.is_int4:
        return "mxu"
    if mode == "fold" and qt.kind != "asym":
        return "fold"
    return "std"


def _kind(w: QTensor) -> int:
    qt = w.qt
    if w.is_int4:
        return _KIND_I4
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
    cw = _cw(name, w.n, x.shape[0])
    if w.data.data_ptr() % min(16, 4 * cw) or \
            w.scale.data_ptr() % min(16, 8 * cw) or (
            w.zero is not None and w.zero.data_ptr() % min(16, 8 * cw)):
        raise ValueError(f"{name}: weight planes are not aligned for "
                         "vector loads")
    x = x.to(torch.bfloat16)
    if kp != w.k:
        x = torch.nn.functional.pad(x, (0, kp - w.k))
    x = x.contiguous()
    if x.data_ptr() % 16:                    # staged with 16-byte loads
        x = x.clone()
    return x


def _cw(name: str, n: int, m: int = 1) -> int:
    """32-bit words (4 columns each) a thread loads per packed row. The
    small-M body: 4 (16-byte loads) at M <= 16 and 2 above (its f32 sums
    grow with the n8 tiles of tokens) where the row allows them, else 1.
    Else (the Hopper body) 1."""
    if name in _SMALLM:
        if m <= 16:
            return 4 if n % 16 == 0 else 1
        return 2 if n % 8 == 0 else 1
    return 1


def _block_cols(name: str, cw: int) -> int:
    """Output columns one block computes: a strip of 32 * cw on the
    small-M body (its 4 warps split the strip's K), ``WGMMA_COLS`` on the
    Hopper body."""
    return WGMMA_COLS if name in _WGMMA else 32 * cw


def wgmma_tokens(m: int) -> int:
    """Tokens one wgmma of the Hopper body multiplies for M rows (B6: a
    tile's real rows): its two variants, 64 at M <= 64, else 128."""
    return 64 if m <= 64 else 128


def wgmma_strips(n: int) -> int:
    """Column strips (blocks a K split and token tile) of the Hopper body
    over N output columns; also the split-K tickets one tile takes."""
    return -(-n // WGMMA_COLS)


def plane_loads(n: int, qtype: str, addresses=()) -> Dict[str, str]:
    """How the Hopper body loads each operand of a launch, ``"tma"`` or
    ``"cp.async"``: x always by TMA; the code, scale (and asym zero)
    planes by TMA when N % 16 == 0 and every address in `addresses` (the
    planes' pointers, and B6's expert strides in bytes) is 16-byte
    aligned, else all by 4-byte ``cp.async`` (what
    ``dqwg::planes_tma_ok`` in csrc/dequant_wgmma.cuh asks)."""
    way = "tma" if n % 16 == 0 and all(a % 16 == 0 for a in addresses) \
        else "cp.async"
    loads = {"x": "tma", "codes": way, "scale": way}
    if get_qtype(qtype).kind == "asym":
        loads["zero"] = way
    return loads


def wgmma_split(blocks: int, slots: int, chunks: int) -> int:
    """The Hopper body's K split: as many splits as keep every block of
    the launch resident at once (one wave of `slots`), at most
    ``WGMMA_MAX_SPLIT`` and at least ``WGMMA_MIN_CHUNKS`` chunks a split,
    and none once the strips alone fill the card. A split costs its f32
    partials' round trip, which the last block of a strip sums alone, and
    the body's blocks run no faster for a short K, so unlike the small-M
    body it never trades a wave for a split (tools/bench_gemm.py sweeps the
    splits)."""
    return max(1, min(chunks // WGMMA_MIN_CHUNKS, slots // max(1, blocks),
                      WGMMA_MAX_SPLIT))


def wgmma_workspace(split: int, rows: int, n: int):
    """Shape of the f32 split-K workspace of a Hopper-body launch over
    `rows` rows of y (B6: the token buffer's Np), or None with one split."""
    return (split, rows, n) if split > 1 else None


def smallm_rows(m: int) -> int:
    """Token rows the small-M body stages for M rows: 1, 2 or 4 n8 tiles
    (its variants, dequant_smallm.cuh)."""
    return 8 if m <= 8 else 16 if m <= 16 else 32


def _occupancy_query(name: str):
    """(m, kind, cw) -> resident blocks per SM of the variant a launch of
    counter (or geometry) `name` takes."""
    if name in ("dequant_gemm", "dequant_gemm_i4"):
        q = _native.kernel("dequant_gemm", "bigdl_dequant_gemm_blocks_per_sm")
        return lambda m, kind, cw: q(m, kind)
    if name == "moe_dispatch":
        q = _native.kernel("moe_dispatch", "bigdl_moe_dispatch_blocks_per_sm")
        return lambda m, kind, cw: q(kind)
    if name in _VARIANT_BODY:
        q = _native.kernel("dequant_variants",
                           "bigdl_dequant_variant_blocks_per_sm")
        body = _VARIANT_BODY[name]
        return lambda m, kind, cw: q(body, m, kind, cw)
    if name == "moe_dispatch_smallm":
        return _native.kernel("moe_dispatch",
                              "bigdl_moe_dispatch_smallm_blocks_per_sm")
    return _native.kernel(name, f"bigdl_{name}_blocks_per_sm")


def _split_k(name: str, m: int, n: int, kp: int, kind: int, cw: int,
             device, tiles: int = 1) -> Tuple[int, int]:
    """(split, chunks per split): cut K (in 64-row chunks) into splits
    for the launch's blocks (``tiles`` row tiles of column strips), with
    no empty split. The small-M body takes ``_balanced_split``, the Hopper
    body ``wgmma_split``."""
    smallm = name in _SMALLM
    tier = smallm_rows(m) if smallm else wgmma_tokens(m)      # variants
    key = (name, tier, kind, cw, device.index)
    occ = _occupancy.get(key)
    if occ is None:
        occ = _occupancy_query(name)(m, kind, cw)
        if occ <= 0:
            raise RuntimeError(f"{name}: occupancy query failed")
        _occupancy[key] = occ
    chunks = -(-kp // _CHUNK)
    blocks = tiles * -(-n // _block_cols(name, cw))
    slots = occ * _sm_count(device)
    split = (_balanced_split if smallm else wgmma_split)(blocks, slots,
                                                         chunks)
    per = -(-chunks // split)
    return -(-chunks // per), per


def _balanced_split(blocks: int, slots: int, chunks: int) -> int:
    """The K split that minimizes the waves of `slots` resident blocks a
    launch takes for each split (its time, where each block's work shrinks
    with the split), the fewest splits within 5% of the least; at most 16
    splits and 8 chunks (two a warp) a split. The small-M body sums a
    split in the same launch, so a split costs little, while a short last
    wave leaves SMs idle (tools/bench_smallm.py times the splits)."""
    top = max(1, min(16, chunks // 8))
    cost = {s: -(-blocks * s // slots) / s for s in range(1, top + 1)}
    least = min(cost.values())
    return min(s for s, c in cost.items() if c <= 1.05 * least)


def ticket_buffer(device: torch.device, count: int) -> torch.Tensor:
    """int32 zeros, at least `count` of them, on `device`: the small-M
    body's split-K tickets, one a column strip (and token tile). Allocated
    once a device and grown on demand; every launch leaves its tickets at
    zero. The buffer serves launches on one stream at a time."""
    key = (device.type, device.index)
    buf = _tickets.get(key)
    if buf is None or buf.numel() < count:
        _no_growth_in_capture("ticket_buffer")
        buf = torch.zeros(max(count, _TICKETS_MIN), dtype=torch.int32,
                          device=device)
        _tickets[key] = buf
    return buf


def workspace_buffer(device: torch.device, count: int) -> torch.Tensor:
    """f32, at least `count` of them, on `device`: the split-K partials of
    B1's launches. Allocated once a device and grown on demand, so a call
    allocates nothing; like the tickets, the buffer serves launches on one
    stream at a time (each launch's partials are read before the next
    launch on that stream writes them)."""
    key = (device.type, device.index)
    buf = _workspaces.get(key)
    if buf is None or buf.numel() < count:
        _no_growth_in_capture("workspace_buffer")
        buf = torch.empty(count, dtype=torch.float32, device=device)
        _workspaces[key] = buf
    return buf


def _no_growth_in_capture(what: str) -> None:
    """A scratch buffer grows only outside a CUDA graph capture: one made
    inside would come from the graph's private pool and outlive it here.
    A capture runs its step once eagerly first, which sizes the buffers."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        raise RuntimeError(f"{what} would grow inside a CUDA graph capture; "
                           "run the captured step once before capturing it")


def scratch_buffers(device: torch.device) -> List[torch.Tensor]:
    """The device's ticket and workspace buffers as they are now. A graph
    that captured launches through them keeps this list: a later, larger
    call replaces a buffer in the tables here, and the graph's reference
    keeps the old one alive for its replays."""
    key = (device.type, device.index)
    return [b for b in (_tickets.get(key), _workspaces.get(key))
            if b is not None]


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch(name: str, x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """B1 through the body counted as `name` (a value of ``_GEMV``)."""
    x2 = _prepare(x, w, name)
    m, kp = x2.shape
    n = w.n
    kind = _kind(w)
    cw = _cw(name, n, m)
    split, per = _split_k(name, m, n, kp, kind, cw, x2.device)
    # a K split's partials in the device's workspace, summed in the same
    # launch, one ticket a strip
    wsp = tickets = None
    if split > 1:
        wsp = workspace_buffer(x2.device, split * m * n).data_ptr()
        tickets = ticket_buffer(
            x2.device, -(-n // _block_cols(name, cw))).data_ptr()
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
    stream = _stream(x2.device)
    if name in _VARIANT_BODY:
        err = _native.kernel("dequant_variants")(
            _VARIANT_BODY[name], x2.data_ptr(), w.data.data_ptr(),
            w.scale.data_ptr(), _lut_ptr(w, x2.device), wsp, tickets,
            y.data_ptr(), m, kp, n, w.qt.block_size, kind, split, per, cw,
            stream)
    else:                                  # dequant_gemv
        err = _native.kernel(name)(
            x2.data_ptr(), w.data.data_ptr(), w.scale.data_ptr(),
            None if w.zero is None else w.zero.data_ptr(),
            _lut_ptr(w, x2.device), wsp, tickets, y.data_ptr(), m, kp, n,
            w.qt.block_size, kind, split, per, cw, stream)
    _native.check(name, err)
    LAUNCHES[name] += 1
    return y


def _launch_gemm(name: str, x: torch.Tensor, w: QTensor) -> torch.Tensor:
    """B2 (std or i4, by the weight's layout) on the Hopper body: one
    native call, its K split summed in the same launch."""
    x2 = _prepare(x, w, name)
    m, kp = x2.shape
    n = w.n
    kind = _kind(w)
    split, per = _split_k(name, m, n, kp, kind, 1, x2.device)
    planes = [w.data, w.scale] + ([] if w.zero is None else [w.zero])
    tma = plane_loads(n, w.qtype, [p.data_ptr() for p in planes])[
        "codes"] == "tma"
    shape = wgmma_workspace(split, m, n)
    # the workspace lives to the launch (the allocator may hand a freed
    # block to y)
    ws = tickets = None
    if shape is not None:
        ws = torch.empty(shape, dtype=torch.float32, device=x2.device)
        tickets = ticket_buffer(x2.device, wgmma_strips(n)).data_ptr()
    y = torch.empty((m, n), dtype=torch.bfloat16, device=x2.device)
    err = _native.kernel("dequant_gemm")(
        x2.data_ptr(), w.data.data_ptr(), w.scale.data_ptr(),
        None if w.zero is None else w.zero.data_ptr(),
        _lut_ptr(w, x2.device), None if ws is None else ws.data_ptr(),
        tickets, y.data_ptr(), m, kp, n,
        w.qt.block_size, kind, split, per, int(tma), _stream(x2.device))
    _native.check(name, err)
    LAUNCHES[name] += 1
    return y


def dequant_gemv(x: torch.Tensor, w: QTensor, body: str = "std"
                 ) -> torch.Tensor:
    """B1: x [M <= 32, K] @ W [K, N] -> bf16 [M, N] through `body`
    (std, mxu, fold, mxuflat or mxu8; see the module docstring)."""
    if body not in _GEMV:
        raise ValueError(f"dequant_gemv: unknown body {body!r}")
    _check_body(body, w)
    if x.device.type == "cpu":
        return _PLAIN[body](x, w)
    if not 1 <= x.shape[0] <= GEMV_MAX_M:
        raise ValueError(f"dequant_gemv: M={x.shape[0]} outside "
                         f"[1, {GEMV_MAX_M}]")
    return _launch(_GEMV[body], x, w)


def dequant_gemm(x: torch.Tensor, w: QTensor, body: str = "std"
                 ) -> torch.Tensor:
    """B2: x [M <= 128, K] @ W [K, N] -> bf16 [M, N] (the engine sends it
    32 < M <= 128) through `body` (std, or i4 for the int4 layout)."""
    if body not in _GEMM:
        raise ValueError(f"dequant_gemm: unknown body {body!r}")
    _check_body(body, w)
    if x.device.type == "cpu":
        return _PLAIN[body](x, w)
    if not 1 <= x.shape[0] <= GEMM_MAX_M:
        raise ValueError(f"dequant_gemm: M={x.shape[0]} outside "
                         f"[1, {GEMM_MAX_M}]")
    return _launch_gemm(_GEMM[body], x, w)
