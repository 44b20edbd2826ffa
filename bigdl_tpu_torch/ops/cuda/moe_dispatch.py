"""Ragged expert matmul, kernel B6, with its plain version.

Counterpart of ``bigdl_tpu/ops/pallas/moe_dispatch.py::ragged_expert_matmul``
(its quantized and dense bf16 bodies). Source: ``csrc/moe_dispatch.cu``.
Tiles run B2's Hopper body (``csrc/dequant_wgmma.cuh``, wgmma fed by TMA)
with a per-tile weight address, 64 or 128 tokens a tile from its real
rows; a dense bf16 stack's boxes reach wgmma as they are (its A operand
from shared memory). Decode tiles take a second entry on B1's small-M body
(``csrc/dequant_smallm.cuh``): the caller passes ``max_tile_rows``, a
bound on the real rows of any tile known on the host without reading the
device (``moe_mlp_ragged``: the token-choice count ``N * k``, at most a
tile); at most ``SMALLM_MAX_ROWS`` it takes the small-M entry, over a
quantized or a dense stack, else the tiles entry. Both entries count a
dense stack's launches as ``ragged_expert_matmul_dense``.

x [Np, K] is a token buffer sorted by expert and padded so that every
``TOKEN_TILE``-row tile holds the rows of one expert; tile i is multiplied
by the weight of expert ``tile_expert[i]`` of an ``[E, K, N]`` stack. Both
the kernel and the plain version dequantize every weight in f32 and round
it once to bf16, round x to bf16, and sum the products in f32; the output
is bf16 [Np, N].

``tile_rows`` (int32 [Np / TOKEN_TILE]) tells the kernel how many leading
rows of each tile are real; it multiplies 64 rows of a tile that holds at
most 64 (the small-M entry: its staged 8, 16 or 32) and writes zeros past
them. The caller guarantees that those rows of x are zeros,
so the result is x's product all the same; the plain version computes
every row.
"""

from __future__ import annotations

from typing import Optional, Tuple, Union

import torch

from bigdl_tpu_torch import _native
from bigdl_tpu_torch.ops.cuda import LAUNCHES
from bigdl_tpu_torch.ops.cuda.dequant_matmul import (_block_cols, _cw,
                                                     _kind, _lut_ptr,
                                                     _prepare, _split_k,
                                                     _stream, plane_loads,
                                                     smallm_rows,
                                                     ticket_buffer,
                                                     wgmma_strips,
                                                     wgmma_workspace)
from bigdl_tpu_torch.ops.quant import QTensor, dequantize

# rows of one token tile: one expert per tile (the JAX package's TOKEN_TILE,
# and the most tokens one block of the tiles entry multiplies)
TOKEN_TILE = 128

# the most real rows a tile may hold for the small-M entry (its variants
# stage 8, 16 or 32 token rows)
SMALLM_MAX_ROWS = 32

# weight kind of a dense bf16 stack (KIND_BF16 in csrc/dequant_smallm.cuh)
_KIND_BF16 = 4
# K rows of a dense stack's unit of work (the small-M body loads whole
# 16-row units): K must be a multiple of this
_DENSE_K_MULTIPLE = 16


def plain_ragged_expert_matmul(x: torch.Tensor,
                               w: Union[QTensor, torch.Tensor],
                               tile_expert: torch.Tensor) -> torch.Tensor:
    """x tile i @ W[tile_expert[i]] -> bf16 [Np, N]: each expert
    dequantized to bf16 (a dense stack rounded to bf16), x rounded to bf16,
    the products summed in f32."""
    np_, k = x.shape
    t = TOKEN_TILE
    if np_ % t:
        raise ValueError(f"ragged_expert_matmul: Np={np_} is not a multiple "
                         f"of {t}")
    if isinstance(w, QTensor):
        dense = torch.stack([dequantize(w.index(e), torch.bfloat16)
                             for e in range(w.data.shape[0])])
    else:
        dense = w.to(torch.bfloat16)
    per_tile = dense.index_select(0, tile_expert.long())     # [T, K, N]
    xt = x.to(torch.bfloat16).to(torch.float32).reshape(np_ // t, t, k)
    y = torch.bmm(xt, per_tile.to(torch.float32))
    return y.reshape(np_, -1).to(torch.bfloat16)


def _check_tile_vector(v: torch.Tensor, name: str, tiles: int,
                       device: torch.device) -> None:
    if (v.device != device or v.dtype != torch.int32 or v.dim() != 1
            or v.shape[0] != tiles or not v.is_contiguous()):
        raise ValueError(f"ragged_expert_matmul: {name} must be a contiguous "
                         f"int32 [{tiles}] tensor on {device}, got "
                         f"{v.dtype} {tuple(v.shape)} on {v.device}")


def _require_cuda(x: torch.Tensor, name: str) -> None:
    if not x.is_cuda:
        raise ValueError(f"{name}: x must be a CUDA or CPU tensor, got "
                         f"{x.device}")


def _prepare_dense(x: torch.Tensor, w: torch.Tensor,
                   name: str) -> torch.Tensor:
    """Validate a dense bf16 [E, K, N] stack and return x as contiguous
    bf16 [Np, K]."""
    if w.dim() != 3 or w.dtype != torch.bfloat16 or w.device != x.device:
        raise ValueError(f"{name}: a dense stack must be bf16 [E, K, N] on "
                         f"{x.device}, got {w.dtype} {tuple(w.shape)} on "
                         f"{w.device}")
    k, n = w.shape[1], w.shape[2]
    if x.dim() != 2 or x.shape[1] != k:
        raise ValueError(f"{name}: x must be [Np, {k}], got "
                         f"{tuple(x.shape)}")
    if k % _DENSE_K_MULTIPLE or n % 4:
        raise ValueError(f"{name}: a dense stack needs K % "
                         f"{_DENSE_K_MULTIPLE} == 0 and N % 4 == 0, got "
                         f"K={k} N={n}")
    if not w.is_contiguous() or w.data_ptr() % 8:
        raise ValueError(f"{name}: the dense stack must be contiguous and "
                         "8-byte aligned")
    x = x.to(torch.bfloat16).contiguous()
    if x.data_ptr() % 16:                    # staged with 16-byte loads
        x = x.clone()
    return x


def ragged_entry(w: Union[QTensor, torch.Tensor],
                 max_tile_rows: Optional[int]) -> str:
    """The entry a launch takes, from the caller's bound on a tile's real
    rows alone: ``smallm`` (B1's small-M body) with ``max_tile_rows <=
    SMALLM_MAX_ROWS``, else ``tiles`` (the Hopper body), for a quantized
    and a dense stack alike. No bound (None) keeps the tiles entry."""
    if max_tile_rows is None:
        return "tiles"
    if max_tile_rows < 1:
        raise ValueError(f"ragged_expert_matmul: max_tile_rows must be at "
                         f"least 1, got {max_tile_rows}")
    return "smallm" if max_tile_rows <= SMALLM_MAX_ROWS else "tiles"


def dense_cw(n: int) -> int:
    """32-bit words (2 bf16 columns each) a thread of the small-M body
    loads from each row of a dense stack: 2, one 16-byte load of 8
    weights, where N % 8 == 0, else 1."""
    return 2 if n % 8 == 0 else 1


def dense_loads(n: int, addresses=()) -> str:
    """How the Hopper body loads a dense stack's rows: ``"tma"`` when a
    row is a multiple of 16 bytes (N % 8 == 0) and every address in
    `addresses` (the stack's pointer and expert stride in bytes) is
    16-byte aligned, else ``"cp.async"`` (what ``dqwg::dense_tma_ok`` in
    csrc/dequant_wgmma.cuh asks)."""
    return "tma" if n % 8 == 0 and all(a % 16 == 0 for a in addresses) \
        else "cp.async"


def _launch(x: torch.Tensor, w: Union[QTensor, torch.Tensor],
            tile_expert: torch.Tensor, tile_rows: torch.Tensor,
            split: Optional[Tuple[int, int]] = None,
            max_tile_rows: Optional[int] = None) -> torch.Tensor:
    """Validate and launch B6. ``split`` forces (splits, chunks per split),
    e.g. B2's for a bit-for-bit comparison; ``max_tile_rows`` picks the
    entry (``ragged_entry``): every tile's real rows must be at most it."""
    name = "ragged_expert_matmul"
    _require_cuda(x, name)
    np_ = x.shape[0] if x.dim() == 2 else -1
    if np_ < TOKEN_TILE or np_ % TOKEN_TILE:
        raise ValueError(f"{name}: x must be [Np, K] with Np a multiple of "
                         f"{TOKEN_TILE}, got {tuple(x.shape)}")
    quantized = isinstance(w, QTensor)
    if quantized:
        if w.data.dim() != 3 or w.scale.dim() != 3 or (
                w.zero is not None and w.zero.dim() != 3):
            raise ValueError(f"{name}: w must be an [E, ...] stack of "
                             "planes")
        if not (w.data.is_contiguous() and w.scale.is_contiguous() and (
                w.zero is None or w.zero.is_contiguous())):
            raise ValueError(f"{name}: the expert stack must be contiguous")
        # shape, dtype, alignment and qtype rules of B2, on expert 0
        x2 = _prepare(x, w.index(0), name)
        kind, block, n = _kind(w), w.qt.block_size, w.n
        data, scale = w.data, w.scale
        zero = None if w.zero is None else w.zero.data_ptr()
        lut = _lut_ptr(w, x2.device)
        data_es, scale_es = w.plane_strides()
    else:
        x2 = _prepare_dense(x, w, name)
        kind, block, n = _KIND_BF16, _DENSE_K_MULTIPLE, w.shape[2]
        data = scale = w
        zero = lut = None
        data_es, scale_es = w.stride(0) * w.element_size(), 0
    num_experts = data.shape[0]
    ntiles = np_ // TOKEN_TILE
    _check_tile_vector(tile_expert, "tile_expert", ntiles, x2.device)
    _check_tile_vector(tile_rows, "tile_rows", ntiles, x2.device)
    kp = x2.shape[1]
    stream = _stream(x2.device)
    y = torch.empty((np_, n), dtype=torch.bfloat16, device=x2.device)
    if ragged_entry(w, max_tile_rows) == "smallm":
        geo = "moe_dispatch_smallm"
        cw = _cw(geo, n, max_tile_rows) if quantized else dense_cw(n)
        split, per = split or _split_k(geo, max_tile_rows, n, kp, kind, cw,
                                       x2.device, tiles=ntiles)
        # the weight words' vector loads (a dense row: 8 cw bytes)
        align = min(16, 4 * cw) if quantized else 8 * cw
        misaligned = data.data_ptr() % align or data_es % align
        if quantized:
            misaligned = (misaligned or scale.data_ptr() % (2 * align)
                          or scale_es % align
                          or (zero is not None and zero % (2 * align)))
        if misaligned:
            raise ValueError(f"{name}: the expert planes are not aligned "
                             "for vector loads")
        rows = smallm_rows(max_tile_rows)
        ws = tickets = None
        if split > 1:
            ws = torch.empty((split, ntiles * rows, n), dtype=torch.float32,
                             device=x2.device)
            tickets = ticket_buffer(
                x2.device, ntiles * -(-n // _block_cols(geo, cw))).data_ptr()
        err = _native.kernel("moe_dispatch",
                             "bigdl_ragged_expert_matmul_smallm")(
            x2.data_ptr(), data.data_ptr(), scale.data_ptr(), zero, lut,
            tile_expert.data_ptr(), tile_rows.data_ptr(),
            None if ws is None else ws.data_ptr(), tickets, y.data_ptr(),
            np_, kp, n, block, kind, num_experts, data_es, scale_es, split,
            per, max_tile_rows, cw, stream)
    else:
        # the Hopper body, its K split summed in the same launch
        geo = "moe_dispatch"
        split, per = split or _split_k(geo, TOKEN_TILE, n, kp, kind, 1,
                                       x2.device, tiles=ntiles)
        if quantized:
            planes = [data, scale] + ([] if w.zero is None else [w.zero])
            tma = plane_loads(n, w.qtype, [p.data_ptr() for p in planes]
                              + [data_es, 2 * scale_es])["codes"] == "tma"
        else:
            tma = dense_loads(n, [data.data_ptr(), data_es]) == "tma"
        shape = wgmma_workspace(split, np_, n)
        # the workspace lives to the launch (the allocator may hand a freed
        # block to y)
        ws = tickets = None
        if shape is not None:
            ws = torch.empty(shape, dtype=torch.float32, device=x2.device)
            tickets = ticket_buffer(x2.device,
                                    ntiles * wgmma_strips(n)).data_ptr()
        err = _native.kernel("moe_dispatch")(
            x2.data_ptr(), data.data_ptr(), scale.data_ptr(), zero, lut,
            tile_expert.data_ptr(), tile_rows.data_ptr(),
            None if ws is None else ws.data_ptr(), tickets, y.data_ptr(),
            np_, kp, n, block, kind, num_experts, data_es, scale_es,
            split, per, int(tma), stream)
    _native.check(name, err)
    # a dense stack counts its launches apart
    LAUNCHES[name if quantized else f"{name}_dense"] += 1
    return y


def ragged_expert_matmul(x: torch.Tensor, w: Union[QTensor, torch.Tensor],
                         tile_expert: torch.Tensor, tile_rows: torch.Tensor,
                         max_tile_rows: Optional[int] = None
                         ) -> torch.Tensor:
    """B6: x [Np, K] tile i @ W[tile_expert[i]] -> bf16 [Np, N] for an
    [E, K, N] expert stack, quantized or dense bf16 (Np % TOKEN_TILE == 0).
    ``max_tile_rows``, a bound on every tile's real rows known on the host,
    picks the entry (``ragged_entry``). CPU tensors take the plain version;
    CUDA tensors launch B6 or raise."""
    if x.device.type == "cpu":
        return plain_ragged_expert_matmul(x, w, tile_expert)
    return _launch(x, w, tile_expert, tile_rows, max_tile_rows=max_tile_rows)
