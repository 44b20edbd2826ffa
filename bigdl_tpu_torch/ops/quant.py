"""Block quantization: qtype registry, QTensor, quantize / dequantize.

PyTorch counterpart of ``bigdl_tpu/ops/quant.py`` for the six formats the
serving path uses (sym_int4, asym_int4, sym_int8, nf4, fp4, nf3). The byte
layout is the JAX package's, so both packages compute on the same bytes:

- A quantized linear weight has logical shape ``[K, N]`` (K = in_features,
  the contraction dim) with quantization blocks running along K.
- 4-bit codes are packed "split-block": within each block of B values
  along K, packed byte j (j < B/2) holds value j in its low nibble and
  value j + B/2 in its high nibble. ``data`` is uint8 ``[Kp/2, N]``.
- sym_int8 codes are int8 ``[Kp, N]``.
- Scales (and asym zeros) are bfloat16 ``[Kp/B, N]``.

``Kp`` is K rounded up to a block multiple. Planes may carry leading
dims (layer-stacked weights ``[L, ...]``, MoE expert stacks ``[L, E, ...]``);
``shape`` stays the logical ``(K, N)`` of one matrix.

sym_int4 has a second layout, the int4 layout ``to_mxu_layout`` relays
it into at load time (the JAX package's ``jnp.int4`` data, "MXU layout").
torch has no int4 dtype, so the port keeps it packed: ``data`` is uint8
``[..., Kp/2, N]`` and byte (i, n) holds the signed codes ``c - 8`` of K
rows 2i (low nibble) and 2i + 1 (high nibble) in two's complement. A
QTensor names its layout (``layout``: ``"canonical"`` or ``"int4"``): both
are uint8, so the dtype cannot tell them apart.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from bigdl_tpu_torch.ops.codebooks import CODEBOOKS


@dataclasses.dataclass(frozen=True)
class QType:
    name: str
    bits: int                 # logical bits per value
    block_size: int           # values per scale block (along K)
    kind: str                 # "sym" | "asym" | "codebook"
    storage_bits: int         # bits used in the packed layout
    codebook: Optional[str] = None


def _q(name, bits, block, kind, storage_bits=None, codebook=None):
    return QType(name, bits, block, kind, storage_bits or bits, codebook)


QTYPES = {
    "sym_int4": _q("sym_int4", 4, 32, "sym"),
    "asym_int4": _q("asym_int4", 4, 32, "asym"),
    "sym_int8": _q("sym_int8", 8, 32, "sym"),
    "nf4": _q("nf4", 4, 64, "codebook", codebook="nf4"),
    "nf3": _q("nf3", 3, 64, "codebook", storage_bits=4, codebook="nf3"),
    "fp4": _q("fp4", 4, 64, "codebook", codebook="fp4"),
}
QTYPES["int4"] = QTYPES["sym_int4"]
QTYPES["q4_0"] = QTYPES["sym_int4"]
QTYPES["q4_1"] = QTYPES["asym_int4"]
QTYPES["int8"] = QTYPES["sym_int8"]
QTYPES["q8_0"] = QTYPES["sym_int8"]

FLOAT_QTYPES = ("fp16", "bf16", "fp32")

LAYOUT_CANONICAL = "canonical"
LAYOUT_INT4 = "int4"


def get_qtype(name: str) -> QType:
    try:
        return QTYPES[name]
    except KeyError:
        raise ValueError(
            f"unknown or unported qtype {name!r}; the port has "
            f"{sorted(set(QTYPES))} + {FLOAT_QTYPES}") from None


@dataclasses.dataclass
class QTensor:
    """A block-quantized tensor of logical shape ``[K, N]``.

    data:  uint8 ``[..., Kp/2, N]`` (4-bit, split-block) or int8
           ``[..., Kp, N]`` (sym_int8).
    scale: bfloat16 ``[..., Kp/B, N]``.
    zero:  bfloat16 ``[..., Kp/B, N]`` for asym kinds, else None.
    qtype: qtype name.
    shape: logical (K, N) of one matrix (leading plane dims excluded).
    layout: ``"canonical"`` (split-block) or ``"int4"`` (sym_int4 only,
           K-row pairs, see the module docstring).
    """

    data: torch.Tensor
    scale: torch.Tensor
    zero: Optional[torch.Tensor]
    qtype: str
    shape: Tuple[int, int]
    layout: str = "canonical"

    @property
    def qt(self) -> QType:
        return get_qtype(self.qtype)

    @property
    def k(self) -> int:
        return self.shape[0]

    @property
    def n(self) -> int:
        return self.shape[1]

    @property
    def kp(self) -> int:
        """K padded to a block multiple (the rows the planes hold)."""
        return self.scale.shape[-2] * self.qt.block_size

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def is_int4(self) -> bool:
        return self.layout == LAYOUT_INT4

    @property
    def nbytes(self) -> int:
        # the int4 layout is packed two codes a byte, as XLA stores jnp.int4,
        # so the JAX package's count for it is the same byte count
        tot = self.data.numel() * self.data.element_size()
        tot += self.scale.numel() * self.scale.element_size()
        if self.zero is not None:
            tot += self.zero.numel() * self.zero.element_size()
        return tot

    def index(self, i: int) -> "QTensor":
        """One matrix of a layer-stacked QTensor (views, no copy)."""
        return QTensor(self.data[i], self.scale[i],
                       None if self.zero is None else self.zero[i],
                       self.qtype, self.shape, self.layout)

    def _canonical_only(self, what: str) -> None:
        if self.is_int4:
            raise ValueError(f"{what} reads the canonical packing; this "
                             f"{self.qtype} QTensor has the int4 layout")

    def take(self, ids: torch.Tensor) -> "QTensor":
        """The matrices at ``ids`` (an int tensor on the planes' device)
        of a stacked QTensor, as a new ``[len(ids), ...]`` stack: one
        ``index_select`` per plane, no host sync."""
        self._canonical_only("QTensor.take")
        return QTensor(self.data.index_select(0, ids),
                       self.scale.index_select(0, ids),
                       None if self.zero is None
                       else self.zero.index_select(0, ids),
                       self.qtype, self.shape)

    def plane_strides(self) -> Tuple[int, int]:
        """Leading-axis strides of the (data, scale) planes in elements
        (the zero plane shares the scale plane's): the distance from one
        expert's matrix to the next in an ``[E, ...]`` stack."""
        self._canonical_only("QTensor.plane_strides")
        return self.data.stride(0), self.scale.stride(0)

    def to(self, device) -> "QTensor":
        return QTensor(self.data.to(device), self.scale.to(device),
                       None if self.zero is None else self.zero.to(device),
                       self.qtype, self.shape, self.layout)

    def __repr__(self):
        lay = ", layout=int4" if self.is_int4 else ""
        return (f"QTensor({self.qtype}, shape={self.shape}, "
                f"block={self.qt.block_size}{lay})")


def _safe_inv(x: torch.Tensor) -> torch.Tensor:
    """1/x with 0 -> 0 (no NaNs from empty/zero blocks)."""
    return torch.where(x == 0, torch.zeros_like(x),
                       1.0 / torch.where(x == 0, torch.ones_like(x), x))


def _pack4(codes: torch.Tensor, block: int) -> torch.Tensor:
    """[K, N] uint8 codes (0..15) -> [K//2, N] split-block packed bytes."""
    k, n = codes.shape
    b2 = block // 2
    blk = codes.reshape(k // block, block, n)
    lo = blk[:, :b2, :]
    hi = blk[:, b2:, :]
    return (lo | (hi << 4)).reshape(k // 2, n)


def _unpack4(packed: torch.Tensor, block: int) -> torch.Tensor:
    """[K//2, N] packed bytes -> [K, N] uint8 codes (0..15)."""
    k2, n = packed.shape
    b2 = block // 2
    blk = packed.reshape(k2 // b2, b2, n)
    lo = blk & 0x0F
    hi = blk >> 4
    return torch.cat([lo, hi], dim=1).reshape(k2 * 2, n)


def _pad_k(x: torch.Tensor, block: int) -> torch.Tensor:
    rem = (-x.shape[0]) % block
    if rem:
        x = torch.nn.functional.pad(x, (0, 0, 0, rem))
    return x


def _codebook_encode(code: np.ndarray, xn: torch.Tensor) -> torch.Tensor:
    """Nearest-codebook-entry encode via searchsorted on the sorted table
    (the same numpy-side table prep as the JAX package, so ties resolve
    identically)."""
    order = np.argsort(code)
    sorted_code = code[order]
    bounds = (sorted_code[1:] + sorted_code[:-1]) / 2.0
    b = torch.from_numpy(np.ascontiguousarray(bounds)).to(xn.device)
    idx = torch.searchsorted(b, xn.contiguous(), out_int32=True)
    del xn                                   # the caller's temporary
    perm = torch.from_numpy(order.astype(np.uint8)).to(idx.device)
    return perm[idx]


def quantize(x: torch.Tensor, qtype: str) -> QTensor:
    """Quantize a ``[K, N]`` float tensor along K into a QTensor.

    Keeps ``_quantize_core``'s float32 operation order, so the same f32
    weights give the same bytes as the JAX package."""
    if x.dim() != 2:
        raise ValueError(
            f"quantize expects a 2-D [K, N] tensor, got {tuple(x.shape)}")
    qt = get_qtype(qtype)
    k, n = x.shape
    b = qt.block_size
    x = _pad_k(x.to(torch.float32), b)
    kp = x.shape[0]
    nblk = kp // b
    xb = x.reshape(nblk, b, n)

    if qt.kind == "sym":
        # signed absmax: the max-|x| element maps to the most negative code
        amax_i = torch.argmax(xb.abs(), dim=1, keepdim=True)
        mx = torch.gather(xb, 1, amax_i)                 # [nblk, 1, n]
        half = float(1 << (qt.bits - 1))
        d = mx / -half
        inv = _safe_inv(d)
        # in place: one f32 temporary beside x (a load quantizes on the
        # device, where these transients are its peak memory)
        q = xb * inv
        q.round_().add_(half).clamp_(0, 2 * half - 1)
        q = q.reshape(kp, n).to(torch.uint8)
        scale = d.reshape(nblk, n).to(torch.bfloat16)
        if qt.bits == 4:
            return QTensor(_pack4(q, b), scale, None, qt.name, (k, n))
        q8 = (q.to(torch.int16) - 128).to(torch.int8)
        return QTensor(q8, scale, None, qt.name, (k, n))

    if qt.kind == "asym":
        mn = torch.amin(xb, dim=1, keepdim=True)
        mxv = torch.amax(xb, dim=1, keepdim=True)
        levels = float((1 << qt.bits) - 1)
        # XLA lowers a division by a constant to a multiply by its f32
        # reciprocal; doing the same keeps the bf16 scales bit-identical
        # where the quotient lands on a bf16 rounding midpoint
        d = (mxv - mn) * float(np.float32(1.0) / np.float32(levels))
        inv = _safe_inv(d)
        q = xb - mn
        q.mul_(inv).round_().clamp_(0, levels)
        q = q.reshape(kp, n).to(torch.uint8)
        scale = d.reshape(nblk, n).to(torch.bfloat16)
        zero = mn.reshape(nblk, n).to(torch.bfloat16)
        return QTensor(_pack4(q, b), scale, zero, qt.name, (k, n))

    if qt.kind == "codebook":
        code = CODEBOOKS[qt.codebook]
        d = torch.amax(xb.abs(), dim=1, keepdim=True)
        inv = _safe_inv(d)
        q = _codebook_encode(code, xb * inv).reshape(kp, n)
        scale = d.reshape(nblk, n).to(torch.bfloat16)
        return QTensor(_pack4(q, b), scale, None, qt.name, (k, n))

    raise ValueError(f"unsupported qtype kind {qt.kind}")


def _expand_scale(scale: torch.Tensor, block: int, kp: int) -> torch.Tensor:
    """[nblk, N] -> [Kp, N] f32 by repeating each block row `block` times."""
    nblk, n = scale.shape
    return scale.to(torch.float32)[:, None, :].expand(
        nblk, block, n).reshape(kp, n)


def dequantize(qt: QTensor, dtype=torch.bfloat16) -> torch.Tensor:
    """QTensor (one matrix) -> dense ``[K, N]`` tensor of ``dtype``.

    The same per-element f32 arithmetic as ``dequantize_impl``: code (or
    table value) times the f32 scale (plus the f32 zero), then one
    rounding to ``dtype``."""
    t = qt.qt
    k = qt.shape[0]
    b = t.block_size
    if qt.data.dim() != 2:
        raise ValueError("dequantize takes one matrix; index stacked "
                         "planes first (QTensor.index)")
    if t.storage_bits == 8:
        kp = qt.data.shape[0]
        vals = qt.data.to(torch.float32)
        out = vals * _expand_scale(qt.scale, b, kp)
        return out[:k].to(dtype)
    if qt.is_int4:                          # signed codes, K-row pairs
        vals = unpack_int4_rows(qt.data).to(torch.float32)
        out = vals * _expand_scale(qt.scale, b, vals.shape[0])
        return out[:k].to(dtype)
    codes = _unpack4(qt.data, b)
    kp = codes.shape[0]
    if t.kind == "codebook":
        code = torch.from_numpy(CODEBOOKS[t.codebook]).to(codes.device)
        vals = code[codes.long()]
        out = vals * _expand_scale(qt.scale, b, kp)
    elif t.kind == "sym":
        vals = codes.to(torch.float32) - 8.0
        out = vals * _expand_scale(qt.scale, b, kp)
    else:                                   # asym
        d = _expand_scale(qt.scale, b, kp)
        m = _expand_scale(qt.zero, b, kp)
        out = codes.to(torch.float32) * d + m
    return out[:k].to(dtype)


def concat_qtensors_n(ws) -> QTensor:
    """Concatenate QTensors along N (the output dim). Blocks run along K
    and columns quantize independently, so the result is bit-identical to
    quantizing the concatenated dense weight. Works on layer-stacked
    planes, and on the int4 layout (which packs along K), since every
    plane is N-last."""
    w0 = ws[0]
    if len({w.layout for w in ws}) != 1:
        raise ValueError(f"cannot concat mixed layouts: "
                         f"{[w.layout for w in ws]}")
    if len({w.qtype for w in ws}) != 1:
        raise ValueError(f"cannot concat mixed qtypes: {[w.qtype for w in ws]}")
    if len({w.shape[0] for w in ws}) != 1:
        raise ValueError(f"cannot concat differing K: {[w.shape for w in ws]}")
    zeros = [w.zero for w in ws]
    if any(z is None for z in zeros) and any(z is not None for z in zeros):
        raise ValueError("inconsistent zero planes across operands")
    return QTensor(
        torch.cat([w.data for w in ws], dim=-1),
        torch.cat([w.scale for w in ws], dim=-1),
        None if zeros[0] is None else torch.cat(zeros, dim=-1),
        w0.qtype, (w0.shape[0], sum(w.shape[1] for w in ws)), w0.layout)


def split_qtensor_n(w: QTensor, sizes) -> list:
    """Inverse of `concat_qtensors_n`: slice along N at the given sizes."""
    if sum(sizes) != w.shape[1]:
        raise ValueError(f"split sizes {sizes} != N={w.shape[1]}")
    outs, off = [], 0
    for s in sizes:
        outs.append(QTensor(
            w.data[..., off:off + s], w.scale[..., off:off + s],
            None if w.zero is None else w.zero[..., off:off + s],
            w.qtype, (w.shape[0], s), w.layout))
        off += s
    return outs


# ---------------------------------------------------------------------------
# int4 layout (the JAX package's int4-dtype "MXU" layout), packed two a byte

# bytes of input a relayout step reads: bounds the transient of a leaf's
# conversion to a few times this, whatever the leaf's size
_RELAYOUT_CHUNK = 64 << 20


def pack_int4_rows(codes: torch.Tensor) -> torch.Tensor:
    """Signed codes [..., K, N] (int8 in [-8, 7], K even) -> the int4
    layout's bytes [..., K/2, N]: row 2i in the low nibble, 2i + 1 in the
    high nibble, two's complement."""
    *lead, k, n = codes.shape
    c = codes.reshape(*lead, k // 2, 2, n).to(torch.uint8) & 0x0F
    return c[..., 0, :] | (c[..., 1, :] << 4)


def unpack_int4_rows(packed: torch.Tensor) -> torch.Tensor:
    """The int4 layout's bytes [..., K/2, N] -> signed int8 codes
    [..., K, N] (sign-extended nibbles)."""
    *lead, k2, n = packed.shape
    lo = (packed << 4).view(torch.int8) >> 4
    hi = packed.view(torch.int8) >> 4
    return torch.stack([lo, hi], dim=-2).reshape(*lead, 2 * k2, n)


def _relayout(data: torch.Tensor, fn, rows: int) -> torch.Tensor:
    """Apply `fn` ([c, rows, N] -> [c, rows, N] uint8) to each group of
    `rows` packed rows of `data` (any leading dims), a bounded number of
    groups at a time, into a new tensor on data's device."""
    n = data.shape[-1]
    src = data.reshape(-1, rows, n)
    out = torch.empty_like(src)
    step = max(1, _RELAYOUT_CHUNK // (rows * n))
    for g in range(0, src.shape[0], step):
        out[g:g + step] = fn(src[g:g + step])
    return out.reshape(data.shape)


def _split_to_pairs(blk: torch.Tensor) -> torch.Tensor:
    """One quant block's 16 split-block bytes (rows j | j + 16 << 4) ->
    its 16 int4-layout bytes (rows 2i | 2i + 1 << 4); c - 8 in two's
    complement is c ^ 8."""
    codes = torch.cat([blk & 0x0F, blk >> 4], dim=1) ^ 0x08  # [c, 32, N]
    return codes[:, 0::2] | (codes[:, 1::2] << 4)


def _pairs_to_split(blk: torch.Tensor) -> torch.Tensor:
    codes = torch.stack([blk & 0x0F, blk >> 4], dim=2).reshape(
        blk.shape[0], 32, blk.shape[2]) ^ 0x08
    return codes[:, :16] | (codes[:, 16:] << 4)


def to_mxu_layout(qt: QTensor) -> QTensor:
    """sym_int4 canonical (split-block) -> the int4 layout, on the planes'
    device (``to_mxu_layout`` of the JAX package, done once at load).
    Scales and zeros are shared, not copied; the data plane is rewritten
    into a new tensor a bounded chunk at a time, so the transient beside
    the leaf stays small and nothing goes through the host. Other qtypes,
    int4-layout leaves and 4-D ``[L, E, K/2, N]`` expert stacks (which B6
    and the MoE decode gather read in the canonical packing) pass
    through. A failed conversion raises: no leaf is left behind in the
    canonical layout by a fallback."""
    if qt.qtype not in ("sym_int4",) or qt.is_int4:
        return qt
    if qt.data.dim() >= 4:
        return qt
    if qt.qt.block_size != 32 or qt.data.dtype != torch.uint8:
        raise ValueError(f"to_mxu_layout: unexpected sym_int4 planes "
                         f"{qt.data.dtype}, block {qt.qt.block_size}")
    data = _relayout(qt.data, _split_to_pairs, 16)
    return dataclasses.replace(qt, data=data, layout=LAYOUT_INT4)


def from_mxu_layout(qt: QTensor) -> QTensor:
    """Inverse of `to_mxu_layout`: the canonical bytes, bit for bit (what
    ``save_low_bit`` writes)."""
    if not qt.is_int4:
        return qt
    data = _relayout(qt.data, _pairs_to_split, 16)
    return dataclasses.replace(qt, data=data, layout=LAYOUT_CANONICAL)


def _map_leaves(tree, fn):
    """Replace every QTensor leaf of a dict tree by fn(leaf), in the
    tree's own dicts, one leaf at a time: a leaf is dropped as soon as its
    replacement exists, so a caller that owns the tree never holds two
    copies of it."""
    if isinstance(tree, QTensor):
        return fn(tree)
    if isinstance(tree, dict):
        for k in list(tree):
            tree[k] = _map_leaves(tree[k], fn)
    return tree


def tree_to_mxu_layout(tree):
    """`to_mxu_layout` on every QTensor of a tree (dicts updated in place;
    returns the tree)."""
    return _map_leaves(tree, to_mxu_layout)


def tree_from_mxu_layout(tree):
    """`from_mxu_layout` on every QTensor of a tree (dicts updated in
    place; returns the tree)."""
    return _map_leaves(tree, from_mxu_layout)


def _on_cuda(tree) -> bool:
    if isinstance(tree, QTensor):
        return tree.data.is_cuda
    if isinstance(tree, torch.Tensor):
        return tree.is_cuda
    return isinstance(tree, dict) and any(_on_cuda(v) for v in tree.values())


def prepack_tree(tree, mode: Optional[str] = None):
    """Load-time prepack (``prepack_tree`` of the JAX package): every
    sym_int4 QTensor of the tree goes to the int4 layout, which the decode
    body ``mxu`` and the prefill body ``i4`` read. `mode` is "auto"
    (prepack when the parameters live on a CUDA device), "on" or "off";
    None reads ``BIGDL_TPU_TORCH_PREPACK``. Either that flag or
    ``BIGDL_TPU_TORCH_MXU_LAYOUT`` set to "off" disables the prepack, and
    either set to "on" forces it. The tree's dicts are updated in place,
    leaf by leaf. Returns (tree, report), the report the JAX package's: mode,
    applied, qtensors, converted, bytes_packed."""
    from bigdl_tpu_torch.config import flags, resolve_prepack

    f = flags()
    mode = resolve_prepack(mode) if mode is not None else f.prepack
    report = {"mode": mode, "applied": False,
              "qtensors": 0, "converted": 0, "bytes_packed": 0}
    off = mode == "off" or f.mxu_layout == "off"
    force = mode == "on" or f.mxu_layout == "on"
    if off or (not force and not _on_cuda(tree)):
        return tree, report

    def conv(x: QTensor) -> QTensor:
        report["qtensors"] += 1
        y = to_mxu_layout(x)
        if y.layout != x.layout:
            report["converted"] += 1
        report["bytes_packed"] += int(y.nbytes)
        return y

    tree = _map_leaves(tree, conv)
    report["applied"] = report["converted"] > 0
    return tree, report
