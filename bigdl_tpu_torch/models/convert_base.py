"""Checkpoint conversion scaffolding (counterpart of
``bigdl_tpu/models/convert_base.py``).

HF tensors arrive one at a time (``utils/hf.iter_hf_tensors``). Each
linear is moved to the target device and quantized there as it arrives
(``ops/quant.quantize``), so one float tensor is live at a time; the
per-layer results are written into stacked leaves ``[L, ...]`` (or
``[L, E, ...]`` for expert stacks) that are allocated once, at their
first layer, so no second copy of a stack is ever made. The bytes are
the JAX package's ``convert_hf_params``: the same f32 values quantized in
the same operation order.

Not ported: quality attribution (ROADMAP A16), imatrix weighting and the
ultra-low-bit protections (A11), and the encoder-decoder layer map (A13).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from bigdl_tpu_torch.ops.quant import (FLOAT_QTYPES, QTensor, get_qtype,
                                       quantize)


def _planes(val):
    if isinstance(val, QTensor):
        return (val.data, val.scale, val.zero)
    return (val,)


class Acc:
    """Accumulates per-layer leaves into stacks along L, on `device`."""

    def __init__(self, cfg, qtype: Optional[str],
                 compute_dtype=torch.bfloat16,
                 modules_to_not_convert: Tuple[str, ...] = (),
                 device="cuda"):
        self.cfg = cfg
        self.L = cfg.num_hidden_layers
        self.compute_dtype = compute_dtype
        self.device = torch.device(device)
        self.do_quant = qtype is not None and qtype not in FLOAT_QTYPES
        if self.do_quant:
            get_qtype(qtype)                 # unknown qtypes raise here
        self.qtype = qtype
        self.skip = tuple(modules_to_not_convert)
        self.layers: Dict[str, Any] = {}
        self.top: Dict[str, Any] = {}
        self._lead: Dict[str, tuple] = {}
        self._filled: Dict[str, set] = {}

    def linear(self, name: str, w: torch.Tensor):
        """HF [out, in] -> contraction-major [in, out] leaf on the device:
        a QTensor of the load's qtype, or dense in compute_dtype for a
        float load and for names matching ``modules_to_not_convert``."""
        if self.do_quant and not any(m in name for m in self.skip):
            # f32 [K, N] on the device; the host copy and the device's
            # stored-dtype copy are dropped before quantize runs
            x = w.to(self.device).to(torch.float32).t().contiguous()
            return quantize(x, self.qtype)
        return w.to(self.device).t().to(self.compute_dtype).contiguous()

    def dense(self, w: torch.Tensor) -> torch.Tensor:
        return w.to(self.device).to(self.compute_dtype)

    def put(self, key: str, idx, val, lead: Optional[tuple] = None) -> None:
        """Write `val` into slot `idx` (an int, or a tuple for an
        ``[L, E, ...]`` stack) of the stacked leaf `key`. The stack is
        allocated at its first put with leading dims `lead` (default
        ``(L,)``)."""
        idx = idx if isinstance(idx, tuple) else (idx,)
        if key not in self.layers:
            lead = tuple(lead or (self.L,))
            bufs = [None if p is None else torch.empty(
                (*lead, *p.shape), dtype=p.dtype, device=p.device)
                for p in _planes(val)]
            self.layers[key] = (QTensor(*bufs, val.qtype, val.shape)
                                if isinstance(val, QTensor) else bufs[0])
            self._lead[key] = lead
            self._filled[key] = set()
        stack = self.layers[key]
        if isinstance(stack, QTensor) != isinstance(val, QTensor) or (
                isinstance(val, QTensor) and (val.qtype, val.shape) != (
                    stack.qtype, stack.shape)):
            raise ValueError(f"{key}: layer {idx} does not match the "
                             "stack's kind (one qtype per stacked key)")
        for buf, p in zip(_planes(stack), _planes(val)):
            if buf is not None:
                buf[idx] = p
        self._filled[key].add(idx)

    @classmethod
    def for_layer_count(cls, num_layers: int, qtype, compute_dtype,
                        modules_to_not_convert, device="cuda") -> "Acc":
        """Accumulator for a bare layer stack."""
        import types

        return cls(types.SimpleNamespace(num_hidden_layers=num_layers),
                   qtype, compute_dtype, modules_to_not_convert, device)

    def finish(self, tie: bool, lm_head_required: bool = True,
               what: str = "checkpoint") -> Dict[str, Any]:
        missing = []
        for k, lead in self._lead.items():
            n = 1
            for d in lead:
                n *= d
            if len(self._filled[k]) != n:
                missing.append(k)
        if missing:
            raise ValueError(f"{what} missing layer tensors: {missing}")
        params = dict(self.top)
        params["layers"] = dict(self.layers)
        if tie:
            params.pop("lm_head", None)
        elif lm_head_required and "lm_head" not in params:
            raise ValueError("checkpoint has no lm_head and embeddings are "
                             "not tied")
        return params


def make_convert(map_tensor: Callable,
                 lm_head_required: bool = True) -> Callable:
    """A convert_hf_params from a per-tensor mapping callback:
    map_tensor(acc, name, w) handles one HF tensor (acc.put / acc.top).
    Unknown tensors are ignored (rotary inv_freq etc.)."""

    def convert(tensors, cfg, qtype: Optional[str] = "sym_int4",
                compute_dtype=torch.bfloat16,
                modules_to_not_convert: Tuple[str, ...] = (),
                imatrix=None, device="cuda"):
        if imatrix is not None:
            raise NotImplementedError(
                "imatrix-weighted quantization is not ported (ROADMAP A11)")
        acc = Acc(cfg, qtype, compute_dtype, modules_to_not_convert, device)
        for name, w in tensors:
            map_tensor(acc, name, w)
        return acc.finish(getattr(cfg, "tie_word_embeddings", False),
                          lm_head_required=lm_head_required)

    return convert


def split_rows(w: torch.Tensor, sizes) -> list:
    """Split an HF [out, in] fused weight along out into len(sizes) parts."""
    out, off = [], 0
    for s in sizes:
        out.append(w[off:off + s])
        off += s
    return out


def deinterleave_qkv(w: torch.Tensor, heads: int, hd: int):
    """Fused qkv [(H*3*hd), in] with a per-head (h, 3, hd) layout ->
    (q, k, v) each [H*hd, in]. Works for a bias ([H*3*hd])."""
    lead = tuple(w.shape[1:])
    w = w.reshape(heads, 3, hd, *lead)
    return tuple(w[:, i].reshape(heads * hd, *lead) for i in range(3))


def layer_idx(name: str, prefix: str) -> Optional[Tuple[int, str]]:
    if not name.startswith(prefix):
        return None
    idx_s, _, sub = name[len(prefix):].partition(".")
    return int(idx_s), sub
