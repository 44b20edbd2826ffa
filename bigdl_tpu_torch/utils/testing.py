"""Synthetic model builders (counterpart of ``bigdl_tpu/utils/testing.py``).

Weights are drawn on the target device from a seeded ``torch.Generator``
and quantized one matrix at a time, so a full-width model never exists in
f32 as a whole (one f32 projection at a time does); Mixtral's expert
stacks are filled in place, one expert at a time. The numbers are
not the JAX package's: its PRNG differs. Tests that compare the two
packages carry the JAX package's weights across with ``bridge.py``.
"""

from __future__ import annotations

import itertools
from typing import Any, Dict, Optional

import torch

from bigdl_tpu_torch.models import llama as llama_mod
from bigdl_tpu_torch.models.llama import LlamaConfig
from bigdl_tpu_torch.models.mixtral import MixtralConfig
from bigdl_tpu_torch.ops.quant import FLOAT_QTYPES, QTensor, quantize

TINY_LLAMA = LlamaConfig(
    vocab_size=256,
    hidden_size=64,
    intermediate_size=128,
    num_hidden_layers=2,
    num_attention_heads=8,
    num_key_value_heads=4,
    max_position_embeddings=256,
)

LLAMA2_7B = LlamaConfig()  # defaults are Llama-2-7B

# mistralai/Mixtral-8x7B-v0.1, config.json
MIXTRAL_8X7B = MixtralConfig(
    vocab_size=32000,
    hidden_size=4096,
    intermediate_size=14336,
    num_hidden_layers=32,
    num_attention_heads=32,
    num_key_value_heads=8,
    rms_norm_eps=1e-5,
    rope_theta=1e6,
    max_position_embeddings=32768,
    sliding_window=None,
    tie_word_embeddings=False,
    num_local_experts=8,
    num_experts_per_tok=2,
)


def _stack(mats):
    if isinstance(mats[0], QTensor):
        return QTensor(torch.stack([m.data for m in mats]),
                       torch.stack([m.scale for m in mats]),
                       None if mats[0].zero is None
                       else torch.stack([m.zero for m in mats]),
                       mats[0].qtype, mats[0].shape)
    return torch.stack(mats)


def random_llama_params(cfg: LlamaConfig, qtype: Optional[str] = "sym_int4",
                        seed: int = 0, compute_dtype=torch.bfloat16,
                        device="cuda") -> Dict[str, Any]:
    """Random llama parameter dict, ~N(0, 0.02) weights, quantized linears,
    built on `device` from a generator seeded with `seed`."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    do_quant = qtype is not None and qtype not in FLOAT_QTYPES
    d, ff, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    h, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.hd

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32) * 0.02

    def make_linear(kdim, ndim):
        w = randn(kdim, ndim)
        if do_quant:
            return quantize(w, qtype)
        return w.to(compute_dtype)

    layers: Dict[str, Any] = {}
    per = {
        "q_proj": (d, h * hd),
        "k_proj": (d, hkv * hd),
        "v_proj": (d, hkv * hd),
        "o_proj": (h * hd, d),
        "gate_proj": (d, ff),
        "up_proj": (d, ff),
        "down_proj": (ff, d),
    }
    for name, (kdim, ndim) in per.items():
        layers[name] = _stack([make_linear(kdim, ndim)
                               for _ in range(cfg.num_hidden_layers)])
    ones = torch.ones((cfg.num_hidden_layers, d), dtype=compute_dtype,
                      device=device)
    layers["input_layernorm"] = ones
    layers["post_attention_layernorm"] = ones.clone()
    params: Dict[str, Any] = {
        "embed_tokens": randn(v, d).to(compute_dtype),
        "layers": layers,
        "norm": torch.ones((d,), dtype=compute_dtype, device=device),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = make_linear(d, v)
    return params


def random_mixtral_params(cfg: MixtralConfig,
                          qtype: Optional[str] = "sym_int4", seed: int = 0,
                          compute_dtype=torch.bfloat16,
                          device="cuda") -> Dict[str, Any]:
    """Random mixtral parameter dict: llama attention (separate q/k/v/o),
    a dense [L, D, E] router and [L, E, K, N] expert stacks, ~N(0, 0.02)
    weights, built on `device` from a generator seeded with `seed`. Each
    stack is allocated once and filled one expert at a time."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    do_quant = qtype is not None and qtype not in FLOAT_QTYPES
    d, ff, v = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    h, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.hd
    n_l, n_e = cfg.num_hidden_layers, cfg.num_local_experts

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device,
                           dtype=torch.float32) * 0.02

    def make_linear(kdim, ndim):
        w = randn(kdim, ndim)
        return quantize(w, qtype) if do_quant else w.to(compute_dtype)

    def stacked(lead, kdim, ndim):
        """A [*lead, K, N] stack, allocated at its first matrix and filled
        one matrix at a time."""
        out = None
        for idx in itertools.product(*(range(n_) for n_ in lead)):
            m = make_linear(kdim, ndim)
            planes = ((m.data, m.scale, m.zero) if isinstance(m, QTensor)
                      else (m,))
            if out is None:
                out = [None if p is None else torch.empty(
                    (*lead, *p.shape), dtype=p.dtype, device=device)
                    for p in planes]
            for buf, p in zip(out, planes):
                if p is not None:
                    buf[idx] = p
        return QTensor(*out, m.qtype, m.shape) if do_quant else out[0]

    layers: Dict[str, Any] = {}
    for name, (kdim, ndim) in {
            "q_proj": (d, h * hd), "k_proj": (d, hkv * hd),
            "v_proj": (d, hkv * hd), "o_proj": (h * hd, d)}.items():
        layers[name] = stacked((n_l,), kdim, ndim)
    for name, (kdim, ndim) in {
            "experts_gate": (d, ff), "experts_up": (d, ff),
            "experts_down": (ff, d)}.items():
        layers[name] = stacked((n_l, n_e), kdim, ndim)
    layers["router"] = randn(n_l, d, n_e).to(compute_dtype)
    ones = torch.ones((n_l, d), dtype=compute_dtype, device=device)
    layers["input_layernorm"] = ones
    layers["post_attention_layernorm"] = ones.clone()
    params: Dict[str, Any] = {
        "embed_tokens": randn(v, d).to(compute_dtype),
        "layers": layers,
        "norm": torch.ones((d,), dtype=compute_dtype, device=device),
    }
    if not cfg.tie_word_embeddings:
        params["lm_head"] = make_linear(d, v)
    return params


class SyntheticCausalLM:
    """What ``LLMEngine`` needs of a model: ``.params``, ``.config``,
    ``.hf_config`` (for the EOS id) and ``.family`` (its model module,
    llama unless given)."""

    def __init__(self, params, cfg: LlamaConfig, eos_token_id=None,
                 family=llama_mod):
        self.params = params
        self.config = cfg
        self.hf_config = {"eos_token_id": eos_token_id}
        self.family = family


def tiny_random_model(seed: int = 0, qtype: Optional[str] = "sym_int4",
                      cfg: Optional[LlamaConfig] = None,
                      device="cuda") -> SyntheticCausalLM:
    """A tiny random llama (``TINY_LLAMA`` unless `cfg` is given) ready for
    ``LLMEngine`` / ``OpenAIServer``: the ``api_server --tiny-random``
    mode. One seed gives the same weights in every process."""
    cfg = cfg or TINY_LLAMA
    return SyntheticCausalLM(
        random_llama_params(cfg, qtype=qtype, seed=seed, device=device), cfg)
