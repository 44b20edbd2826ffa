"""Mixtral (sparse MoE) decoder, counterpart of ``bigdl_tpu/models/mixtral.py``.

The parameter dict is llama's with the MLP projections of each layer
replaced by a dense router and stacked experts::

    "router":       [L, D, E] dense (kept in full precision)
    "experts_gate": QTensor/dense [L, E, D, F]   (HF w1)
    "experts_up":   QTensor/dense [L, E, D, F]   (HF w3)
    "experts_down": QTensor/dense [L, E, F, D]   (HF w2)

Attention, embedding, norms and lm_head are the llama module's: a layer is
llama's decoder layer, whose MLP sees the ``router`` and runs the sparse-MoE
MLP (``llama._moe_mlp``: gather, ragged through kernel B6, or dense). The
JAX family has no paged forward, so neither has this one: the engine's
paged mode refuses it. ``convert_hf_params`` builds the expert stacks
from an HF checkpoint, quantized or dense bf16; training
(``forward_train``) is not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

from bigdl_tpu_torch.models import llama as llama_mod
from bigdl_tpu_torch.models.llama import LlamaConfig, check_supported  # noqa: F401
from bigdl_tpu_torch.ops.kvcache import KVCache


@dataclasses.dataclass(frozen=True)
class MixtralConfig(LlamaConfig):
    num_local_experts: int = 8
    num_experts_per_tok: int = 2

    @classmethod
    def from_hf(cls, hf: Dict[str, Any]) -> "MixtralConfig":
        kw = dataclasses.asdict(LlamaConfig.from_hf(hf))
        kw.pop("num_local_experts", None)
        kw.pop("num_experts_per_tok", None)
        return cls(**kw,
                   num_local_experts=hf.get("num_local_experts", 8),
                   num_experts_per_tok=hf.get("num_experts_per_tok", 2))


def moe_block(x: torch.Tensor, lp: Dict[str, Any],
              cfg: MixtralConfig) -> torch.Tensor:
    """Sparse-MoE MLP of one layer, [B, T, D] -> [B, T, D]."""
    return llama_mod._moe_mlp(x, lp, cfg)


def forward(params: Dict[str, Any], cfg: MixtralConfig, tokens: torch.Tensor,
            cache: KVCache, compute_dtype=torch.bfloat16,
            last_only: bool = False) -> Tuple[torch.Tensor, KVCache]:
    """Run the model on tokens [B, Sq] at the cache's positions (scalar or
    per slot); returns (f32 logits [B, Sq or 1, V], cache with pos + Sq).
    The cache tensors are written in place."""
    logits = llama_mod._run(params, cfg, tokens, cache, compute_dtype,
                            last_only)
    return logits, cache.reset_pos(cache.pos + tokens.shape[1])


def forward_last_token(params, cfg: MixtralConfig, tokens, cache: KVCache,
                       compute_dtype=torch.bfloat16):
    """Prefill variant of `forward` with lm_head on the final position."""
    return forward(params, cfg, tokens, cache, compute_dtype, last_only=True)


_ATTN = {"self_attn.q_proj": "q_proj", "self_attn.k_proj": "k_proj",
         "self_attn.v_proj": "v_proj", "self_attn.o_proj": "o_proj"}
_EXPERTS = {"w1": "experts_gate", "w3": "experts_up", "w2": "experts_down"}


def _mixtral_map(acc, name: str, w) -> None:
    """HF MixtralForCausalLM tensor names -> parameter keys: the router
    (``block_sparse_moe.gate`` [E, D]) stays dense as [D, E]; experts.M.
    {w1, w3} [F, D] and w2 [D, F] fill the [L, E, ...] stacks."""
    if name == "model.embed_tokens.weight":
        acc.top["embed_tokens"] = acc.dense(w)
    elif name == "model.norm.weight":
        acc.top["norm"] = acc.dense(w)
    elif name == "lm_head.weight":
        acc.top["lm_head"] = acc.linear(name, w)
    elif name.startswith("model.layers."):
        parts = name.split(".")
        idx = int(parts[2])
        sub = ".".join(parts[3:-1])
        if sub in _ATTN:
            acc.put(_ATTN[sub], idx, acc.linear(name, w))
        elif sub in ("input_layernorm", "post_attention_layernorm"):
            acc.put(sub, idx, acc.dense(w))
        elif sub == "block_sparse_moe.gate":
            acc.put("router", idx, acc.dense(w.t()))
        elif sub.startswith("block_sparse_moe.experts."):
            _, _, eidx, wname = sub.split(".")
            acc.put(_EXPERTS[wname], (idx, int(eidx)), acc.linear(name, w),
                    lead=(acc.L, acc.cfg.num_local_experts))


def convert_hf_params(tensors, cfg: MixtralConfig,
                      qtype: Optional[str] = "sym_int4",
                      compute_dtype=torch.bfloat16,
                      modules_to_not_convert: Tuple[str, ...] = (),
                      imatrix=None, device="cuda") -> Dict[str, Any]:
    """HF Mixtral tensors -> the parameter dict with [L, E, ...] expert
    stacks (the JAX package's ``convert_hf_params``), each expert
    quantized on `device` as it arrives and written into its stack, or
    kept dense in compute_dtype for a float load."""
    from bigdl_tpu_torch.models.convert_base import make_convert

    return make_convert(_mixtral_map)(
        tensors, cfg, qtype=qtype, compute_dtype=compute_dtype,
        modules_to_not_convert=modules_to_not_convert, imatrix=imatrix,
        device=device)


# the registry's and the low-bit manifest's name of this family
FAMILY = "mixtral"

# scale planes ride through llama's attention block; no forward_paged (the
# JAX family has none)
SUPPORTS_SCALED_KV = True
SUPPORTS_PAGED_KV = False


config_from_hf = MixtralConfig.from_hf


def new_cache(cfg: MixtralConfig, batch: int, max_seq: int,
              per_slot_pos: bool = False, device="cuda",
              kv_cache_dtype: Optional[str] = None) -> KVCache:
    """An empty slab cache for this config in the `kv_cache_dtype`
    storage."""
    return llama_mod.new_cache(cfg, batch, max_seq, per_slot_pos, device,
                               kv_cache_dtype)
