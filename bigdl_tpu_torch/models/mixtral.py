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
paged mode refuses it. Training (``forward_train``) and checkpoint
conversion (``convert_hf_params``) are not ported.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

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
    return logits, KVCache(cache.k, cache.v, cache.pos + tokens.shape[1])


def forward_last_token(params, cfg: MixtralConfig, tokens, cache: KVCache,
                       compute_dtype=torch.bfloat16):
    """Prefill variant of `forward` with lm_head on the final position."""
    return forward(params, cfg, tokens, cache, compute_dtype, last_only=True)


# no forward_paged (the JAX family has none)
SUPPORTS_PAGED_KV = False


def new_cache(cfg: MixtralConfig, batch: int, max_seq: int,
              per_slot_pos: bool = False, device="cuda") -> KVCache:
    """An empty bf16 slab cache for this config."""
    return llama_mod.new_cache(cfg, batch, max_seq, per_slot_pos, device)
