"""Llama-family decoder (counterpart of ``bigdl_tpu/models/llama.py``).

Parameters are a plain dict with the JAX package's layout, every linear
contraction-major ([K, N] dense or QTensor) and per-layer leaves stacked
along a leading L axis::

    {"embed_tokens": [V, D],
     "layers": {"input_layernorm": [L, D], "post_attention_layernorm": [L, D],
                "q_proj" | "k_proj" | "v_proj" | "o_proj" | "gate_proj" |
                "up_proj" | "down_proj" (or merged "qkv_proj" /
                "gate_up_proj"): stacked QTensor or dense,
                sparse-MoE layers instead of the MLP projections:
                "router": [L, D, E] dense, "experts_gate" | "experts_up":
                [L, E, D, F] and "experts_down": [L, E, F, D] stacks},
     "norm": [D],
     "lm_head": [D, V] QTensor or dense (absent when tied)}

A Python loop over layers stands in for ``lax.scan``. The slab KV cache and
the paged arena (``forward_paged``) are updated in place, in any storage
kind of ``ops/kvcache.py`` (bf16, fp8_e5m2, int8/int4 with their scale
planes). Config
features outside the ported serving path (alibi, soft-caps, sliding
windows, parallel or sandwich residuals, scaled rope) raise
NotImplementedError. A layer with a ``router`` runs the sparse-MoE MLP
(``_moe_mlp``), whatever the config says, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from bigdl_tpu_torch.config import flags
from bigdl_tpu_torch.ops.attention import sdp_attention, sdp_attention_paged
from bigdl_tpu_torch.ops.embedding import embedding_lookup
from bigdl_tpu_torch.ops.kvcache import KVCache, init_cache, update_layer
from bigdl_tpu_torch.ops.matmul import linear
from bigdl_tpu_torch.ops.moe_dispatch import moe_mlp_ragged
from bigdl_tpu_torch.ops.norms import rms_norm
from bigdl_tpu_torch.ops.paged import (PagedKVCache, init_paged_cache,
                                       paged_update_layer)
from bigdl_tpu_torch.ops.quant import (QTensor, concat_qtensors_n,
                                       split_qtensor_n)
from bigdl_tpu_torch.ops.rope import apply_rope, rope_cos_sin, rope_freqs


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """The JAX package's config fields; defaults are Llama-2-7B."""
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32
    head_dim: Optional[int] = None
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    rope_scaling_factor: float = 1.0
    max_position_embeddings: int = 4096
    tie_word_embeddings: bool = False
    attention_bias: bool = False
    mlp_bias: bool = False
    sliding_window: Optional[int] = None
    norm_type: str = "rmsnorm"
    rms_weight_offset: float = 0.0
    hidden_act: str = "silu"
    mlp_gated: bool = True
    rope_interleaved: bool = False
    rotary_dim: Optional[int] = None
    use_rope: bool = True
    learned_positions: bool = False
    parallel_residual: bool = False
    shared_input_norm: bool = False
    use_alibi: bool = False
    embed_scale: float = 1.0
    embed_norm: bool = False
    logits_soft_cap: Optional[float] = None
    attn_soft_cap: Optional[float] = None
    lm_head_bias: bool = False
    rope_scaling: Optional[Tuple[Tuple[str, Any], ...]] = None
    sandwich_norms: bool = False
    query_pre_attn_scalar: Optional[float] = None
    alt_sliding_window: bool = False
    num_local_experts: int = 0
    num_experts_per_tok: int = 2

    @property
    def hd(self) -> int:
        return self.head_dim or self.hidden_size // self.num_attention_heads

    @classmethod
    def from_hf(cls, hf: Dict[str, Any]):
        """Build from an HF config dict (config.json of llama, mistral,
        ...), with the JAX package's field mapping."""
        rs = hf.get("rope_scaling") or {}
        factor, rs_tuple = 1.0, None
        if rs:
            rtype = rs.get("rope_type", rs.get("type", "linear"))
            if rtype == "linear":
                factor = float(rs.get("factor", 1.0))
            elif rtype not in ("default", "none"):
                rs_tuple = tuple(sorted(
                    (k, v) for k, v in rs.items()
                    if isinstance(v, (int, float, str))))
        return cls(
            vocab_size=hf["vocab_size"],
            hidden_size=hf["hidden_size"],
            intermediate_size=hf["intermediate_size"],
            num_hidden_layers=hf["num_hidden_layers"],
            num_attention_heads=hf["num_attention_heads"],
            num_key_value_heads=hf.get(
                "num_key_value_heads", hf["num_attention_heads"]),
            head_dim=hf.get("head_dim"),
            rms_norm_eps=hf.get("rms_norm_eps", 1e-5),
            rope_theta=hf.get("rope_theta", 10000.0),
            rope_scaling_factor=factor,
            rope_scaling=rs_tuple,
            max_position_embeddings=hf.get("max_position_embeddings", 4096),
            tie_word_embeddings=hf.get("tie_word_embeddings", False),
            attention_bias=hf.get("attention_bias", False),
            mlp_bias=hf.get("mlp_bias", False),
            sliding_window=hf.get("sliding_window"),
        )


_UNPORTED = (
    ("use_alibi", False), ("sliding_window", None), ("logits_soft_cap", None),
    ("attn_soft_cap", None), ("parallel_residual", False),
    ("sandwich_norms", False), ("rope_scaling", None), ("norm_type", "rmsnorm"),
    ("learned_positions", False), ("embed_norm", False),
    ("mlp_gated", True), ("hidden_act", "silu"), ("use_rope", True),
    ("alt_sliding_window", False), ("query_pre_attn_scalar", None),
)


def check_supported(cfg: LlamaConfig) -> None:
    """Raise for config features the port does not carry yet."""
    for field, default in _UNPORTED:
        if getattr(cfg, field) != default:
            raise NotImplementedError(
                f"bigdl_tpu_torch llama: {field}={getattr(cfg, field)!r} is "
                "not ported yet")


def merge_projections(params: Dict[str, Any], cfg: LlamaConfig
                      ) -> Dict[str, Any]:
    """Fuse q/k/v into one [D, (H+2Hkv)*hd] weight and gate/up into one
    [D, 2F] (bit-exact: block quantization is per column). Skips a group
    whose members are missing, carry biases, or mix qtypes."""
    layers = params.get("layers")
    if not isinstance(layers, dict):
        return params

    def bundle(names):
        ws = [layers.get(nm) for nm in names]
        if any(w is None for w in ws) or any(
                f"{nm}_bias" in layers for nm in names):
            return None
        if all(isinstance(w, QTensor) for w in ws):
            if len({w.qtype for w in ws}) != 1 \
                    or len({w.shape[0] for w in ws}) != 1:
                return None
            return concat_qtensors_n(ws)
        if any(isinstance(w, QTensor) for w in ws):
            return None
        if len({w.dtype for w in ws}) != 1:
            return None
        return torch.cat(ws, dim=-1)

    new = dict(layers)
    changed = False
    for merged, names in (("qkv_proj", ("q_proj", "k_proj", "v_proj")),
                          ("gate_up_proj", ("gate_proj", "up_proj"))):
        w = bundle(names)
        if w is not None:
            new[merged] = w
            for nm in names:
                new.pop(nm)
            changed = True
    if not changed:
        return params
    return {**params, "layers": new}


def unmerge_projections(params: Dict[str, Any], cfg: LlamaConfig
                        ) -> Dict[str, Any]:
    """Inverse of `merge_projections` (exact slicing; each part is made
    contiguous and the merged leaf dropped)."""
    layers = params.get("layers")
    if not isinstance(layers, dict):
        return params

    def split(w, sizes):
        if isinstance(w, QTensor):
            return [QTensor(p.data.contiguous(), p.scale.contiguous(),
                            None if p.zero is None else p.zero.contiguous(),
                            p.qtype, p.shape, p.layout)
                    for p in split_qtensor_n(w, sizes)]
        return [p.contiguous() for p in torch.split(w, list(sizes), dim=-1)]

    new = dict(layers)
    changed = False
    h, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.hd
    for merged, names in (("qkv_proj", ("q_proj", "k_proj", "v_proj")),
                          ("gate_up_proj", ("gate_proj", "up_proj"))):
        if merged not in new:
            continue
        w = new.pop(merged)
        n = w.shape[1] if isinstance(w, QTensor) else w.shape[-1]
        sizes = ((h * hd, hkv * hd, hkv * hd) if merged == "qkv_proj"
                 else (n // 2, n // 2))
        for nm, part in zip(names, split(w, sizes)):
            new[nm] = part
        bias = new.pop(f"{merged}_bias", None)
        if bias is not None:
            for nm, part in zip(names, split(bias, sizes)):
                new[f"{nm}_bias"] = part
        changed = True
    if not changed:
        return params
    return {**params, "layers": new}


def layer_params(layers: Dict[str, Any], i: int) -> Dict[str, Any]:
    """Layer i's slice of the stacked leaves (views, no copies)."""
    return {name: (w.index(i) if isinstance(w, QTensor) else w[i])
            for name, w in layers.items()}


def _lm_head(x: torch.Tensor, params, cfg: LlamaConfig) -> torch.Tensor:
    """Final projection (tied or separate); logits in f32."""
    lm_head = params.get("lm_head")
    if lm_head is None:
        emb = params["embed_tokens"]
        if isinstance(emb, QTensor):             # quantized table is [D, V]
            logits = linear(x, emb)
        else:
            logits = torch.matmul(x.to(torch.float32),
                                  emb.to(x.dtype).to(torch.float32).t())
    else:
        logits = linear(x, lm_head)
    return logits.to(torch.float32)


def _norm(x, w, cfg: LlamaConfig):
    if cfg.rms_weight_offset:
        w = w.to(torch.float32) + cfg.rms_weight_offset
    return rms_norm(x, w, cfg.rms_norm_eps)


def embed_prologue(params, cfg: LlamaConfig, tokens: torch.Tensor,
                   compute_dtype) -> torch.Tensor:
    x = embedding_lookup(params["embed_tokens"], tokens, compute_dtype)
    if cfg.embed_scale != 1.0:
        x = x * torch.tensor(cfg.embed_scale, dtype=compute_dtype)
    return x


def _route(xf: torch.Tensor, router: torch.Tensor, k: int):
    """Router of a sparse-MoE layer: f32 logits of xf [N, D] against the
    [D, E] router, the top-k experts of each row (ties to the lower expert
    index, as lax.top_k: a stable sort) and their f32 softmax weights.
    Returns (topi [N, k] int64, w [N, k] f32)."""
    logits = torch.matmul(xf.to(torch.float32),
                          router.to(xf.dtype).to(torch.float32))
    topv, topi = torch.sort(logits, dim=-1, descending=True, stable=True)
    return topi[:, :k], torch.softmax(topv[:, :k], dim=-1)


def _moe_mlp(hidden: torch.Tensor, lp, cfg: LlamaConfig) -> torch.Tensor:
    """Sparse-MoE MLP (gated experts), the JAX ``_moe_mlp``: route each
    token to its top-k experts, then one of three strategies, none of which
    reads a routing tensor back to the host:

    - gather (N * k <= E, e.g. a small decode step): each token-choice
      takes its expert's planes on the device and runs the quantized
      linears at M = 1 (B1 on the card); the k outputs, weighted in bf16,
      are summed;
    - ragged (``moe_dispatch`` ``ragged``, or ``auto`` off the CPU): the
      sorted dispatch of ``ops/moe_dispatch.py`` through kernel B6;
    - dense (``dense``, or ``auto`` on the CPU): every expert over every
      token, combined by the one-hot routing weights.
    """
    if "experts_up_bias" in lp or "experts_down_bias" in lp:
        raise NotImplementedError("bigdl_tpu_torch: biased expert stacks "
                                  "are not ported")
    b, t, d = hidden.shape
    k, num_e = cfg.num_experts_per_tok, cfg.num_local_experts
    xf = hidden.reshape(-1, d)
    n = xf.shape[0]
    topi, w = _route(xf, lp["router"], k)
    gate_s, up_s, down_s = (lp["experts_gate"], lp["experts_up"],
                            lp["experts_down"])

    def one_expert(x_rows, gw, uw, dw):
        return linear(F.silu(linear(x_rows, gw)) * linear(x_rows, uw), dw)

    if n * k <= num_e:
        ids = topi.reshape(-1)
        gw, uw, dw = (s.take(ids) if isinstance(s, QTensor)
                      else s.index_select(0, ids)
                      for s in (gate_s, up_s, down_s))

        def pick(s, j):
            return s.index(j) if isinstance(s, QTensor) else s[j]

        outs = torch.stack([
            one_expert(xf[j // k][None], pick(gw, j), pick(uw, j),
                       pick(dw, j))[0] for j in range(n * k)])
        y = (outs.reshape(n, k, d) * w[..., None].to(outs.dtype)).sum(dim=1)
        return y.reshape(b, t, d)

    mode = flags().moe_dispatch
    if mode == "ragged" or (mode == "auto" and xf.device.type != "cpu"):
        y = moe_mlp_ragged(xf, topi, w, gate_s, up_s, down_s, F.silu, num_e)
        return y.reshape(b, t, d)

    combine = (F.one_hot(topi, num_e).to(torch.float32)
               * w[..., None]).sum(dim=1)                       # [N, E]
    all_out = torch.stack([
        one_expert(xf, *(s.index(e) if isinstance(s, QTensor) else s[e]
                         for s in (gate_s, up_s, down_s)))
        for e in range(num_e)])                                 # [E, N, D]
    y = torch.einsum("ne,end->nd",
                     combine.to(hidden.dtype).to(torch.float32),
                     all_out.to(torch.float32)).to(hidden.dtype)
    return y.reshape(b, t, d)


def _mlp(hidden: torch.Tensor, lp, cfg: LlamaConfig) -> torch.Tensor:
    if "router" in lp:
        return _moe_mlp(hidden, lp, cfg)
    if "gate_up_proj" in lp:
        gu = linear(hidden, lp["gate_up_proj"])
        f = gu.shape[-1] // 2
        inner = F.silu(gu[..., :f]) * gu[..., f:]
    else:
        inner = F.silu(linear(hidden, lp["gate_proj"])) \
            * linear(hidden, lp["up_proj"])
    return linear(inner, lp["down_proj"])


def _split_qkv(qkv, b, sq, h, hkv, hd):
    """Merged-projection output [B, Sq, (H+2Hkv)*hd] -> q/k/v heads."""
    q = qkv[..., :h * hd].reshape(b, sq, h, hd)
    k = qkv[..., h * hd:(h + hkv) * hd].reshape(b, sq, hkv, hd)
    v = qkv[..., (h + hkv) * hd:].reshape(b, sq, hkv, hd)
    return q, k, v


def _attn_block(hidden, lp, cfg: LlamaConfig, cos, sin, cache, lidx: int,
                block_tables: Optional[torch.Tensor] = None):
    """QKV + rope + cache append + attention + output projection (the
    slab and paged branches of the JAX `_attn_block`). With
    ``block_tables`` the cache is a ``PagedKVCache``: appends scatter
    through the table and attention reads through it. int8/int4 rows are
    quantized on append and attention gets the raw codes with the layer's
    scale planes; fp8_e5m2 codes also go to attention as they are (the
    JAX slab path upcasts them in ``read_layer`` first: the same numbers,
    since e5m2 -> bf16 is exact, without a bf16 copy of the layer)."""
    b, sq, _ = hidden.shape
    h, hkv, hd = cfg.num_attention_heads, cfg.num_key_value_heads, cfg.hd
    if "qkv_proj" in lp:
        q, k, v = _split_qkv(linear(hidden, lp["qkv_proj"]),
                             b, sq, h, hkv, hd)
    else:
        q = linear(hidden, lp["q_proj"]).reshape(b, sq, h, hd)
        k = linear(hidden, lp["k_proj"]).reshape(b, sq, hkv, hd)
        v = linear(hidden, lp["v_proj"]).reshape(b, sq, hkv, hd)
    q = apply_rope(q, cos, sin, interleaved=cfg.rope_interleaved)
    k = apply_rope(k, cos, sin, interleaved=cfg.rope_interleaved)
    scaled = cache.k_scale is not None
    ks = cache.k_scale[lidx] if scaled else None
    vs = cache.v_scale[lidx] if scaled else None
    if block_tables is not None:
        paged_update_layer(cache.k, cache.v, lidx, k, v, cache.pos,
                           block_tables, cache.k_scale, cache.v_scale)
        attn = sdp_attention_paged(q.contiguous(), cache.k[lidx],
                                   cache.v[lidx], block_tables, cache.pos,
                                   k_scale=ks, v_scale=vs)
    else:
        update_layer(cache.k, cache.v, lidx, k, v, cache.pos, cache.k_scale,
                     cache.v_scale)
        attn = sdp_attention(q.contiguous(), cache.k[lidx], cache.v[lidx],
                             cache.pos, k_scale=ks, v_scale=vs)
    return linear(attn.reshape(b, sq, h * hd), lp["o_proj"])


def _decoder_layer(x, lp, cfg: LlamaConfig, cos, sin, cache, lidx: int,
                   block_tables: Optional[torch.Tensor] = None):
    """One block with the sequential residual."""
    hidden = _norm(x, lp["input_layernorm"], cfg)
    x = x + _attn_block(hidden, lp, cfg, cos, sin, cache, lidx,
                        block_tables)
    hidden2 = _norm(x, lp["post_attention_layernorm"], cfg)
    return x + _mlp(hidden2, lp, cfg)


def _run(params, cfg: LlamaConfig, tokens: torch.Tensor, cache,
         compute_dtype, last_only: bool,
         block_tables: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Embedding, the layers over `cache` (written in place) and the
    final norm + lm_head; returns f32 logits."""
    check_supported(cfg)
    sq = tokens.shape[1]
    pos = cache.pos
    dev = tokens.device
    inv_freq = rope_freqs(cfg.hd, cfg.rope_theta, rotary_dim=cfg.rotary_dim,
                          scaling_factor=cfg.rope_scaling_factor, device=dev)
    offs = torch.arange(sq, dtype=torch.int32, device=dev)
    if pos.dim() == 1:                            # per-slot positions
        positions = pos[:, None] + offs[None, :]
        cos, sin = rope_cos_sin(positions, inv_freq)       # [B, Sq, hd/2]
    else:
        positions = pos + offs
        cos, sin = rope_cos_sin(positions[None, :], inv_freq)
    x = embed_prologue(params, cfg, tokens, compute_dtype)
    layers = params["layers"]
    for i in range(cfg.num_hidden_layers):
        x = _decoder_layer(x, layer_params(layers, i), cfg, cos, sin, cache,
                           i, block_tables)
    if last_only:
        x = x[:, -1:, :]
    x = _norm(x, params["norm"], cfg)
    return _lm_head(x, params, cfg)


def forward(params: Dict[str, Any], cfg: LlamaConfig, tokens: torch.Tensor,
            cache: KVCache, compute_dtype=torch.bfloat16,
            last_only: bool = False) -> Tuple[torch.Tensor, KVCache]:
    """Run the model on tokens [B, Sq] at the cache's positions; returns
    (f32 logits [B, Sq or 1, V], cache with pos + Sq). The cache tensors
    are written in place."""
    logits = _run(params, cfg, tokens, cache, compute_dtype, last_only)
    return logits, cache.reset_pos(cache.pos + tokens.shape[1])


def forward_last_token(params, cfg: LlamaConfig, tokens, cache: KVCache,
                       compute_dtype=torch.bfloat16):
    """Prefill variant of `forward` with lm_head on the final position."""
    return forward(params, cfg, tokens, cache, compute_dtype, last_only=True)


def forward_paged(params: Dict[str, Any], cfg: LlamaConfig,
                  tokens: torch.Tensor, cache: PagedKVCache,
                  block_tables: torch.Tensor, compute_dtype=torch.bfloat16,
                  last_only: bool = False
                  ) -> Tuple[torch.Tensor, PagedKVCache]:
    """`forward` over a paged arena: appends scatter through block_tables
    [B, NP] int32 and attention reads through them (B5 for decode on the
    card). Positions are per slot (``cache.pos`` [B]). With
    ``NP * page_size == max_seq`` the logits equal the slab `forward`'s at
    equal positions, bit for bit. The arena is written in place."""
    logits = _run(params, cfg, tokens, cache, compute_dtype, last_only,
                  block_tables)
    return logits, cache.reset_pos(cache.pos + tokens.shape[1])


# -- HF checkpoint -> parameter dict (the JAX package's conversion) ----------

_LAYER_LINEARS = {
    "self_attn.q_proj": "q_proj",
    "self_attn.k_proj": "k_proj",
    "self_attn.v_proj": "v_proj",
    "self_attn.o_proj": "o_proj",
    "mlp.gate_proj": "gate_proj",
    "mlp.up_proj": "up_proj",
    "mlp.down_proj": "down_proj",
}


def _llama_map(acc, name: str, w) -> None:
    """HF llama/mistral-style tensor names -> parameter keys."""
    if name in ("model.embed_tokens.weight", "transformer.wte.weight"):
        acc.top["embed_tokens"] = acc.dense(w)
    elif name == "model.norm.weight":
        acc.top["norm"] = acc.dense(w)
    elif name == "model.norm.bias":
        acc.top["norm_bias"] = acc.dense(w)
    elif name == "lm_head.weight":
        acc.top["lm_head"] = acc.linear(name, w)
    elif name == "lm_head.bias":
        acc.top["lm_head_bias"] = acc.dense(w)
    elif name.startswith("model.layers."):
        parts = name.split(".")
        idx = int(parts[2])
        sub = ".".join(parts[3:-1])   # e.g. self_attn.q_proj
        leaf = parts[-1]              # weight | bias
        if sub in _LAYER_LINEARS:
            key = _LAYER_LINEARS[sub]
            if leaf == "weight":
                acc.put(key, idx, acc.linear(name, w))
            else:
                acc.put(f"{key}_bias", idx, acc.dense(w))
        elif sub in ("input_layernorm", "post_attention_layernorm",
                     "pre_feedforward_layernorm",
                     "post_feedforward_layernorm"):
            acc.put(sub if leaf == "weight" else f"{sub}_bias", idx,
                    acc.dense(w))
        # rotary_emb.inv_freq etc. are derived, skip


def convert_hf_params(tensors, cfg: LlamaConfig,
                      qtype: Optional[str] = "sym_int4",
                      compute_dtype=torch.bfloat16,
                      modules_to_not_convert: Tuple[str, ...] = (),
                      imatrix=None, device="cuda") -> Dict[str, Any]:
    """The parameter dict from HF-named (name, tensor) pairs, each linear
    quantized on `device` as it arrives (``models/convert_base.py``);
    qtype None or a float qtype keeps dense weights in compute_dtype."""
    from bigdl_tpu_torch.models.convert_base import make_convert

    return make_convert(_llama_map)(
        tensors, cfg, qtype=qtype, compute_dtype=compute_dtype,
        modules_to_not_convert=modules_to_not_convert, imatrix=imatrix,
        device=device)


# the registry's and the low-bit manifest's name of this family
FAMILY = "llama"

# this family threads the int8/int4 scale planes through its layers, and
# its forward_paged threads block tables (the JAX package's per-family
# flags, read by the engine)
SUPPORTS_SCALED_KV = True
SUPPORTS_PAGED_KV = True


config_from_hf = LlamaConfig.from_hf


def new_cache(cfg: LlamaConfig, batch: int, max_seq: int,
              per_slot_pos: bool = False, device="cuda",
              kv_cache_dtype: Optional[str] = None) -> KVCache:
    """An empty slab cache for this config, storage "bf16" (default),
    "fp8_e5m2", "int8" or "int4"."""
    return init_cache(cfg.num_hidden_layers, batch, max_seq,
                      cfg.num_key_value_heads, cfg.hd,
                      per_slot_pos=per_slot_pos, device=device,
                      kv_cache_dtype=kv_cache_dtype)


def new_paged_cache(cfg: LlamaConfig, num_pages: int, page_size: int,
                    batch: int, device="cuda",
                    kv_cache_dtype: Optional[str] = None) -> PagedKVCache:
    """An empty page arena for this config (`ops/paged.py` layout) in the
    `kv_cache_dtype` storage."""
    return init_paged_cache(cfg.num_hidden_layers, num_pages, page_size,
                            cfg.num_key_value_heads, cfg.hd, batch,
                            device=device, kv_cache_dtype=kv_cache_dtype)
