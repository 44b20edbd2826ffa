"""bigdl_tpu_torch's sparse-MoE slice against the JAX package: the plain
version of kernel B6 (ragged expert matmul), the ragged dispatch, the three
strategies of ``_moe_mlp``, the Mixtral forward and the engine serving it.

The JAX side runs as its own CPU tests run it: ``ragged_expert_matmul``
in interpret mode, and the ragged dispatch forced with
``set_flags(moe_dispatch="ragged")`` (auto takes the dense combine off the
TPU). The port's side takes the same mode from
``BIGDL_TPU_TORCH_MOE_DISPATCH``. Weights are the JAX package's, carried
across by bridge.py, so both packages compute on the same bytes. The
config is tileable by the TPU kernel (D 128, F 256), 2 layers, top-2 of 4
or 8 experts.

Tolerances: B6's plain version within one bf16 ulp of the interpret run
(both sum f32 products and round once; only the order differs; values
under 2**-16 of the output's range are held at that scale); MLP
outputs within 5e-2 (the JAX suite's, tests/test_moe_dispatch.py); logits
within 3e-2 (as tests/test_torch_engine.py); token streams equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.config import set_flags
from bigdl_tpu.models import llama as jllama
from bigdl_tpu.models import mixtral as jmx
from bigdl_tpu.models.mixtral import MixtralConfig as JaxMixtralConfig
from bigdl_tpu.ops.pallas import moe_dispatch as jmoe
from bigdl_tpu.ops.quant import quantize as jquantize
from bigdl_tpu.serving.engine import EngineConfig as JaxEngineConfig
from bigdl_tpu.serving.engine import LLMEngine as JaxLLMEngine
from bigdl_tpu.serving.engine import SamplingParams as JaxSamplingParams
from bigdl_tpu.utils.testing import random_mixtral_params as jax_random_mixtral
from bigdl_tpu_torch import bridge
from bigdl_tpu_torch.models import llama as tllama
from bigdl_tpu_torch.models import mixtral as tmx
from bigdl_tpu_torch.models.mixtral import MixtralConfig
from bigdl_tpu_torch.ops.cuda.moe_dispatch import (TOKEN_TILE,
                                                   plain_ragged_expert_matmul,
                                                   ragged_expert_matmul)
from bigdl_tpu_torch.ops.moe_dispatch import moe_mlp_ragged, ragged_routing
from bigdl_tpu_torch.ops.quant import QTensor
from bigdl_tpu_torch.serving.engine import (EngineConfig, LLMEngine,
                                            SamplingParams)
from bigdl_tpu_torch.utils.testing import (MIXTRAL_8X7B, SyntheticCausalLM,
                                           random_mixtral_params)

D, F = 128, 256
GEOM = dict(vocab_size=256, hidden_size=D, intermediate_size=F,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=256,
            num_experts_per_tok=2)
MAX_SEQ = 128
MIXTRAL_HF = {       # mistralai/Mixtral-8x7B-v0.1 config.json
    "vocab_size": 32000, "hidden_size": 4096, "intermediate_size": 14336,
    "num_hidden_layers": 32, "num_attention_heads": 32,
    "num_key_value_heads": 8, "rms_norm_eps": 1e-5, "rope_theta": 1e6,
    "max_position_embeddings": 32768, "sliding_window": None,
    "tie_word_embeddings": False, "num_local_experts": 8,
    "num_experts_per_tok": 2}


@pytest.fixture
def dispatch(monkeypatch):
    """Set both packages' MoE dispatch mode for one test."""
    def set_mode(mode):
        monkeypatch.setenv("BIGDL_TPU_TORCH_MOE_DISPATCH", mode)
        set_flags(moe_dispatch=mode)
        jax.clear_caches()
    yield set_mode
    set_flags(moe_dispatch="auto")
    jax.clear_caches()


def _to_port(tree):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, tree),
                                    device="cpu")


def _jstack(rng, e, k, n, qtype, scale=0.05):
    """[E, K, N] JAX stack (QTensor or bf16) from seeded numpy weights."""
    ws = [jnp.asarray(rng.standard_normal((k, n)).astype(np.float32) * scale)
          for _ in range(e)]
    if qtype is None:
        return jnp.stack(ws).astype(jnp.bfloat16)
    return jax.tree.map(lambda *xs: jnp.stack(xs),
                        *[jquantize(w, qtype) for w in ws])


def _bf16_ulp(a: np.ndarray) -> np.ndarray:
    """One bf16 ulp at |a| (the spacing of bf16 values there)."""
    e = np.floor(np.log2(np.maximum(np.abs(a), np.finfo(np.float32).tiny)))
    return np.exp2(e - 7)


def _pairs_with_counts(rng, counts3, n_tok):
    """topi [n_tok, 2] over experts 0..2 (expert 3 unused) with the given
    per-expert counts: pairs (0,1), (0,2), (1,2) a, b, c times."""
    c0, c1, c2 = counts3
    a = (c0 + c1 - c2) // 2
    b, c = c0 - a, c1 - a
    pairs = [(0, 1)] * a + [(0, 2)] * b + [(1, 2)] * c
    assert len(pairs) == n_tok
    topi = np.asarray(pairs, np.int32)[rng.permutation(n_tok)]
    flip = rng.random(n_tok) < 0.5
    topi[flip] = topi[flip][:, ::-1]
    return topi


# -- B6 plain version ------------------------------------------------------


@pytest.mark.parametrize("qtype", [None, "sym_int4", "asym_int4", "sym_int8",
                                   "nf4"])
def test_ragged_matmul_plain_matches_interpret(qtype):
    rng = np.random.default_rng(3)
    t = TOKEN_TILE
    x = rng.standard_normal((4 * t, D)).astype(np.float32) * 0.3
    jw = _jstack(rng, 4, D, F, qtype)
    tile_e = np.asarray([2, 0, 3, 3], np.int32)
    want = np.asarray(jmoe.ragged_expert_matmul(
        jnp.asarray(x, jnp.bfloat16), jw, jnp.asarray(tile_e),
        interpret=True), np.float32)
    tw = _to_port(jw)
    got = plain_ragged_expert_matmul(torch.from_numpy(x).to(torch.bfloat16),
                                     tw, torch.from_numpy(tile_e))
    assert got.dtype == torch.bfloat16 and got.shape == (4 * t, F)
    got = got.float().numpy()
    # one ulp at the value; below 2**-16 of the output's range the two
    # f32 sums' different order shows through cancellation, so the ulp is
    # taken at that floor there
    floor = np.abs(want).max() * 2.0 ** -16
    ulp = _bf16_ulp(np.maximum(np.maximum(np.abs(got), np.abs(want)),
                               floor))
    assert np.all(np.abs(got - want) <= ulp), float(
        np.max(np.abs(got - want) / ulp))
    # the wrapper takes the plain version for CPU tensors
    again = ragged_expert_matmul(torch.from_numpy(x).to(torch.bfloat16), tw,
                                 torch.from_numpy(tile_e),
                                 torch.full((4,), t, dtype=torch.int32))
    np.testing.assert_array_equal(again.float().numpy(), got)


def test_ragged_wrapper_raises_off_cpu_and_cuda():
    rng = np.random.default_rng(4)
    w = _to_port(_jstack(rng, 2, D, F, "sym_int4"))
    meta_w = QTensor(w.data.to("meta"), w.scale.to("meta"), None, w.qtype,
                     w.shape)
    x = torch.empty((TOKEN_TILE, D), dtype=torch.bfloat16, device="meta")
    te = torch.zeros((1,), dtype=torch.int32, device="meta")
    rows = torch.full((1,), 3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ragged_expert_matmul(x, meta_w, te, rows)
    dense = torch.empty((2, D, F), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        ragged_expert_matmul(x, dense, te, rows)


# -- ragged dispatch -------------------------------------------------------


def _jax_routing(topi, num_experts):
    """dest / tile_expert as the JAX package's moe_mlp_ragged computes
    them (bigdl_tpu/ops/pallas/moe_dispatch.py:233-260)."""
    n, k = topi.shape
    t = jmoe.TOKEN_TILE
    nk_tot = n * k
    np_ = -(-(nk_tot + num_experts * (t - 1)) // t) * t
    flat_e = topi.reshape(-1)
    order = jnp.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    counts = jnp.bincount(flat_e, length=num_experts)
    padded = -(-counts // t) * t
    starts = jnp.cumsum(padded) - padded
    group_start = jnp.cumsum(counts) - counts
    ranks = jnp.arange(nk_tot) - group_start[sorted_e]
    dest = starts[sorted_e] + ranks
    tile_first = jnp.arange(np_ // t, dtype=jnp.int32) * t
    tile_expert = jnp.searchsorted(jnp.cumsum(padded), tile_first,
                                   side="right").astype(jnp.int32)
    tile_expert = jnp.minimum(tile_expert, num_experts - 1)
    return np.asarray(dest), np.asarray(tile_expert), np_


@pytest.mark.parametrize("counts", [(127, 128, 129), (129, 128, 127),
                                    (40, 100, 60)])
def test_moe_mlp_ragged_matches_jax(counts):
    """Skewed routing over experts 0-2, expert 3 empty, groups of 127, 128
    and 129 rows (one region spans two tiles; trailing tiles hold none)."""
    rng = np.random.default_rng(sum(counts))
    n = sum(counts) // 2
    topi = _pairs_with_counts(rng, counts, n)
    e = 4
    jdest, jte, np_ = _jax_routing(jnp.asarray(topi), e)
    r = ragged_routing(torch.from_numpy(topi), e)
    assert r.np_ == np_
    np.testing.assert_array_equal(r.dest.numpy(), jdest)
    np.testing.assert_array_equal(r.tile_expert.numpy(), jte)
    # real rows: a prefix of each expert's region
    rows = np.zeros(np_ // TOKEN_TILE, np.int64)
    for row in jdest:
        rows[row // TOKEN_TILE] += 1
    np.testing.assert_array_equal(r.tile_rows.numpy(), rows)

    xf = rng.standard_normal((n, D)).astype(np.float32) * 0.3
    topw = rng.random((n, 2)).astype(np.float32)
    topw /= topw.sum(-1, keepdims=True)
    jg, ju, jd = (_jstack(rng, e, D, F, "sym_int4"),
                  _jstack(rng, e, D, F, "sym_int4"),
                  _jstack(rng, e, F, D, "sym_int4"))
    want = jmoe.moe_mlp_ragged(jnp.asarray(xf, jnp.bfloat16),
                               jnp.asarray(topi), jnp.asarray(topw), jg, ju,
                               jd, jax.nn.silu, e, interpret=True)
    got = moe_mlp_ragged(torch.from_numpy(xf).to(torch.bfloat16),
                         torch.from_numpy(topi), torch.from_numpy(topw),
                         _to_port(jg), _to_port(ju), _to_port(jd),
                         torch.nn.functional.silu, e)
    assert got.dtype == torch.bfloat16 and got.shape == (n, D)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=5e-2, atol=5e-2)


def _moe_layer(rng, e, qtype="sym_int4"):
    lp = {"router": jnp.asarray(rng.standard_normal((D, e)).astype(
        np.float32) * 0.1).astype(jnp.bfloat16),
          "experts_gate": _jstack(rng, e, D, F, qtype),
          "experts_up": _jstack(rng, e, D, F, qtype),
          "experts_down": _jstack(rng, e, F, D, qtype)}
    return lp, _to_port(lp)


@pytest.mark.parametrize("strategy,tokens,mode,qtype", [
    ("gather", 3, "auto", "sym_int4"), ("gather", 4, "dense", "sym_int4"),
    ("ragged", 48, "ragged", "sym_int4"), ("dense", 48, "dense", "sym_int4"),
    ("dense", 48, "auto", "sym_int4"), ("gather", 3, "auto", None),
    ("ragged", 48, "ragged", None), ("dense", 48, "auto", None)])
def test_moe_mlp_strategies_match_jax(dispatch, strategy, tokens, mode,
                                      qtype):
    """N * k <= E gathers whatever the mode; otherwise `ragged` runs the
    sorted dispatch and `dense` (and `auto` on the CPU) the combine; over
    sym_int4 and dense bf16 expert stacks."""
    e = 8
    rng = np.random.default_rng(tokens)
    jlp, tlp = _moe_layer(rng, e, qtype)
    jcfg = jllama.LlamaConfig(**{**GEOM, "num_local_experts": e})
    tcfg = tllama.LlamaConfig(**{**GEOM, "num_local_experts": e})
    hidden = rng.standard_normal((1, tokens, D)).astype(np.float32) * 0.2
    dispatch(mode)
    want = np.asarray(jllama._moe_mlp(jnp.asarray(hidden, jnp.bfloat16),
                                      jlp, jcfg), np.float32)
    got = tllama._moe_mlp(torch.from_numpy(hidden).to(torch.bfloat16), tlp,
                          tcfg)
    assert got.shape == (1, tokens, D) and got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=5e-2,
                               atol=5e-2)


def test_moe_mlp_top_k_ties_go_to_the_lower_expert(dispatch):
    """A router with equal logits for every expert picks experts 0 and 1,
    as lax.top_k does."""
    e = 8
    rng = np.random.default_rng(9)
    jlp, tlp = _moe_layer(rng, e)
    tlp["router"] = torch.zeros_like(tlp["router"])
    jlp = {**jlp, "router": jnp.zeros_like(jlp["router"])}
    tcfg = tllama.LlamaConfig(**{**GEOM, "num_local_experts": e})
    jcfg = jllama.LlamaConfig(**{**GEOM, "num_local_experts": e})
    hidden = rng.standard_normal((1, 2, D)).astype(np.float32) * 0.2
    got = tllama._moe_mlp(torch.from_numpy(hidden).to(torch.bfloat16), tlp,
                          tcfg)
    want = jllama._moe_mlp(jnp.asarray(hidden, jnp.bfloat16), jlp, jcfg)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=5e-2,
                               atol=5e-2)


# -- Mixtral forward -------------------------------------------------------


@pytest.fixture(scope="module")
def mixtral4():
    """2-layer Mixtral, 4 experts, sym_int4, JAX params and their bridge."""
    jcfg = JaxMixtralConfig(**{**GEOM, "num_local_experts": 4})
    tcfg = MixtralConfig(**{**GEOM, "num_local_experts": 4})
    jp = jax_random_mixtral(jcfg, "sym_int4", seed=0)
    return jcfg, jp, tcfg, _to_port(jp)


@pytest.mark.parametrize("mode,n,pos0", [("auto", 40, 0), ("ragged", 40, 0),
                                         ("auto", 1, 33), ("ragged", 6, 20)])
def test_mixtral_forward_matches_jax(dispatch, mixtral4, mode, n, pos0):
    jcfg, jp, tcfg, tp = mixtral4
    dispatch(mode)
    rng = np.random.default_rng(n + pos0)
    toks = rng.integers(0, 256, (2, n)).astype(np.int32)
    jc = jmx.new_cache(jcfg, 2, MAX_SEQ)
    tc = tmx.new_cache(tcfg, 2, MAX_SEQ, device="cpu")
    if pos0:
        pre = rng.integers(0, 256, (2, pos0)).astype(np.int32)
        _, jc = jmx.forward(jp, jcfg, jnp.asarray(pre), jc)
        _, tc = tmx.forward(tp, tcfg, torch.from_numpy(pre), tc)
    jl, jc = jmx.forward(jp, jcfg, jnp.asarray(toks), jc)
    tl, tc = tmx.forward(tp, tcfg, torch.from_numpy(toks), tc)
    assert tl.shape == (2, n, 256) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=3e-2,
                               atol=3e-2)
    assert int(tc.pos) == int(jc.pos) == pos0 + n


def test_mixtral_forward_last_token_matches_jax(mixtral4):
    jcfg, jp, tcfg, tp = mixtral4
    toks = np.random.default_rng(5).integers(0, 256, (2, 24)).astype(
        np.int32)
    jl, jc = jmx.forward_last_token(jp, jcfg, jnp.asarray(toks),
                                    jmx.new_cache(jcfg, 2, MAX_SEQ))
    tl, tc = tmx.forward_last_token(
        tp, tcfg, torch.from_numpy(toks),
        tmx.new_cache(tcfg, 2, MAX_SEQ, device="cpu"))
    assert tl.shape == (2, 1, 256)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=3e-2,
                               atol=3e-2)
    assert int(tc.pos) == int(jc.pos) == 24


def test_merged_qkv_mixtral_is_bit_equal(mixtral4):
    _, _, tcfg, tp = mixtral4
    merged = tllama.merge_projections(tp, tcfg)
    assert "qkv_proj" in merged["layers"] and "router" in merged["layers"]
    toks = torch.arange(20).reshape(1, 20)
    a, _ = tmx.forward(tp, tcfg, toks, tmx.new_cache(tcfg, 1, 32,
                                                     device="cpu"))
    b, _ = tmx.forward(merged, tcfg, toks, tmx.new_cache(tcfg, 1, 32,
                                                         device="cpu"))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_bridge_carries_expert_stacks_byte_for_byte(mixtral4):
    _, jp, _, tp = mixtral4
    for name in ("experts_gate", "experts_up", "experts_down"):
        jw, tw = jp["layers"][name], tp["layers"][name]
        assert tw.data.shape == jw.data.shape and tw.shape == tuple(jw.shape)
        np.testing.assert_array_equal(tw.data.numpy(), np.asarray(jw.data))
        np.testing.assert_array_equal(
            tw.scale.view(torch.int16).numpy(),
            np.asarray(jw.scale).view(np.int16))
        layer = tw.index(1)                       # [E, ...] of layer 1
        picked = layer.take(torch.tensor([3, 0]))
        assert torch.equal(picked.index(0).data, layer.data[3])
        assert torch.equal(picked.index(1).scale, layer.scale[0])
        assert layer.plane_strides() == (layer.data[0].numel(),
                                         layer.scale[0].numel())
    np.testing.assert_array_equal(
        tp["layers"]["router"].view(torch.int16).numpy(),
        np.asarray(jp["layers"]["router"]).view(np.int16))


def test_config_and_random_params():
    jcfg = JaxMixtralConfig.from_hf(MIXTRAL_HF)
    tcfg = MixtralConfig.from_hf(MIXTRAL_HF)
    for f in dataclasses.fields(tcfg):
        assert getattr(tcfg, f.name) == getattr(jcfg, f.name), f.name
    assert tcfg == MIXTRAL_8X7B and MIXTRAL_8X7B.hd == 128
    tiny = MixtralConfig(**{**GEOM, "num_local_experts": 4})
    a = random_mixtral_params(tiny, "sym_int4", seed=2, device="cpu")
    b = random_mixtral_params(tiny, "sym_int4", seed=2, device="cpu")
    g = a["layers"]["experts_gate"]
    assert g.data.shape == (2, 4, D // 2, F) and g.shape == (D, F)
    assert a["layers"]["experts_down"].data.shape == (2, 4, F // 2, D)
    assert a["layers"]["router"].shape == (2, D, 4)
    assert torch.equal(g.data, b["layers"]["experts_gate"].data)
    assert not torch.equal(g.data[0, 0], g.data[0, 1])
    lg, cache = tmx.forward(a, tiny, torch.arange(10).reshape(1, 10),
                            tmx.new_cache(tiny, 1, 32, device="cpu"))
    assert torch.isfinite(lg).all() and int(cache.pos) == 10


# -- engine ----------------------------------------------------------------


class _JaxMixtral:
    def __init__(self, params, cfg):
        self.params, self.config = params, cfg
        self.hf_config = {"eos_token_id": None}

    class family:
        name = "mixtral"
        forward = staticmethod(jmx.forward)
        prefill = staticmethod(jmx.forward_last_token)
        new_cache = staticmethod(jmx.new_cache)


def _engine_requests():
    """Two greedy requests and one seeded. The seeded one samples the whole
    vocabulary: a top-k or top-p cut is discontinuous, and a token at its
    edge (two logits within the packages' bf16 noise) could leave one
    engine's candidate set and not the other's."""
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, 256, n).tolist() for n in (5, 20, 9)]
    params = [SamplingParams(max_tokens=8),
              SamplingParams(max_tokens=8, temperature=0.8, seed=1234),
              SamplingParams(max_tokens=8)]
    return prompts, params


@pytest.mark.parametrize("max_batch,mode", [(2, "auto"), (4, "ragged")])
def test_engine_streams_equal_jax_engine(dispatch, mixtral4, max_batch,
                                         mode):
    """At max_batch 2 decode gathers (N * k = 4 <= E); at 4 with `ragged`
    it runs the sorted dispatch (B6's plain version)."""
    jcfg, jp, tcfg, tp = mixtral4
    dispatch(mode)
    prompts, params = _engine_requests()
    jeng = JaxLLMEngine(_JaxMixtral(jp, jcfg),
                        JaxEngineConfig(max_batch=max_batch, max_seq=MAX_SEQ))
    teng = LLMEngine(SyntheticCausalLM(tp, tcfg, family=tmx),
                     EngineConfig(max_batch=max_batch, max_seq=MAX_SEQ),
                     device="cpu")
    for i, (p, sp) in enumerate(zip(prompts, params)):
        jeng.add_request(f"r{i}", p, JaxSamplingParams(
            max_tokens=sp.max_tokens, temperature=sp.temperature,
            top_k=sp.top_k, top_p=sp.top_p, seed=sp.seed))
        teng.add_request(f"r{i}", p, sp)
    streams = []
    for eng in (jeng, teng):
        toks = {f"r{i}": [] for i in range(len(prompts))}
        while eng.has_unfinished():
            eng.step()
            for rid in toks:
                for o in eng.get_outputs(rid):
                    toks[rid] += o.new_token_ids
        streams.append(toks)
    assert streams[1] == streams[0]
    assert all(len(v) == 8 for v in streams[1].values())


def test_paged_engine_refuses_mixtral(mixtral4):
    _, _, tcfg, tp = mixtral4
    with pytest.raises(ValueError, match="SUPPORTS_PAGED_KV"):
        LLMEngine(SyntheticCausalLM(tp, tcfg, family=tmx),
                  EngineConfig(max_batch=2, max_seq=MAX_SEQ,
                               kv_page_size=16), device="cpu")
