"""bigdl_tpu_torch llama forward and serving engine against the JAX
package, on a tiny config with the kernels' geometry (2 layers, hidden
128, 2 heads of hd 64, vocab 256, max_seq 256).

Both packages compute on the same bytes: the JAX package's random
sym_int4 params are carried across by bridge.py. Forward logits agree
within 3e-2; greedy token streams from the port's ``LLMEngine`` equal
those of ``bigdl_tpu.serving.engine.LLMEngine`` for prompts of 5, 40 and
130 tokens; seeded sampling repeats and respects top-k / top-p (its
streams equal the JAX engine's: tests/test_torch_sampling.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.models import llama as jllama
from bigdl_tpu.models.llama import LlamaConfig as JaxLlamaConfig
from bigdl_tpu.serving.engine import EngineConfig as JaxEngineConfig
from bigdl_tpu.serving.engine import LLMEngine as JaxLLMEngine
from bigdl_tpu.serving.engine import SamplingParams as JaxSamplingParams
from bigdl_tpu.utils.testing import SyntheticCausalLM as JaxSyntheticLM
from bigdl_tpu.utils.testing import random_llama_params as jax_random_params
from bigdl_tpu_torch import bridge
from bigdl_tpu_torch.models import llama as tllama
from bigdl_tpu_torch.models.llama import LlamaConfig
from bigdl_tpu_torch.serving.engine import (EngineConfig, LLMEngine,
                                            SamplingParams, sample_rows)
from bigdl_tpu_torch.utils.testing import (LLAMA2_7B, TINY_LLAMA,
                                           SyntheticCausalLM,
                                           random_llama_params)

GEOM = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=2,
            num_key_value_heads=2, max_position_embeddings=256)
MAX_SEQ = 256
PROMPT_LENS = (5, 40, 130)


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = JaxLlamaConfig(**GEOM), LlamaConfig(**GEOM)
    jp = jllama.merge_projections(
        jax_random_params(jcfg, "sym_int4", seed=0), jcfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp),
                                  device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, GEOM["vocab_size"], n).tolist()
            for n in PROMPT_LENS]


@pytest.mark.parametrize("n,pos0", [(40, 0), (130, 0), (1, 77)])
def test_forward_logits_match_jax(models, n, pos0):
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(n)
    toks = rng.integers(0, 256, (2, n)).astype(np.int32)
    jc = jllama.new_cache(jcfg, 2, MAX_SEQ)
    tc = tllama.new_cache(tcfg, 2, MAX_SEQ, device="cpu")
    if pos0:
        pre = rng.integers(0, 256, (2, pos0)).astype(np.int32)
        _, jc = jllama.forward(jp, jcfg, jnp.asarray(pre), jc)
        _, tc = tllama.forward(tp, tcfg, torch.from_numpy(pre), tc)
    jl, jc = jllama.forward(jp, jcfg, jnp.asarray(toks), jc)
    tl, tc = tllama.forward(tp, tcfg, torch.from_numpy(toks), tc)
    assert tl.shape == (2, n, 256) and tl.dtype == torch.float32
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=3e-2,
                               atol=3e-2)
    assert int(tc.pos) == int(jc.pos) == pos0 + n
    np.testing.assert_allclose(tc.k.float().numpy(),
                               np.asarray(jc.k, np.float32), atol=3e-2)


def test_forward_last_token_matches_jax(models):
    """The prefill variant returns only the last position's logits, and
    fills the cache as the full forward does."""
    jcfg, jp, tcfg, tp = models
    toks = np.random.default_rng(5).integers(0, 256, (2, 40)).astype(
        np.int32)
    jl, jc = jllama.forward_last_token(jp, jcfg, jnp.asarray(toks),
                                       jllama.new_cache(jcfg, 2, MAX_SEQ))
    tl, tc = tllama.forward_last_token(
        tp, tcfg, torch.from_numpy(toks),
        tllama.new_cache(tcfg, 2, MAX_SEQ, device="cpu"))
    assert tl.shape == (2, 1, 256)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=3e-2,
                               atol=3e-2)
    assert int(tc.pos) == int(jc.pos) == 40


def test_merged_and_split_projections_agree(models):
    jcfg, _, tcfg, _ = models
    split = bridge.params_from_numpy(jax.tree.map(
        np.asarray, jax_random_params(jcfg, "sym_int4", seed=3)),
        device="cpu")
    merged = tllama.merge_projections(split, tcfg)
    assert "qkv_proj" in merged["layers"] and "q_proj" in split["layers"]
    toks = torch.arange(24).reshape(1, 24)
    a, _ = tllama.forward(split, tcfg, toks,
                          tllama.new_cache(tcfg, 1, 64, device="cpu"))
    b, _ = tllama.forward(merged, tcfg, toks,
                          tllama.new_cache(tcfg, 1, 64, device="cpu"))
    np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.fixture(scope="module")
def jax_greedy(models, prompts):
    jcfg, jp, _, _ = models
    eng = JaxLLMEngine(JaxSyntheticLM(jp, jcfg),
                       JaxEngineConfig(max_batch=4, max_seq=MAX_SEQ))
    return eng.generate(prompts, JaxSamplingParams(max_tokens=12))


def test_engine_greedy_streams_equal_jax_engine(models, prompts,
                                                jax_greedy):
    _, _, tcfg, tp = models
    eng = LLMEngine(SyntheticCausalLM(tp, tcfg),
                    EngineConfig(max_batch=4, max_seq=MAX_SEQ),
                    device="cpu")
    got = eng.generate(prompts, SamplingParams(max_tokens=12))
    assert got == jax_greedy
    assert not eng.has_unfinished()


def test_engine_slot_reuse_and_chunked_prefill(models, prompts, jax_greedy):
    """Two slots for three requests, 32-token prefill chunks (the 130-token
    prompt admits over five steps): streams are unchanged."""
    _, _, tcfg, tp = models
    eng = LLMEngine(SyntheticCausalLM(tp, tcfg),
                    EngineConfig(max_batch=2, max_seq=MAX_SEQ,
                                 prefill_chunk=32), device="cpu")
    assert eng.generate(prompts, SamplingParams(max_tokens=12)) == jax_greedy


def test_engine_seeded_sampling_repeats(models, prompts):
    _, _, tcfg, tp = models
    sp = SamplingParams(max_tokens=10, temperature=0.8, top_k=40, top_p=0.95,
                        seed=1234)

    def run(p):
        eng = LLMEngine(SyntheticCausalLM(tp, tcfg),
                        EngineConfig(max_batch=4, max_seq=MAX_SEQ),
                        device="cpu")
        return eng.generate(prompts, p)

    a, b = run(sp), run(sp)
    assert a == b
    assert all(len(t) == 10 for t in a)
    c = run(dataclasses.replace(sp, seed=4321))
    assert c != a


def test_engine_stop_tokens_and_outputs(models, prompts, jax_greedy):
    _, _, tcfg, tp = models
    eng = LLMEngine(SyntheticCausalLM(tp, tcfg),
                    EngineConfig(max_batch=4, max_seq=MAX_SEQ), device="cpu")
    stop = jax_greedy[0][3]
    eng.add_request("a", prompts[0], SamplingParams(
        max_tokens=12, stop_token_ids=(stop,)))
    toks, reason = [], None
    while eng.has_unfinished():
        eng.step()
        for o in eng.get_outputs("a"):
            toks += o.new_token_ids
            reason = o.finish_reason if o.finished else reason
    assert reason == "stop" and toks[-1] == stop
    assert toks == jax_greedy[0][:jax_greedy[0].index(stop) + 1]
    with pytest.raises(ValueError):
        eng.add_request("b", [], SamplingParams())
    with pytest.raises(ValueError):
        eng.add_request("c", [999], SamplingParams())
    with pytest.raises(ValueError):
        eng.add_request("d", list(range(10)) * 30, SamplingParams())


def test_sampler_respects_top_k_and_top_p():
    rng = np.random.default_rng(5)
    lg = torch.from_numpy(rng.standard_normal((6, 50)).astype(np.float32))
    temps = torch.tensor([0.0, 1.0, 1.0, 0.7, 1.5, 1.0])
    top_ks = torch.tensor([0, 3, 0, 5, 1, 0])
    top_ps = torch.tensor([1.0, 1.0, 0.3, 0.9, 1.0, 0.0])
    for pos in range(40):
        toks = sample_rows(lg, temps, top_ks, top_ps, [7] * 6,
                           [pos] * 6).tolist()
        order = torch.argsort(lg, dim=-1, descending=True)
        assert toks[0] == int(lg[0].argmax())            # greedy row
        assert toks[1] in order[1, :3].tolist()           # top-k 3
        assert toks[4] == int(order[4, 0])                # top-k 1
        assert toks[5] == int(order[5, 0])                # top-p 0: top-1
        p = torch.softmax(lg[2] / 1.0, -1)[order[2]]
        keep = int(((torch.cumsum(p, 0) - p) < 0.3).sum())
        assert toks[2] in order[2, :keep].tolist()        # nucleus
        assert toks[3] in order[3, :5].tolist()
        again = sample_rows(lg, temps, top_ks, top_ps, [7] * 6, [pos] * 6)
        assert again.tolist() == toks                     # (seed, pos) replay


def test_random_params_seeded_and_layer_stacked():
    a = random_llama_params(TINY_LLAMA, "sym_int4", seed=3, device="cpu")
    b = random_llama_params(TINY_LLAMA, "sym_int4", seed=3, device="cpu")
    qkv = a["layers"]["q_proj"]
    assert qkv.data.shape == (2, 32, 64) and qkv.shape == (64, 64)
    assert torch.equal(qkv.data, b["layers"]["q_proj"].data)
    assert a["embed_tokens"].dtype == torch.bfloat16
    assert LLAMA2_7B.hidden_size == 4096 and LLAMA2_7B.hd == 128
    toks = torch.arange(10).reshape(1, 10)
    lg, cache = tllama.forward(a, TINY_LLAMA, toks, tllama.new_cache(
        TINY_LLAMA, 1, 32, device="cpu"))
    assert torch.isfinite(lg).all() and int(cache.pos) == 10


@pytest.mark.parametrize("field,value", [
    ("use_alibi", True), ("sliding_window", 16), ("parallel_residual", True),
    ("sandwich_norms", True), ("logits_soft_cap", 30.0)])
def test_unported_config_features_raise(models, field, value):
    _, _, tcfg, tp = models
    cfg = dataclasses.replace(tcfg, **{field: value})
    with pytest.raises(NotImplementedError, match=field):
        tllama.forward(tp, cfg, torch.zeros(1, 2, dtype=torch.int64),
                       tllama.new_cache(tcfg, 1, 8, device="cpu"))
