"""bigdl_tpu_torch's offline generation (``generation.py``,
``TpuCausalLM.generate`` / ``generate_stream``) and its random bits
(``ops/random.py``: ``split``, ``categorical``) against the JAX package.

Sampling pieces must equal the JAX package's bit for bit on seeded numpy
inputs: ``token_counts``, ``apply_penalties``, ``filter_logits`` and
``sample_token`` against the JAX functions jitted as its ``Generator``
jits them (a division by a static constant is a multiply by its f32
reciprocal there), ``split`` and the words under ``categorical`` against
``jax.random`` (JAX 0.9, partitionable threefry); the draws themselves
must be equal too (tolerance: none; the two logs of the gumbel transform
may differ by one f32 ulp, which none of these inputs meets).

Greedy ``Generator`` streams must equal the JAX ``Generator``'s for sym_int4
and dense bf16 weights under all four KV kinds, at bs 1 with no padding
(a 16-token prompt fills its bucket) and at bs 3 with padding (11
tokens: the pad repair), and with an EOS stop; seeded, sampled and
penalized streams must equal too. The models are one tiny random
``transformers`` Llama saved in bf16 and loaded by both packages'
``from_pretrained``. Its logits are bf16 values of a flat distribution,
and the two packages round their bf16 activations in other places (most
logits of a step differ by at most one or two bf16 ulps), so a step
whose two best logits lie within that distance can split any two
implementations' streams (one such step: vocab 256, a 3-row batch from
``default_rng(0)``, row 0's top two at 0.6875 / 0.6875). The prompts are
rows on which no step of any of the eight models ties: rows drawn from
the listed seeds of ``default_rng``, each run at bs 1 against all eight
first. Sampling meets the same ulps at the top-k and top-p edges (the
40th and 41st of 256 flat logits lie about one ulp apart) and in the
gumbel argmax: of sampler seeds 0-7 on these prompts, 4 at bf16 KV
(0-3) and 4 at int8 KV (0, 1, 5, 7) give equal sampled and penalized
streams; the comparisons use seed 1, one of both sets.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import transformers

from bigdl_tpu import generation as jgen
from bigdl_tpu.transformers.model import \
    AutoModelForCausalLM as JaxAutoModel
from bigdl_tpu_torch import generation as tgen
from bigdl_tpu_torch.ops import random as rnd
from bigdl_tpu_torch.transformers.model import AutoModelForCausalLM
from torch_threads import one_intra_op_thread  # noqa: F401

HF = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
          num_hidden_layers=2, num_attention_heads=2, num_key_value_heads=2,
          max_position_embeddings=256, eos_token_id=255)
MAX_SEQ = 64
NEW = 12
WEIGHTS = ("sym_int4", "bf16")
KV_KINDS = ("bf16", "fp8_e5m2", "int8", "int4")
# prompt rows on which no greedy step of the eight models ties (see the
# module docstring): a 16-token row (bs 1, no padding) and three 11-token
# rows (bs 3, padded into the 16-token bucket)
PAD0_SEED = 3
PAD_ROW_SEEDS = (1, 3, 4)
SAMPLE = dict(do_sample=True, temperature=0.8, top_k=40, top_p=0.95)
# the sampler seed of the seeded comparisons (see the module docstring)
SEED = 1


def _rows(seeds, n):
    return np.concatenate([np.random.default_rng(s).integers(
        0, HF["vocab_size"], (1, n)) for s in seeds])


PROMPT_PAD0 = _rows((PAD0_SEED,), 16)
PROMPT_PAD = _rows(PAD_ROW_SEEDS, 11)


@pytest.fixture(scope="module")
def hf_dir(tmp_path_factory):
    torch.manual_seed(0)
    m = transformers.LlamaForCausalLM(transformers.LlamaConfig(**HF))
    path = str(tmp_path_factory.mktemp("gen_llama"))
    m.to(torch.bfloat16).save_pretrained(path)
    return path


@pytest.fixture(scope="module")
def models(hf_dir):
    """(JAX model, port model) of each (weights, KV kind), loaded once."""
    @functools.lru_cache(maxsize=None)
    def get(weights, kv):
        kw = dict(load_in_low_bit=weights, kv_cache_dtype=kv,
                  max_seq=MAX_SEQ)
        return (JaxAutoModel.from_pretrained(hf_dir, **kw),
                AutoModelForCausalLM.from_pretrained(hf_dir, device="cpu",
                                                     **kw))
    return get


@pytest.fixture(scope="module")
def jax_streams(models):
    """The JAX model's generate of (weights, kv, prompt name, eos), once
    a module."""
    @functools.lru_cache(maxsize=None)
    def get(weights, kv, which, eos=None):
        ids = PROMPT_PAD0 if which == "pad0" else PROMPT_PAD
        return models(weights, kv)[0].generate(ids, max_new_tokens=NEW,
                                               eos_token_id=eos)
    return get


# -- random bits --------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 7, 12345, 2 ** 31 - 1])
def test_split_equals_jax(seed):
    key = rnd.prng_key(seed)
    jkey = jax.random.PRNGKey(seed)
    for _ in range(3):
        jkey, jsub = jax.random.split(jkey)
        key, sub = rnd.split(key)
        assert key == tuple(int(w) for w in np.asarray(jkey))
        assert sub == tuple(int(w) for w in np.asarray(jsub))
    for num in (3, 5):
        got = rnd.split(key, num)
        want = np.asarray(jax.random.split(jkey, num))
        assert got == [tuple(int(w) for w in row) for row in want]


@pytest.mark.parametrize("shape", [(1, 96), (3, 1000), (4, 32000)])
def test_categorical_equals_jax(shape):
    """A [B, V] draw is one block of B * V words (not B draws of V): the
    words equal jax.random.bits, the draws jax.random.categorical."""
    jkey = jax.random.split(jax.random.PRNGKey(shape[1]))[1]
    key = tuple(int(w) for w in np.asarray(jkey))
    bits = rnd.uniform_bits(key, shape[0] * shape[1]).reshape(shape)
    want_bits = np.asarray(jax.random.bits(jkey, shape, jnp.uint32))
    np.testing.assert_array_equal(bits.numpy().astype(np.uint32), want_bits)
    for s in range(3):
        lg = np.random.default_rng(s).standard_normal(shape).astype(
            np.float32) * 3
        lg[:, ::7] = -np.inf
        got = rnd.categorical(key, torch.from_numpy(lg))
        want = np.asarray(jax.random.categorical(jkey, jnp.asarray(lg)))
        np.testing.assert_array_equal(got.numpy(), want)


# -- sampling pieces ----------------------------------------------------------

def _logits(seed, b=3, v=256):
    return np.random.default_rng(seed).standard_normal((b, v)).astype(
        np.float32) * 4


def _f32_bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("length", [None, 5, [3, 9, 0]])
def test_token_counts_equals_jax(length):
    toks = np.random.default_rng(1).integers(0, 50, (3, 9)).astype(np.int32)
    want = np.asarray(jax.jit(jgen.token_counts, static_argnums=(1,))(
        jnp.asarray(toks), 50, None if length is None
        else jnp.asarray(length, jnp.int32)))
    got = tgen.token_counts(torch.from_numpy(toks), 50, length)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("rep,pres,freq", [(1.1, 0.0, 0.0), (0.7, 0.0, 0.0),
                                           (1.0, 0.5, 0.25),
                                           (1.3, 0.2, 0.1)])
def test_apply_penalties_equals_jax(rep, pres, freq):
    lg = _logits(2)
    rng = np.random.default_rng(3)
    rep_c = rng.integers(0, 3, lg.shape).astype(np.int32)
    out_c = rng.integers(0, 2, lg.shape).astype(np.int32)
    f = jax.jit(jgen.apply_penalties, static_argnums=(3, 4, 5))
    want = f(jnp.asarray(lg), jnp.asarray(rep_c), jnp.asarray(out_c), rep,
             pres, freq)
    got = tgen.apply_penalties(torch.from_numpy(lg), torch.from_numpy(rep_c),
                               torch.from_numpy(out_c), rep, pres, freq)
    np.testing.assert_array_equal(_f32_bits(got.numpy()), _f32_bits(want))


@pytest.mark.parametrize("top_k,top_p", [(0, 1.0), (40, 1.0), (0, 0.9),
                                         (40, 0.95), (1, 0.5), (0, 0.3)])
def test_filter_logits_equals_jax(top_k, top_p):
    for seed in range(4):
        lg = _logits(10 + seed)
        want = jax.jit(jgen.filter_logits, static_argnums=(1, 2))(
            jnp.asarray(lg), top_k, top_p)
        got = tgen.filter_logits(torch.from_numpy(lg), top_k, top_p)
        np.testing.assert_array_equal(_f32_bits(got.numpy()),
                                      _f32_bits(want))


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.0, 0, 1.0), (1.0, 0, 1.0), (0.8, 40, 0.95), (0.7, 0, 0.9),
    (1.3, 5, 1.0)])
def test_sample_token_equals_jax(temperature, top_k, top_p):
    f = jax.jit(jgen.sample_token,
                static_argnames=("temperature", "top_k", "top_p"))
    jkey = jax.random.PRNGKey(5)
    key = rnd.prng_key(5)
    for seed in range(6):
        jkey, jsub = jax.random.split(jkey)
        key, sub = rnd.split(key)
        lg = _logits(20 + seed, b=4)
        want = np.asarray(f(jnp.asarray(lg), jsub, temperature=temperature,
                            top_k=top_k, top_p=top_p))
        got = tgen.sample_token(torch.from_numpy(lg), sub, temperature,
                                top_k, top_p)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


# -- the generator ------------------------------------------------------------

@pytest.mark.parametrize("kv", KV_KINDS)
@pytest.mark.parametrize("weights", WEIGHTS)
@pytest.mark.parametrize("which", ["pad0", "pad"])
def test_greedy_streams_equal_jax(models, jax_streams, weights, kv, which):
    ids = PROMPT_PAD0 if which == "pad0" else PROMPT_PAD
    got = models(weights, kv)[1].generate(ids, max_new_tokens=NEW)
    want = jax_streams(weights, kv, which)
    assert got.shape == want.shape == (ids.shape[0], ids.shape[1] + NEW)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("weights", WEIGHTS)
def test_greedy_eos_stop_equals_jax(models, jax_streams, weights):
    """An EOS mid-stream: that row emits 0 after it; the loop ends once
    every row is done."""
    free = jax_streams(weights, "bf16", "pad")
    eos = int(free[0, PROMPT_PAD.shape[1] + 3])
    want = jax_streams(weights, "bf16", "pad", eos)
    got = models(weights, "bf16")[1].generate(PROMPT_PAD,
                                              max_new_tokens=NEW,
                                              eos_token_id=eos)
    np.testing.assert_array_equal(got, want)
    row0 = got[0, PROMPT_PAD.shape[1]:]
    assert row0[3] == eos and (row0[4:] == 0).all()


@pytest.mark.parametrize("kv", ["bf16", "int8"])
def test_seeded_streams_equal_jax(models, kv):
    """Sampled (temperature, top-k, top-p) and penalized streams through
    ``generator.generate``: the same bits, the same tokens."""
    jm, tm = models("sym_int4", kv)
    want = jm.generate(PROMPT_PAD, max_new_tokens=NEW, seed=SEED, **SAMPLE)
    got = tm.generate(PROMPT_PAD, max_new_tokens=NEW, seed=SEED, **SAMPLE)
    np.testing.assert_array_equal(got, want)
    kw = dict(max_new_tokens=NEW, seed=SEED, repetition_penalty=1.1,
              presence_penalty=0.3, frequency_penalty=0.2, **SAMPLE)
    want = jm.generator.generate(PROMPT_PAD, jgen.GenerationConfig(**kw))
    got = tm.generator.generate(PROMPT_PAD, tgen.GenerationConfig(**kw))
    np.testing.assert_array_equal(got, want)
    # a repetition penalty alone, greedy
    kw = dict(max_new_tokens=NEW, repetition_penalty=1.3)
    want = jm.generator.generate(PROMPT_PAD, jgen.GenerationConfig(**kw))
    got = tm.generator.generate(PROMPT_PAD, tgen.GenerationConfig(**kw))
    np.testing.assert_array_equal(got, want)


def test_facade_generate_and_stream(models, jax_streams):
    """generate returns prompt + new ids, ignores unknown keywords (and
    penalties, as the JAX facade does) and takes EOS from the checkpoint
    (255 here); generate_stream yields the same tokens at bs 1."""
    _, tm = models("sym_int4", "bf16")
    assert tm.hf_config["eos_token_id"] == 255
    got = tm.generate(PROMPT_PAD0[0], max_new_tokens=NEW,
                      repetition_penalty=5.0, no_such_option=1)
    np.testing.assert_array_equal(got, jax_streams("sym_int4", "bf16",
                                                   "pad0"))
    stream = list(tm.generate_stream(PROMPT_PAD0, max_new_tokens=NEW))
    assert all(isinstance(t, int) for t in stream)
    assert stream == got[0, PROMPT_PAD0.shape[1]:].tolist()
    with pytest.raises(ValueError, match="batch-1"):
        list(tm.generate_stream(PROMPT_PAD, max_new_tokens=2))
    stats = tgen.GenerationStats()
    tm.generate(PROMPT_PAD, max_new_tokens=4, stats=stats)
    assert stats.first_token_s > 0 and len(stats.rest_token_s) == 3


def test_unported_generation_paths_name_their_item(models):
    _, tm = models("sym_int4", "bf16")
    with pytest.raises(NotImplementedError, match="A12"):
        tm.generate(PROMPT_PAD, num_beams=2)
    with pytest.raises(NotImplementedError, match="A12"):
        tm.generate(PROMPT_PAD, prompt_lookup=True)
    with pytest.raises(NotImplementedError, match="A13"):
        tm.generate(PROMPT_PAD, visual=(np.zeros((3, 11)), np.zeros((1, 8))))
    with pytest.raises(NotImplementedError, match="A16"):
        tgen.Generator(tm.params, tm.config, faults=object())
    with pytest.raises(NotImplementedError, match="A12"):
        tgen.beam_search(tm.params, tm.config)
    with pytest.raises(ValueError, match="max_seq"):
        tm.generate(PROMPT_PAD, max_new_tokens=MAX_SEQ)


def test_bucket_and_cache_kind(models):
    _, tm = models("sym_int4", "int4")
    g = tm.generator
    assert [g._bucket(n) for n in (1, 16, 17, 33, 64, 100)] == [
        16, 16, 32, 64, 64, 64]
    assert g.kv_cache_dtype == "int4" and g.device.type == "cpu"
    assert dataclasses.asdict(tgen.GenerationConfig()) == dataclasses.asdict(
        jgen.GenerationConfig())
