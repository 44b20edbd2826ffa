"""bigdl_tpu_torch's sampler noise against ``jax.random``, and the port's
seeded engine streams against the JAX engine's.

``ops/random.py`` rebuilds the threefry2x32 stream the JAX engine's
sampler draws from (``fold_in(PRNGKey(seed), pos)``, then
``gumbel(key, (V,))`` with partitionable counters): keys and uniform bits
equal JAX's bit for bit for seeds and positions up to 2**31 - 1; each of
the two logs of the gumbel transform agrees with XLA's within one f32
ulp. Seeded token streams of the two engines are then identical (a tie
within an ulp could split them; none occurs here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.serving.engine import EngineConfig as JaxEngineConfig
from bigdl_tpu.serving.engine import LLMEngine as JaxLLMEngine
from bigdl_tpu.serving.engine import SamplingParams as JaxSamplingParams
from bigdl_tpu.serving.engine import _device_sample_rows
from bigdl_tpu.utils.testing import tiny_random_model
from bigdl_tpu_torch import bridge
from bigdl_tpu_torch.ops import random as rnd
from bigdl_tpu_torch.serving.engine import (EngineConfig, LLMEngine,
                                            SamplingParams, sample_rows)
from bigdl_tpu_torch.utils.testing import TINY_LLAMA, SyntheticCausalLM
from torch_threads import one_intra_op_thread  # noqa: F401

SEED_POS = [(0, 0), (1234, 7), (99, 12345), (2 ** 31 - 1, 2 ** 31 - 1),
            (7, 2 ** 31 - 1), (2 ** 31 - 1, 0)]


def _jkey(seed, pos):
    return jax.random.fold_in(jax.random.PRNGKey(seed), pos)


def _ulps(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.abs(a.view(np.int32).astype(np.int64)
                  - b.view(np.int32).astype(np.int64))


def test_threefry_known_answer():
    """Random123's threefry2x32 (20 rounds) test vector, which JAX's own
    tests use too."""
    y0, y1 = rnd.threefry2x32((0x13198A2E, 0x03707344), 0x243F6A88,
                              0x85A308D3)
    assert (int(y0), int(y1)) == (0xC4923A9C, 0x483DF7A0)


@pytest.mark.parametrize("seed,pos", SEED_POS)
def test_fold_in_and_bits_equal_jax(seed, pos):
    want = np.asarray(jax.random.key_data(_jkey(seed, pos))).astype(np.int64)
    key = rnd.fold_in(rnd.prng_key(seed), pos)
    assert [int(key[0]), int(key[1])] == want.tolist()
    jb = np.asarray(jax.random.bits(_jkey(seed, pos), (4096,), jnp.uint32))
    np.testing.assert_array_equal(rnd.uniform_bits(key, 4096).numpy(),
                                  jb.astype(np.int64))
    ju = np.asarray(jax.random.uniform(
        _jkey(seed, pos), (4096,), jnp.float32,
        minval=jnp.finfo(jnp.float32).tiny, maxval=1.0))
    np.testing.assert_array_equal(rnd.uniform(key, 4096).numpy().view(
        np.int32), ju.view(np.int32))


def test_batched_keys_equal_per_row_keys():
    seeds = torch.tensor([[s] for s, _ in SEED_POS])
    poss = torch.tensor([[p] for _, p in SEED_POS])
    bits = rnd.uniform_bits(rnd.fold_in(rnd.prng_key(seeds), poss), 512)
    assert bits.shape == (len(SEED_POS), 512)
    for r, (s, p) in enumerate(SEED_POS):
        one = rnd.uniform_bits(rnd.fold_in(rnd.prng_key(s), p), 512)
        assert torch.equal(bits[r], one)


@pytest.mark.parametrize("seed,pos", SEED_POS[:3])
def test_gumbel_within_one_ulp_per_log(seed, pos):
    n = 32000
    key = rnd.fold_in(rnd.prng_key(seed), pos)
    u = rnd.uniform(key, n)
    inner_j = np.asarray(-jnp.log(jnp.asarray(u.numpy())))
    inner_t = (-torch.log(u)).numpy()
    assert _ulps(inner_t, inner_j).max() <= 1
    outer_j = np.asarray(-jnp.log(jnp.asarray(inner_j)))
    outer_t = (-torch.log(torch.from_numpy(inner_j.copy()))).numpy()
    assert _ulps(outer_t, outer_j).max() <= 1
    # end to end: two one-ulp steps, at most two ulps of max(1, |g|)
    got = rnd.gumbel(key, n).numpy()
    want = np.asarray(jax.random.gumbel(_jkey(seed, pos), (n,), jnp.float32))
    tol = 2 * np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
    assert (np.abs(got - want) <= tol).all()


def test_sample_rows_equal_jax_sampler():
    rng = np.random.default_rng(5)
    b, v = 6, 256
    lg = rng.standard_normal((b, v)).astype(np.float32) * 3
    temps = np.array([0.0, 1.0, 0.8, 0.7, 1.5, 1.0], np.float32)
    top_ks = np.array([0, 3, 0, 40, 1, 0], np.int32)
    top_ps = np.array([1.0, 1.0, 0.3, 0.95, 1.0, 0.0], np.float32)
    seeds = np.array([7, 1234, 2 ** 31 - 1, 0, 99, 5], np.int32)
    for step in range(12):
        poss = (np.arange(b, dtype=np.int32) * 1000 + step).astype(np.int32)
        want = np.asarray(_device_sample_rows(
            jnp.asarray(lg), jnp.asarray(temps), jnp.asarray(top_ks),
            jnp.asarray(top_ps), jnp.asarray(seeds), jnp.asarray(poss)))
        got = sample_rows(torch.from_numpy(lg), torch.from_numpy(temps),
                          torch.from_numpy(top_ks).long(),
                          torch.from_numpy(top_ps), seeds.tolist(),
                          poss.tolist())
        assert got.tolist() == want.tolist()


@pytest.fixture(scope="module")
def tiny_models():
    jm = tiny_random_model(seed=0)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jm.params),
                                  device="cpu")
    return jm, SyntheticCausalLM(tp, TINY_LLAMA)


def test_engine_seeded_streams_equal_jax_engine(tiny_models):
    jm, tm = tiny_models
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 250, n).tolist() for n in (5, 13, 30)]
    kw = [dict(max_tokens=10, temperature=0.8, top_k=40, top_p=0.95,
               seed=1234),
          dict(max_tokens=10, temperature=1.0, seed=2 ** 31 - 1),
          dict(max_tokens=10, temperature=0.7, top_p=0.9, seed=3)]
    ecfg = dict(max_batch=4, max_seq=64, prefill_bucket=8, prefill_chunk=8)
    jeng = JaxLLMEngine(jm, JaxEngineConfig(prefix_cache_entries=0, **ecfg))
    teng = LLMEngine(tm, EngineConfig(**ecfg), device="cpu")
    for i, (p, k) in enumerate(zip(prompts, kw)):
        jeng.add_request(f"r{i}", p, JaxSamplingParams(**k))
        teng.add_request(f"r{i}", p, SamplingParams(**k))
    out = {}
    for name, eng in (("jax", jeng), ("torch", teng)):
        got = {f"r{i}": [] for i in range(3)}
        while eng.has_unfinished():
            eng.step()
            for rid in got:
                for o in eng.get_outputs(rid):
                    got[rid] += o.new_token_ids
        out[name] = got
    assert all(len(t) == 10 for t in out["torch"].values())
    assert out["torch"] == out["jax"]
