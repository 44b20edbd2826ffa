"""The port's load facade (``AutoModelForCausalLM.from_pretrained`` /
``load_low_bit`` over a ``save_low_bit`` directory) against the JAX
package's on the same directory: the KV storage kind each resolves from
``quantize_kv_cache`` and ``kv_cache_dtype``, the refusals of a low-bit
directory, and unknown keyword arguments.

Both packages read their flag defaults from the environment; the tests
clear the variables that set a KV kind so that both defaults are bf16.
"""

import dataclasses

import pytest

from bigdl_tpu import config as jconfig
from bigdl_tpu.config import set_flags
from bigdl_tpu.models.llama import merge_projections as jax_merge
from bigdl_tpu.models.registry import get_family as jax_get_family
from bigdl_tpu.transformers.model import \
    AutoModelForCausalLM as JaxAutoModel
from bigdl_tpu.transformers.model import TpuCausalLM as JaxTpuCausalLM
from bigdl_tpu.utils.testing import random_llama_params as jax_random_params
from bigdl_tpu_torch.transformers.model import AutoModelForCausalLM
from torch_threads import one_intra_op_thread  # noqa: F401

HF_TINY = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
           "vocab_size": 256, "hidden_size": 64, "intermediate_size": 128,
           "num_hidden_layers": 2, "num_attention_heads": 8,
           "num_key_value_heads": 4, "max_position_embeddings": 256,
           "rms_norm_eps": 1e-5, "rope_theta": 10000.0}

_KV_ENV = ("BIGDL_TPU_TORCH_KV_CACHE_DTYPE", "BIGDL_TPU_KV_CACHE_DTYPE",
           "BIGDL_TPU_QUANTIZE_KV_CACHE", "IPEX_LLM_QUANTIZE_KV_CACHE")


@pytest.fixture(autouse=True)
def _default_flags(monkeypatch):
    for var in _KV_ENV:
        monkeypatch.delenv(var, raising=False)
    snap = dataclasses.replace(jconfig.flags())
    set_flags(kv_cache_dtype="bf16", quantize_kv_cache=False, prepack="off")
    yield
    jconfig._flags = snap


@pytest.fixture(scope="module")
def lowbit_dir(tmp_path_factory):
    """One TINY_LLAMA ``save_low_bit`` directory, written by the JAX
    package."""
    path = tmp_path_factory.mktemp("tiny_lowbit")
    snap = dataclasses.replace(jconfig.flags())
    set_flags(prepack="off")
    fam = jax_get_family("LlamaForCausalLM", HF_TINY)
    cfg = fam.config_from_hf(HF_TINY)
    params = jax_merge(jax_random_params(cfg, "sym_int4", seed=0), cfg)
    JaxTpuCausalLM(params, cfg, fam, HF_TINY, "sym_int4",
                   max_seq=128).save_low_bit(str(path))
    jconfig._flags = snap
    return str(path)


def _kwargs(quantize_kv_cache, kv_cache_dtype):
    kw = {}
    if quantize_kv_cache is not None:
        kw["quantize_kv_cache"] = quantize_kv_cache
    if kv_cache_dtype is not None:
        kw["kv_cache_dtype"] = kv_cache_dtype
    return kw


@pytest.mark.parametrize("entry", ["from_pretrained", "load_low_bit"])
@pytest.mark.parametrize("quantize_kv_cache", [None, True, False])
@pytest.mark.parametrize("kv_cache_dtype", [None, "int8"])
def test_kv_cache_dtype_resolves_as_jax(lowbit_dir, entry, quantize_kv_cache,
                                        kv_cache_dtype):
    """kv_cache_dtype wins; else quantize_kv_cache (True is fp8_e5m2);
    else the flag default: the same kind in both packages."""
    kw = _kwargs(quantize_kv_cache, kv_cache_dtype)
    want = getattr(JaxAutoModel, entry)(lowbit_dir, **kw).kv_cache_dtype
    got = getattr(AutoModelForCausalLM, entry)(lowbit_dir, device="cpu",
                                               **kw).kv_cache_dtype
    assert got == want
    expect = kv_cache_dtype or ("fp8_e5m2" if quantize_kv_cache else "bf16")
    assert got == expect


@pytest.mark.parametrize("kw", [{"speculative": True},
                                {"imatrix": {"w": [1.0]}}],
                         ids=["speculative", "imatrix"])
def test_lowbit_dir_refuses_what_needs_the_checkpoint(lowbit_dir, kw):
    with pytest.raises(ValueError):
        JaxAutoModel.from_pretrained(lowbit_dir, **kw)
    with pytest.raises(ValueError):
        AutoModelForCausalLM.from_pretrained(lowbit_dir, device="cpu", **kw)


def test_load_low_bit_ignores_unknown_keywords(lowbit_dir):
    want = JaxAutoModel.load_low_bit(lowbit_dir, foo=1)
    got = AutoModelForCausalLM.load_low_bit(lowbit_dir, device="cpu", foo=1)
    assert got.qtype == want.qtype == "sym_int4"
    assert got.kv_cache_dtype == want.kv_cache_dtype == "bf16"
    assert "qkv_proj" in got.params["layers"]
