"""bigdl_tpu_torch's load path against the JAX package: the int4 layout
(``to_mxu_layout`` / ``from_mxu_layout``), the load-time prepack
(``prepack_tree``), low-bit directories (``save_low_bit`` /
``load_low_bit``, the port's own safetensors reader and writer),
``TpuCausalLM`` / ``AutoModelForCausalLM`` and the engine over a loaded,
prepacked model.

Codes, bytes, reports and directories must be bit-identical across the
packages. The engine streams (greedy and seeded) of the port's
``load_low_bit`` -> ``LLMEngine`` with prepack forced on must equal the JAX
engine's over the JAX package's ``load_low_bit`` with prepack on. On the
CPU the JAX engine dequantizes the int4 layout and multiplies
(``_q_matmul_xla``) while the port runs the mxu and i4 bodies' plain
versions, and the two forwards round their bf16 activations in other
places: most logits of a step differ by one bf16 ulp. Random tiny models
have flat logits, so a step whose two best logits lie within that ulp
splits the streams of any two implementations; the port's unprepacked
path already splits from the JAX engine's on such a step (at TINY_LLAMA,
a 5-token prompt from ``default_rng(11)`` has its top two logits one ulp
apart). The engine comparisons therefore use the models, prompts and
sampling of the repo's existing engine parity tests
(tests/test_torch_engine.py, tests/test_torch_sampling.py), on which no
step ties, with the weights prepacked.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file, save_file

from bigdl_tpu import config as jconfig
from bigdl_tpu.config import set_flags
from bigdl_tpu.models.llama import merge_projections as jax_merge
from bigdl_tpu.ops.quant import dequantize as jax_dequantize
from bigdl_tpu.ops.quant import from_mxu_layout as jax_from_mxu
from bigdl_tpu.ops.quant import prepack_tree as jax_prepack_tree
from bigdl_tpu.ops.quant import quantize as jax_quantize
from bigdl_tpu.ops.quant import to_mxu_layout as jax_to_mxu
from bigdl_tpu.serving.engine import EngineConfig as JaxEngineConfig
from bigdl_tpu.serving.engine import LLMEngine as JaxLLMEngine
from bigdl_tpu.serving.engine import SamplingParams as JaxSamplingParams
from bigdl_tpu.transformers import lowbit_io as jax_lowbit_io
from bigdl_tpu.transformers.model import \
    AutoModelForCausalLM as JaxAutoModel
from bigdl_tpu.transformers.model import TpuCausalLM as JaxTpuCausalLM
from bigdl_tpu.models.registry import get_family as jax_get_family
from bigdl_tpu.utils.testing import TINY_LLAMA as JAX_TINY_LLAMA
from bigdl_tpu.utils.testing import random_llama_params as jax_random_params
from bigdl_tpu_torch import bridge
from bigdl_tpu_torch.models import llama as tllama
from bigdl_tpu_torch.models import mixtral as tmixtral
from bigdl_tpu_torch.models.registry import get_family
from bigdl_tpu_torch.ops import quant as tq
from bigdl_tpu_torch.serving.engine import (EngineConfig, LLMEngine,
                                            SamplingParams)
from bigdl_tpu_torch.transformers import lowbit_io
from bigdl_tpu_torch.transformers.model import (AutoModelForCausalLM,
                                                TpuCausalLM)
from bigdl_tpu_torch.utils.testing import TINY_LLAMA
from torch_threads import one_intra_op_thread  # noqa: F401

HF_TINY = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
           "vocab_size": 256, "hidden_size": 64, "intermediate_size": 128,
           "num_hidden_layers": 2, "num_attention_heads": 8,
           "num_key_value_heads": 4, "max_position_embeddings": 256,
           "rms_norm_eps": 1e-5, "rope_theta": 10000.0}


@pytest.fixture(autouse=True)
def _restore_jax_flags():
    snap = dataclasses.replace(jconfig.flags())
    yield
    jconfig._flags = snap


def _jq(shape, qtype="sym_int4", seed=0, scale=0.1):
    """A JAX QTensor of `qtype` (stacked when `shape` has lead dims) and
    the same leaf carried to the port."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * scale).astype(np.float32)
    lead = shape[:-2]
    mats = [jax_quantize(jnp.asarray(w[idx]), qtype)
            for idx in np.ndindex(*lead)] if lead else \
        [jax_quantize(jnp.asarray(w), qtype)]
    if lead:
        jq = jax.tree.map(lambda *xs: jnp.stack(xs).reshape(
            *lead, *xs[0].shape), *mats)
    else:
        jq = mats[0]
    return jq, bridge.qtensor_from_numpy(jax.tree.map(np.asarray, jq),
                                         device="cpu")


def _np(leaf):
    return jax.tree.map(np.asarray, leaf)


# -- the int4 layout -----------------------------------------------------------

@pytest.mark.parametrize("shape", [(256, 96), (100, 40), (3, 128, 64)])
def test_int4_codes_equal_jax_through_the_bridge(shape):
    jq, tw = _jq(shape)
    jm = jax_to_mxu(jq)
    assert jm.data.dtype == jnp.int4
    tm = tq.to_mxu_layout(tw)
    assert tm.layout == "int4" and tm.data.dtype == torch.uint8
    # JAX -> port: the bridge packs JAX's int4 codes into the same bytes
    carried = bridge.qtensor_from_numpy(_np(jm), device="cpu")
    assert carried.layout == "int4"
    assert torch.equal(carried.data, tm.data)
    # port -> JAX: the codes come back as JAX's int4 array, bit for bit
    back = bridge.qtensor_to_numpy(tm, int4_dtype=ml_dtypes.int4)
    assert back.data.dtype == ml_dtypes.int4
    np.testing.assert_array_equal(back.data.astype(np.int8),
                                  np.asarray(jm.data).astype(np.int8))
    np.testing.assert_array_equal(back.scale,
                                  np.asarray(jm.scale).view(np.uint16))


@pytest.mark.parametrize("shape", [(256, 96), (100, 40), (3, 128, 64)])
def test_from_mxu_layout_restores_canonical_bytes(shape):
    jq, tw = _jq(shape, seed=1)
    back = tq.from_mxu_layout(tq.to_mxu_layout(tw))
    assert back.layout == "canonical"
    assert torch.equal(back.data, tw.data)
    np.testing.assert_array_equal(
        back.data.numpy(), np.asarray(jax_from_mxu(jax_to_mxu(jq)).data))


@pytest.mark.parametrize("qtype,shape", [
    ("asym_int4", (128, 64)), ("sym_int8", (128, 64)), ("nf4", (128, 64)),
    ("fp4", (128, 64)), ("nf3", (128, 64)), ("sym_int4", (2, 2, 64, 32))])
def test_other_qtypes_and_expert_stacks_pass_through(qtype, shape):
    jq, tw = _jq(shape, qtype, seed=2)
    out = tq.to_mxu_layout(tw)
    assert out is tw and out.layout == "canonical"
    assert jax_to_mxu(jq).data.dtype == jq.data.dtype


@pytest.mark.parametrize("qtype,shape", [
    ("sym_int4", (100, 40)), ("sym_int4", (3, 128, 64)),
    ("sym_int4", (2, 2, 64, 32)), ("asym_int4", (64, 32)),
    ("sym_int8", (64, 32))])
def test_nbytes_equal_jax_in_both_layouts(qtype, shape):
    jq, tw = _jq(shape, qtype, seed=3)
    assert tw.nbytes == jq.nbytes
    assert tq.to_mxu_layout(tw).nbytes == jax_to_mxu(jq).nbytes


def test_int4_stack_indexes_per_layer():
    _, tw = _jq((3, 128, 64), seed=4)
    tm = tq.to_mxu_layout(tw)
    for i in range(3):
        one = tm.index(i)
        assert one.layout == "int4"
        assert torch.equal(one.data, tq.to_mxu_layout(tw.index(i)).data)
        assert torch.equal(tq.dequantize(one), tq.dequantize(tw.index(i)))


def test_int4_layout_refuses_the_expert_gather_and_strides():
    """B6's stack operations read the canonical packing only."""
    _, tw = _jq((2, 64, 32), seed=5)
    tm = tq.to_mxu_layout(tw)
    for call in (lambda: tm.take(torch.tensor([0])), tm.plane_strides):
        with pytest.raises(ValueError, match="int4 layout"):
            call()


def test_concat_and_split_carry_the_int4_layout():
    """As the JAX package's concat/split over int4 data: the layout packs
    along K, so N-concatenation commutes with the relayout; mixed layouts
    refuse."""
    _, a = _jq((2, 64, 32), seed=5)
    _, b = _jq((2, 64, 16), seed=6)
    cat = tq.concat_qtensors_n([tq.to_mxu_layout(a), tq.to_mxu_layout(b)])
    want = tq.to_mxu_layout(tq.concat_qtensors_n([a, b]))
    assert cat.layout == "int4" and cat.shape == (64, 48)
    assert torch.equal(cat.data, want.data)
    parts = tq.split_qtensor_n(cat, [32, 16])
    assert [p.layout for p in parts] == ["int4", "int4"]
    assert torch.equal(parts[1].data, tq.to_mxu_layout(b).data)
    with pytest.raises(ValueError, match="mixed layouts"):
        tq.concat_qtensors_n([tq.to_mxu_layout(a), b])


@pytest.mark.parametrize("shape", [(256, 96), (100, 40), (3, 64, 32)])
def test_dequantize_int4_layout_bit_identical_to_jax(shape):
    jq, tw = _jq(shape, seed=6)
    jm, tm = jax_to_mxu(jq), tq.to_mxu_layout(tw)
    idx = [0] if len(shape) == 3 else [None]
    for i in idx:
        jl = jm if i is None else jax.tree.map(lambda a: a[i], jm)
        tl = tm if i is None else tm.index(i)
        want = np.asarray(jax_dequantize(jl, dtype=jnp.float32))
        np.testing.assert_array_equal(
            tq.dequantize(tl, torch.float32).numpy(), want)
        wantb = np.asarray(jax_dequantize(jl)).view(np.uint16)
        np.testing.assert_array_equal(
            tq.dequantize(tl).view(torch.int16).numpy().view(np.uint16),
            wantb)


# -- prepack_tree --------------------------------------------------------------

def _trees(seed=7):
    jq, tw = _jq((2, 64, 32), seed=seed)
    j8, t8 = _jq((64, 32), "sym_int8", seed=seed + 1)
    jtree = {"w": jq, "w8": j8, "other": jnp.ones((4,))}
    ttree = {"w": tw, "w8": t8, "other": torch.ones(4)}
    return jtree, ttree


def test_prepack_off_is_the_identity():
    _, tree = _trees()
    w = tree["w"]
    out, report = tq.prepack_tree(tree, mode="off")
    assert out is tree and out["w"] is w
    assert report == {"mode": "off", "applied": False, "qtensors": 0,
                      "converted": 0, "bytes_packed": 0}


def test_prepack_auto_skips_cpu_parameters():
    _, tree = _trees()
    w = tree["w"]
    out, report = tq.prepack_tree(tree, mode="auto")
    assert out["w"] is w and not report["applied"]
    assert report["mode"] == "auto" and report["qtensors"] == 0


def test_prepack_on_converts_with_the_jax_report():
    jtree, ttree = _trees()
    want_w = tq.dequantize(ttree["w"].index(1), torch.float32)
    jout, jrep = jax_prepack_tree(jtree, mode="on")
    tout, trep = tq.prepack_tree(ttree, mode="on")
    assert trep == jrep
    assert trep["converted"] == 1 and trep["qtensors"] == 2
    assert tout["w"].layout == "int4" and tout["w8"].layout == "canonical"
    assert torch.equal(tq.dequantize(tout["w"].index(1), torch.float32),
                       want_w)
    assert ttree["w"] is tout["w"]          # containers updated in place


@pytest.mark.parametrize("env,value,converted", [
    ("BIGDL_TPU_TORCH_PREPACK", "on", 1), ("BIGDL_TPU_TORCH_PREPACK", "1", 1),
    ("BIGDL_TPU_TORCH_MXU_LAYOUT", "on", 1),
    ("BIGDL_TPU_TORCH_MXU_LAYOUT", "off", 0)])
def test_prepack_flags(monkeypatch, env, value, converted):
    monkeypatch.setenv(env, value)
    _, tree = _trees()
    mode = None if env == "BIGDL_TPU_TORCH_PREPACK" else "on"
    _, report = tq.prepack_tree(tree, mode=mode)
    assert report["converted"] == converted


@pytest.mark.parametrize("mode", ["bogus", "yes"])
def test_prepack_rejects_a_bad_mode(monkeypatch, mode):
    with pytest.raises(ValueError):
        tq.prepack_tree({}, mode=mode)
    monkeypatch.setenv("BIGDL_TPU_TORCH_PREPACK", mode)
    with pytest.raises(ValueError):
        tq.prepack_tree({})


# -- safetensors and low-bit directories ---------------------------------------

def test_safetensors_writer_and_reader_match_safetensors_numpy(tmp_path):
    rng = np.random.default_rng(8)
    arrays = {
        "layers.q_proj#data": rng.integers(0, 255, (2, 16, 24), np.uint8),
        "layers.q_proj#scale": rng.integers(0, 65535, (2, 1, 24),
                                            np.uint16),
        "embed_tokens": rng.integers(0, 65535, (8, 12), np.uint16),
        "codes": rng.integers(-128, 127, (5, 3), np.int8),
        "f32": rng.standard_normal(7).astype(np.float32),
        "pos": np.arange(3, dtype=np.int32), "empty": np.zeros((0, 4),
                                                               np.float32),
        "z": rng.standard_normal((2, 2)).astype(np.float16),
    }
    ref = str(tmp_path / "ref.safetensors")
    mine = str(tmp_path / "mine.safetensors")
    save_file(arrays, ref)
    lowbit_io.write_safetensors(mine, {k: (a.dtype, a.shape, lambda a=a: a)
                                       for k, a in arrays.items()})
    with open(ref, "rb") as f, open(mine, "rb") as g:
        assert f.read() == g.read()
    got = lowbit_io.read_safetensors(ref)
    want = load_file(ref)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def _jax_tiny_model(prepack="on"):
    set_flags(prepack=prepack)
    jcfg = jax_get_family("LlamaForCausalLM", HF_TINY).config_from_hf(
        HF_TINY)
    params = jax_merge(jax_random_params(jcfg, "sym_int4", seed=0), jcfg)
    return JaxTpuCausalLM(params, jcfg,
                          jax_get_family("LlamaForCausalLM", HF_TINY),
                          HF_TINY, "sym_int4", max_seq=128)


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield ".".join(prefix), tree


def test_jax_dir_of_a_prepacked_model_loads_in_the_port(tmp_path):
    jm = _jax_tiny_model("on")
    assert jm.prepack_report["converted"] > 0
    jm.save_low_bit(str(tmp_path))
    tm = AutoModelForCausalLM.load_low_bit(str(tmp_path), device="cpu")
    assert tm.family is tllama and tm.qtype == "sym_int4"
    assert tm.max_seq == 128 and tm.config == TINY_LLAMA
    assert tm.prepack_report["converted"] == 0       # auto, on the CPU
    set_flags(prepack="off")
    jl = JaxAutoModel.load_low_bit(str(tmp_path))
    want = dict(_leaves(_np(jl.params)))
    got = dict(_leaves(tm.params))
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        if isinstance(g, tq.QTensor):
            t = bridge.qtensor_to_numpy(g)
            np.testing.assert_array_equal(t.data, w.data)
            np.testing.assert_array_equal(t.scale, w.scale.view(np.uint16))
        else:
            np.testing.assert_array_equal(
                g.view(torch.int16).numpy(), w.view(np.int16))


def test_port_dir_loads_in_jax_and_matches_its_bytes(tmp_path, monkeypatch):
    """A port model (prepacked) writes the directory the JAX package
    writes for the same parameters, byte for byte, and JAX loads it."""
    jm = _jax_tiny_model("off")
    tparams = bridge.params_from_numpy(_np(jm.params), device="cpu")
    monkeypatch.setenv("BIGDL_TPU_TORCH_PREPACK", "on")
    tm = TpuCausalLM(tparams, TINY_LLAMA, tllama, HF_TINY, "sym_int4",
                     max_seq=128)
    assert tm.prepack_report["converted"] == tm.prepack_report["qtensors"]
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    jm.save_low_bit(str(jdir))
    tm.save_low_bit(str(tdir))
    for fn in ("low_bit_weights.safetensors", "low_bit_manifest.json"):
        with open(jdir / fn, "rb") as f, open(tdir / fn, "rb") as g:
            assert f.read() == g.read(), fn
    jl = JaxAutoModel.load_low_bit(str(tdir))
    assert jl.family.name == "llama" and jl.qtype == "sym_int4"


def test_lowbit_roundtrip_keeps_other_dtypes(tmp_path):
    params = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
              "b": {"c": torch.tensor([1.5, -2.0], dtype=torch.bfloat16),
                    "d": torch.tensor([3, 4], dtype=torch.int32)},
              "e": torch.tensor([0.5, 2.0]).to(torch.float8_e5m2)}
    _, tw = _jq((64, 32), "asym_int4", seed=9)
    params["q"] = tw
    lowbit_io.save_low_bit(params, str(tmp_path), config={"x": 1},
                           family="llama", qtype="asym_int4")
    got, manifest = lowbit_io.load_low_bit(str(tmp_path), device="cpu")
    assert manifest["config"] == {"x": 1}
    assert torch.equal(got["a"], params["a"])
    assert torch.equal(got["b"]["c"].view(torch.int16),
                       params["b"]["c"].view(torch.int16))
    assert torch.equal(got["b"]["d"], params["b"]["d"])
    assert torch.equal(got["e"].view(torch.uint8),
                       params["e"].view(torch.uint8))
    assert torch.equal(got["q"].zero.view(torch.int16),
                       tw.zero.view(torch.int16))
    assert torch.equal(got["q"].data, tw.data)
    jp, _ = jax_lowbit_io.load_low_bit(str(tmp_path))
    np.testing.assert_array_equal(np.asarray(jp["q"].data), tw.data.numpy())


# -- registry and the load entry point -----------------------------------------

def test_registry_families():
    assert get_family("LlamaForCausalLM") is tllama
    assert get_family("MixtralForCausalLM") is tmixtral
    for arch in ("Qwen2ForCausalLM", "NoSuchForCausalLM"):
        with pytest.raises(NotImplementedError, match="A9"):
            get_family(arch)


def test_load_entry_refusals(tmp_path):
    # a directory with neither a low-bit manifest nor an HF checkpoint
    # raises as the JAX facade does (no config.json)
    with pytest.raises(FileNotFoundError):
        AutoModelForCausalLM.from_pretrained(str(tmp_path), device="cpu")
    _jax_tiny_model("off").save_low_bit(str(tmp_path))
    # merge_projections=False undoes the merged directory's merge, as the
    # JAX facade's unmerge_projections does
    split = AutoModelForCausalLM.load_low_bit(str(tmp_path), device="cpu",
                                              merge_projections=False)
    jsplit = JaxAutoModel.load_low_bit(str(tmp_path),
                                       merge_projections=False)
    layers = split.params["layers"]
    assert "qkv_proj" not in layers and "gate_up_proj" not in layers
    for name, jw in jsplit.params["layers"].items():
        if hasattr(jw, "qtype"):
            assert np.array_equal(layers[name].data.numpy(),
                                  np.asarray(jw.data)), name
    tm = AutoModelForCausalLM.from_pretrained(str(tmp_path), device="cpu")
    assert "qkv_proj" in tm.params["layers"]


# -- the engine over a loaded, prepacked model ---------------------------------

# The JAX engines below run with their perf sentinel off: a tripped
# sentinel starts a process-wide profiler capture that outlives the test
# and would be seen by any later test in the same worker.
def _streams(eng, prompts, sps):
    for i, (p, sp) in enumerate(zip(prompts, sps)):
        eng.add_request(f"r{i}", p, sp)
    got = {f"r{i}": [] for i in range(len(prompts))}
    while eng.has_unfinished():
        eng.step()
        for rid in got:
            for o in eng.get_outputs(rid):
                got[rid] += o.new_token_ids
    return got


def _loaded_pair(tmp_path, monkeypatch, hf, params, max_seq):
    """The JAX package's and the port's ``load_low_bit`` of one directory
    (written from `params` by the JAX package), both with prepack on."""
    fam = jax_get_family("LlamaForCausalLM", hf)
    set_flags(prepack="off")
    JaxTpuCausalLM(params, fam.config_from_hf(hf), fam, hf, "sym_int4",
                   max_seq=max_seq).save_low_bit(str(tmp_path))
    set_flags(prepack="on")
    jm = JaxAutoModel.load_low_bit(str(tmp_path))
    monkeypatch.setenv("BIGDL_TPU_TORCH_PREPACK", "on")
    tm = AutoModelForCausalLM.load_low_bit(str(tmp_path), device="cpu")
    assert jm.prepack_report["applied"]
    assert tm.prepack_report == jm.prepack_report
    assert tm.params["layers"]["gate_up_proj"].layout == "int4"
    return jm, tm


def test_loaded_prepacked_engine_greedy_streams_equal_jax_engine(
        tmp_path, monkeypatch):
    """Greedy streams at the geometry and prompts of
    tests/test_torch_engine.py (the 40-token prompt prefills through the
    i4 body's plain version, decode runs the mxu body's)."""
    geom = dict(vocab_size=256, hidden_size=128, intermediate_size=256,
                num_hidden_layers=2, num_attention_heads=2,
                num_key_value_heads=2, max_position_embeddings=256)
    hf = dict(HF_TINY, **geom)
    jcfg = jax_get_family("LlamaForCausalLM", hf).config_from_hf(hf)
    jm, tm = _loaded_pair(tmp_path, monkeypatch, hf,
                          jax_random_params(jcfg, "sym_int4", seed=0), 256)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 256, n).tolist() for n in (5, 40, 130)]
    ecfg = dict(max_batch=4, max_seq=256)
    want = _streams(JaxLLMEngine(jm, JaxEngineConfig(sentinel=False,
                                                     **ecfg)),
                    prompts, [JaxSamplingParams(max_tokens=12)] * 3)
    got = _streams(LLMEngine(tm, EngineConfig(**ecfg), device="cpu"),
                   prompts, [SamplingParams(max_tokens=12)] * 3)
    assert all(len(t) == 12 for t in got.values())
    assert got == want


def test_loaded_prepacked_engine_seeded_streams_equal_jax_engine(
        tmp_path, monkeypatch):
    """Seeded streams at TINY_LLAMA, with the prompts and sampling of
    tests/test_torch_sampling.py."""
    jm, tm = _loaded_pair(tmp_path, monkeypatch, HF_TINY,
                          jax_random_params(JAX_TINY_LLAMA, "sym_int4",
                                            seed=0), 64)
    rng = np.random.default_rng(11)
    prompts = [rng.integers(1, 250, n).tolist() for n in (5, 13, 30)]
    kw = [dict(max_tokens=10, temperature=0.8, top_k=40, top_p=0.95,
               seed=1234),
          dict(max_tokens=10, temperature=1.0, seed=2 ** 31 - 1),
          dict(max_tokens=10, temperature=0.7, top_p=0.9, seed=3)]
    ecfg = dict(max_batch=4, max_seq=64, prefill_bucket=8, prefill_chunk=8)
    want = _streams(JaxLLMEngine(jm, JaxEngineConfig(prefix_cache_entries=0,
                                                     sentinel=False,
                                                     **ecfg)),
                    prompts, [JaxSamplingParams(**k) for k in kw])
    got = _streams(LLMEngine(tm, EngineConfig(**ecfg), device="cpu"),
                   prompts, [SamplingParams(**k) for k in kw])
    assert all(len(t) == 10 for t in got.values())
    assert got == want
