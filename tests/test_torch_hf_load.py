"""bigdl_tpu_torch's float checkpoint entry against the JAX package: the
port's safetensors / ``.bin`` reader (``utils/hf.py``), the conversion
(``models/convert_base.py``, ``llama.convert_hf_params``,
``mixtral.convert_hf_params``) and ``AutoModelForCausalLM.from_pretrained``
over an HF directory.

Tiny random ``transformers`` Llama and Mixtral models are saved as bf16
and f32, in one file and sharded under an index, and as
``pytorch_model.bin``. The port's parameters must equal the JAX package's
``convert_hf_params`` byte for byte (carried across by ``bridge.py``) for
every ported qtype and for dense bf16, with ``modules_to_not_convert``,
merged and unmerged; f32 logits must match the HF model at
tests/test_hf_equivalence.py's tolerance (rtol = atol = 4e-3, same
argmax).
"""

import os

import jax
import numpy as np
import pytest
import torch
import transformers
from safetensors.torch import load_file

from bigdl_tpu.models.registry import get_family as jax_get_family
from bigdl_tpu.transformers.model import \
    AutoModelForCausalLM as JaxAutoModel
from bigdl_tpu.utils.hf import iter_hf_tensors as jax_iter_hf_tensors
from bigdl_tpu_torch import bridge
from bigdl_tpu_torch.models import llama as tllama
from bigdl_tpu_torch.models import mixtral as tmixtral
from bigdl_tpu_torch.models.convert_base import (Acc, deinterleave_qkv,
                                                 layer_idx, split_rows)
from bigdl_tpu_torch.ops.quant import QTensor
from bigdl_tpu_torch.transformers import lowbit_io
from bigdl_tpu_torch.transformers.model import AutoModelForCausalLM
from bigdl_tpu_torch.utils.hf import (iter_hf_tensors, load_hf_config,
                                      load_hf_state_dict)
from torch_threads import one_intra_op_thread  # noqa: F401

D, FF, V, L, H = 64, 128, 96, 2, 4
TOKENS = np.array([[5, 17, 33, 2, 8, 41, 13, 7]], np.int32)
QTYPES = ("sym_int4", "asym_int4", "sym_int8", "nf4", "fp4", "nf3")

ARCHS = {
    "llama": (transformers.LlamaConfig, transformers.LlamaForCausalLM,
              dict(vocab_size=V, hidden_size=D, intermediate_size=FF,
                   num_hidden_layers=L, num_attention_heads=H,
                   num_key_value_heads=2)),
    "mixtral": (transformers.MixtralConfig,
                transformers.MixtralForCausalLM,
                dict(vocab_size=V, hidden_size=D, intermediate_size=FF,
                     num_hidden_layers=L, num_attention_heads=H,
                     num_key_value_heads=2, num_local_experts=4,
                     num_experts_per_tok=2)),
}
# (arch, torch dtype, how it is saved)
SOURCES = {
    "llama-bf16-single": ("llama", torch.bfloat16, "single"),
    "llama-bf16-sharded": ("llama", torch.bfloat16, "sharded"),
    "llama-f32-single": ("llama", torch.float32, "single"),
    "llama-f32-sharded": ("llama", torch.float32, "sharded"),
    "llama-bf16-bin": ("llama", torch.bfloat16, "bin"),
    "mixtral-bf16-sharded": ("mixtral", torch.bfloat16, "sharded"),
    "mixtral-f32-single": ("mixtral", torch.float32, "single"),
}


def _hf_model(arch, dtype):
    cfg_cls, model_cls, kw = ARCHS[arch]
    torch.manual_seed(0)
    return model_cls(cfg_cls(**kw)).eval().to(dtype)


@pytest.fixture(scope="module")
def hf_dirs(tmp_path_factory):
    """{source: (directory, HF model)}: the tiny models saved each way."""
    out = {}
    for name, (arch, dtype, how) in SOURCES.items():
        m = _hf_model(arch, dtype)
        path = str(tmp_path_factory.mktemp(name))
        if how == "bin":
            m.save_pretrained(path, safe_serialization=False)
        else:
            m.save_pretrained(path, max_shard_size=(
                "40KB" if how == "sharded" else "10GB"))
        out[name] = (path, m)
    return out


def _bits(t: torch.Tensor) -> torch.Tensor:
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16)
    if t.dtype in (torch.float8_e5m2, torch.float8_e4m3fn):
        return t.view(torch.uint8)
    return t


def _assert_same_tree(got, want, path="params"):
    """Equal keys, kinds, dtypes, shapes and bytes."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), (
            path, sorted(set(got) ^ set(want)))
        for k in want:
            _assert_same_tree(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, QTensor):
        assert isinstance(got, QTensor), path
        assert (got.qtype, tuple(got.shape), got.layout) == (
            want.qtype, tuple(want.shape), want.layout), path
        for a, b in ((got.data, want.data), (got.scale, want.scale),
                     (got.zero, want.zero)):
            assert (a is None) == (b is None), path
            if a is not None:
                assert a.dtype == b.dtype and a.shape == b.shape, path
                assert torch.equal(_bits(a), _bits(b)), path
    else:
        assert not isinstance(got, QTensor), path
        assert got.dtype == want.dtype and got.shape == want.shape, (
            path, got.dtype, want.dtype, got.shape, want.shape)
        assert torch.equal(_bits(got), _bits(want)), path


def _from_jax(tree):
    return bridge.params_from_numpy(jax.tree.map(np.asarray, tree),
                                    device="cpu")


# -- reading ------------------------------------------------------------------

@pytest.mark.parametrize("source", sorted(SOURCES))
def test_reader_equals_the_checkpoint(hf_dirs, source):
    """Every tensor in its stored dtype (bf16 stays bf16), sharded
    checkpoints through their index, .bin through torch.load."""
    path, m = hf_dirs[source]
    _, dtype, how = SOURCES[source]
    got = dict(iter_hf_tensors(path))
    if how == "bin":
        want = torch.load(os.path.join(path, "pytorch_model.bin"),
                          weights_only=True)
    else:
        want = {}
        for f in sorted(os.listdir(path)):
            if f.endswith(".safetensors"):
                want.update(load_file(os.path.join(path, f)))
    assert set(got) == set(want)
    for k, t in want.items():
        assert got[k].dtype == t.dtype == dtype, k
        assert torch.equal(_bits(got[k]), _bits(t)), k
    assert set(load_hf_state_dict(path)) == set(want)
    assert load_hf_config(path)["architectures"][0] == type(m).__name__
    if how == "sharded":
        assert os.path.exists(os.path.join(
            path, "model.safetensors.index.json"))


def test_reader_reads_f16_and_bf16_bits(tmp_path):
    from safetensors.torch import save_file
    ts = {"a": torch.randn(3, 5).to(torch.bfloat16),
          "b": torch.randn(7).half(), "c": torch.randn(2, 2)}
    save_file(ts, str(tmp_path / "x.safetensors"))
    got = dict(lowbit_io.iter_safetensors(str(tmp_path / "x.safetensors")))
    for k, t in ts.items():
        assert got[k].dtype == t.dtype and torch.equal(_bits(got[k]),
                                                       _bits(t))
    raw = lowbit_io.read_safetensors(str(tmp_path / "x.safetensors"))
    assert raw["a"].dtype == np.uint16
    np.testing.assert_array_equal(raw["a"],
                                  ts["a"].view(torch.int16).numpy()
                                  .view(np.uint16))


def test_writer_takes_bf16_bits(tmp_path):
    """write_safetensors writes a BF16 tensor from its uint16 bits; the
    safetensors package reads it back."""
    t = torch.randn(4, 6).to(torch.bfloat16)
    bits = t.view(torch.int16).numpy().view(np.uint16)
    p = str(tmp_path / "w.safetensors")
    lowbit_io.write_safetensors(p, {"w": ("BF16", bits.shape,
                                          lambda: bits)})
    assert torch.equal(_bits(load_file(p)["w"]), _bits(t))


def test_no_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        list(iter_hf_tensors(str(tmp_path)))


# -- conversion ---------------------------------------------------------------

@pytest.mark.parametrize("qtype", QTYPES + (None,))
@pytest.mark.parametrize("source", ["llama-bf16-sharded",
                                    "mixtral-bf16-sharded",
                                    "llama-f32-single"])
def test_convert_equals_jax(hf_dirs, source, qtype):
    path, _ = hf_dirs[source]
    hf = load_hf_config(path)
    jf = jax_get_family(hf["architectures"][0])
    tf = tllama if SOURCES[source][0] == "llama" else tmixtral
    want = jf.convert_params(jax_iter_hf_tensors(path), jf.config_from_hf(hf),
                             qtype=qtype)
    got = tf.convert_hf_params(iter_hf_tensors(path), tf.config_from_hf(hf),
                               qtype=qtype, device="cpu")
    _assert_same_tree(got, _from_jax(want))


@pytest.mark.parametrize("merge", [True, False])
@pytest.mark.parametrize("qtype,skip", [
    ("sym_int4", ()), ("sym_int4", ("down_proj", "lm_head")),
    ("nf4", ("self_attn.k_proj",)), ("asym_int4", ()), ("bf16", ()),
    (None, ())])
def test_from_pretrained_llama_equals_jax(hf_dirs, qtype, skip, merge):
    """The facade: qtype resolution, modules_to_not_convert, merged or
    split projections; the same tree as the JAX facade's (CPU: no
    prepack on either side)."""
    path, _ = hf_dirs["llama-bf16-sharded"]
    kw = dict(modules_to_not_convert=skip, merge_projections=merge)
    if qtype is None:
        kw["load_in_4bit"] = True
    else:
        kw["load_in_low_bit"] = qtype
    jm = JaxAutoModel.from_pretrained(path, **kw)
    tm = AutoModelForCausalLM.from_pretrained(path, device="cpu", **kw)
    assert tm.qtype == jm.qtype == (qtype or "sym_int4")
    # a group whose members mix dense and quantized stays split
    assert ("gate_up_proj" in tm.params["layers"]) == merge
    _assert_same_tree(tm.params, _from_jax(jm.params))


@pytest.mark.parametrize("qtype", ["sym_int4", "bf16"])
def test_from_pretrained_mixtral_equals_jax(hf_dirs, qtype):
    """Expert stacks [L, E, ...], quantized or dense bf16; the router
    stays dense; w2 (down) kept dense by modules_to_not_convert."""
    path, _ = hf_dirs["mixtral-bf16-sharded"]
    kw = dict(load_in_low_bit=qtype, modules_to_not_convert=("w2",))
    jm = JaxAutoModel.from_pretrained(path, **kw)
    tm = AutoModelForCausalLM.from_pretrained(path, device="cpu", **kw)
    assert tm.family is tmixtral
    layers = tm.params["layers"]
    assert layers["experts_down"].dtype == torch.bfloat16
    assert layers["experts_down"].shape == (L, 4, FF, D)
    assert isinstance(layers["experts_gate"], QTensor) == (qtype != "bf16")
    _assert_same_tree(tm.params, _from_jax(jm.params))


def test_unmerge_inverts_merge(hf_dirs):
    path, _ = hf_dirs["llama-bf16-single"]
    for qtype in ("sym_int4", "bf16"):
        split = AutoModelForCausalLM.from_pretrained(
            path, load_in_low_bit=qtype, merge_projections=False,
            device="cpu")
        merged = AutoModelForCausalLM.from_pretrained(
            path, load_in_low_bit=qtype, device="cpu")
        back = tllama.unmerge_projections(merged.params, merged.config)
        _assert_same_tree(back, split.params)
        for w in back["layers"].values():
            planes = (w.data, w.scale) if isinstance(w, QTensor) else (w,)
            assert all(p.is_contiguous() for p in planes)


@pytest.mark.parametrize("source", ["llama-f32-single", "mixtral-f32-single"])
def test_logits_match_hf(hf_dirs, source):
    path, m = hf_dirs[source]
    with torch.no_grad():
        want = m(torch.tensor(TOKENS.astype(np.int64))).logits.numpy()
    hf = load_hf_config(path)
    tf = tllama if SOURCES[source][0] == "llama" else tmixtral
    cfg = tf.config_from_hf(hf)
    params = tf.convert_hf_params(iter_hf_tensors(path), cfg, qtype=None,
                                  compute_dtype=torch.float32, device="cpu")
    with torch.no_grad():
        logits, _ = tf.forward(params, cfg, torch.from_numpy(TOKENS),
                               tf.new_cache(cfg, 1, 32, device="cpu"),
                               compute_dtype=torch.float32)
    got = logits.numpy()
    np.testing.assert_allclose(got, want, rtol=4e-3, atol=4e-3)
    assert np.argmax(got, -1).tolist() == np.argmax(want, -1).tolist()


def test_missing_and_mismatched_layers_raise(hf_dirs):
    path, _ = hf_dirs["llama-bf16-single"]
    hf = load_hf_config(path)
    cfg = tllama.config_from_hf(hf)
    tensors = [(k, t) for k, t in iter_hf_tensors(path)
               if k != "model.layers.1.mlp.up_proj.weight"]
    with pytest.raises(ValueError, match="up_proj"):
        tllama.convert_hf_params(tensors, cfg, device="cpu")
    no_head = [(k, t) for k, t in iter_hf_tensors(path)
               if k != "lm_head.weight"]
    with pytest.raises(ValueError, match="lm_head"):
        tllama.convert_hf_params(no_head, cfg, device="cpu")
    # one qtype per stacked key: a layer-0-only skip cannot stack
    with pytest.raises(ValueError, match="kind"):
        tllama.convert_hf_params(
            iter_hf_tensors(path), cfg, device="cpu",
            modules_to_not_convert=("layers.0.mlp.up_proj",))


def test_acc_helpers():
    acc = Acc.for_layer_count(2, "sym_int4", torch.bfloat16, (),
                              device="cpu")
    for i in range(2):
        acc.put("w", i, acc.linear("w", torch.randn(64, 64)))
        acc.put("e", (i, 1), acc.dense(torch.ones(3)), lead=(2, 2))
    with pytest.raises(ValueError, match="e"):
        acc.finish(tie=True)
    acc.put("e", (0, 0), acc.dense(torch.ones(3)), lead=(2, 2))
    acc.put("e", (1, 0), acc.dense(torch.ones(3)), lead=(2, 2))
    out = acc.finish(tie=True)
    assert out["layers"]["w"].data.shape == (2, 32, 64)
    assert out["layers"]["e"].shape == (2, 2, 3)
    w = torch.arange(12.0).reshape(6, 2)
    a, b = split_rows(w, (2, 4))
    assert torch.equal(torch.cat([a, b]), w)
    q, k, v = deinterleave_qkv(torch.arange(24.0).reshape(12, 2), 2, 2)
    assert q.shape == (4, 2) and torch.equal(q[:2], torch.tensor(
        [[0.0, 1.0], [2.0, 3.0]]))
    assert layer_idx("model.layers.3.mlp.x", "model.layers.") == (3, "mlp.x")
    assert layer_idx("lm_head", "model.layers.") is None


# -- refusals -----------------------------------------------------------------

def test_unported_options_name_their_item(hf_dirs, tmp_path):
    path, _ = hf_dirs["llama-bf16-single"]
    for kw, item in ((dict(speculative=True), "A12"),
                     (dict(imatrix={"x": np.ones(3)}), "A11"),
                     (dict(embedding_qtype="sym_int8"), "A3")):
        with pytest.raises(NotImplementedError, match=item):
            AutoModelForCausalLM.from_pretrained(path, device="cpu", **kw)
    gguf = tmp_path / "m.gguf"
    gguf.write_bytes(b"GGUF")
    with pytest.raises(NotImplementedError, match="A11"):
        AutoModelForCausalLM.from_pretrained(str(gguf), device="cpu")
    import json
    import shutil
    for extra, item in (({"quantization_config": {"quant_method": "gptq"}},
                         "A11"), ({"visual": {}}, "A13")):
        d = tmp_path / item
        shutil.copytree(path, d)
        cfg = json.loads((d / "config.json").read_text())
        cfg.update(extra)
        (d / "config.json").write_text(json.dumps(cfg))
        with pytest.raises(NotImplementedError, match=item):
            AutoModelForCausalLM.from_pretrained(str(d), device="cpu")
    with pytest.raises(ValueError, match="qtype"):
        AutoModelForCausalLM.from_pretrained(path, load_in_low_bit="q9_z",
                                             device="cpu")


def test_float_load_saves_a_low_bit_dir_jax_reads(hf_dirs, tmp_path):
    """from_pretrained -> save_low_bit: the JAX package loads the
    directory to the same tree, tokenizer-side files copied."""
    path, _ = hf_dirs["llama-bf16-single"]
    tm = AutoModelForCausalLM.from_pretrained(path, load_in_4bit=True,
                                              device="cpu")
    out = str(tmp_path / "lowbit")
    tm.save_low_bit(out)
    assert os.path.exists(os.path.join(out, "generation_config.json"))
    jm = JaxAutoModel.load_low_bit(out)
    _assert_same_tree(tm.params, _from_jax(jm.params))
    back = AutoModelForCausalLM.from_pretrained(out, device="cpu")
    _assert_same_tree(back.params, tm.params)
