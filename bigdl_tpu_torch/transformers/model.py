"""User-facing model API: ``TpuCausalLM`` and
``AutoModelForCausalLM.from_pretrained`` / ``load_low_bit``
(counterpart of ``bigdl_tpu/transformers/model.py``).

``from_pretrained`` takes an HF checkpoint directory (safetensors, one
file or sharded, or ``pytorch_model.bin``) or a ``save_low_bit``
directory. A float checkpoint is converted tensor by tensor, each linear
quantized on the target device as it arrives (``load_in_4bit`` is
sym_int4, ``load_in_low_bit`` names a ported qtype or a float one); a
low-bit directory loads leaf by leaf (``lowbit_io``). Either way the
projections are then merged (q/k/v, gate/up) and the weights prepacked
(``ops/quant.prepack_tree``), in that order, as the JAX package does at
load: on the card every sym_int4 linear takes the int4 layout that the
decode body ``mxu`` and the prefill body ``i4`` read. ``generate`` /
``generate_stream`` run the ``Generator`` (``generation.py``);
``LLMEngine`` serves the same object. GGUF, GPTQ/AWQ, imatrix, the draft
model, ``embedding_qtype`` and Qwen-VL are not ported and raise naming
their ROADMAP item; quality attribution and the memory ledger are not
ported.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

import numpy as np

from bigdl_tpu_torch.config import flags
from bigdl_tpu_torch.generation import (GenerationConfig, GenerationStats,
                                        Generator)
from bigdl_tpu_torch.models import llama as llama_mod
from bigdl_tpu_torch.models.registry import get_family
from bigdl_tpu_torch.ops.kvcache import resolve_kv_cache_dtype
from bigdl_tpu_torch.ops.quant import FLOAT_QTYPES, get_qtype, prepack_tree
from bigdl_tpu_torch.transformers import lowbit_io
from bigdl_tpu_torch.utils.hf import iter_hf_tensors, load_hf_config

_TOKENIZER_FILES = (
    "tokenizer.json", "tokenizer.model", "tokenizer_config.json",
    "special_tokens_map.json", "vocab.json", "merges.txt",
    "generation_config.json",
)


def _maybe_merge(params: Any, cfg: Any, family, enable: bool) -> Any:
    """Merge q/k/v and gate/up for the llama family (exact: block
    quantization is per column); ``merge_projections=False`` undoes a
    merged directory's merge. Mixtral keeps its split layout, as the JAX
    package's custom-forward families do."""
    if family is not llama_mod:
        return params
    if enable:
        return llama_mod.merge_projections(params, cfg)
    return llama_mod.unmerge_projections(params, cfg)


def _eos(hf_config: Dict[str, Any], eos_token_id: Optional[int]):
    if eos_token_id is None:
        eos_token_id = hf_config.get("eos_token_id")
        if isinstance(eos_token_id, list):
            eos_token_id = eos_token_id[0]
    return eos_token_id


def _resolve_qtype(load_in_4bit: bool,
                   load_in_low_bit: Optional[str]) -> Optional[str]:
    if load_in_low_bit is not None:
        if load_in_low_bit not in FLOAT_QTYPES:
            get_qtype(load_in_low_bit)   # raises with the ported qtypes
        return load_in_low_bit
    return "sym_int4" if load_in_4bit else None


class TpuCausalLM:
    """A loaded (possibly quantized) causal LM: what ``LLMEngine`` serves
    (``.params``, ``.config``, ``.family`` (the model module),
    ``.hf_config``). The parameters are prepacked here, in place, leaf by
    leaf; ``.prepack_report`` says what was converted."""

    def __init__(self, params: Any, cfg: Any, family,
                 hf_config: Dict[str, Any], qtype: Optional[str],
                 model_path: Optional[str] = None, max_seq: int = 2048,
                 kv_cache_dtype: Optional[str] = None):
        self.params, self.prepack_report = prepack_tree(params)
        self.config = cfg
        self.family = family
        self.hf_config = hf_config
        self.qtype = qtype
        self.model_path = model_path
        self.max_seq = max_seq
        self.kv_cache_dtype = resolve_kv_cache_dtype(
            kv_cache_dtype if kv_cache_dtype is not None
            else flags().kv_cache_dtype)
        self._generator: Optional[Generator] = None

    # -- generation -------------------------------------------------------------
    @property
    def generator(self) -> Generator:
        if self._generator is None:
            self._generator = Generator(
                self.params, self.config, family=self.family,
                max_seq=self.max_seq, kv_cache_dtype=self.kv_cache_dtype)
        return self._generator

    def generate(self, input_ids, max_new_tokens: int = 32,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None, seed: int = 0,
                 stats: Optional[GenerationStats] = None,
                 prompt_lookup: bool = False, visual=None,
                 num_beams: int = 1, **_ignored) -> np.ndarray:
        """HF-style generate: [B, prompt + new] ids (prompt included). EOS
        defaults to the checkpoint's; unknown keyword arguments (and
        penalties, which only ``generator.generate`` takes) are ignored,
        as the JAX facade ignores them."""
        if num_beams > 1:
            raise NotImplementedError(
                "num_beams > 1 (beam search) is not ported (ROADMAP A12)")
        if prompt_lookup:
            raise NotImplementedError(
                "prompt_lookup speculation is not ported (ROADMAP A12)")
        ids = np.asarray(input_ids, np.int32)
        if ids.ndim == 1:
            ids = ids[None]
        gen = GenerationConfig(
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, top_p=top_p, do_sample=do_sample,
            eos_token_id=_eos(self.hf_config, eos_token_id), seed=seed)
        new = self.generator.generate(ids, gen, stats=stats, visual=visual)
        return np.concatenate([ids, new], axis=1)

    def generate_stream(self, input_ids, max_new_tokens: int = 32,
                        do_sample: bool = False, temperature: float = 1.0,
                        top_k: int = 0, top_p: float = 1.0,
                        eos_token_id: Optional[int] = None, seed: int = 0,
                        **_ignored):
        """Streaming generate at batch 1: yields one new token id (int) a
        step, and stops after EOS."""
        ids = np.asarray(input_ids, np.int32)
        if ids.ndim == 1:
            ids = ids[None]
        if ids.shape[0] != 1:
            raise ValueError("generate_stream is a batch-1 surface")
        eos = _eos(self.hf_config, eos_token_id)
        gen = GenerationConfig(
            max_new_tokens=max_new_tokens, temperature=temperature,
            top_k=top_k, top_p=top_p, do_sample=do_sample,
            eos_token_id=eos, seed=seed)
        for tok in self.generator.stream(ids, gen):
            t = int(tok[0])
            yield t
            if eos is not None and t == eos:
                return

    def save_low_bit(self, path: str) -> None:
        """Persist the quantized weights and config (and tokenizer files
        where the model was loaded from a directory). The canonical
        split-block packing is the interchange format: prepacked weights
        are written in it."""
        lowbit_io.save_low_bit(
            self.params, path, config=self.hf_config,
            family=self.family.FAMILY, qtype=self.qtype,
            extra={"max_seq": self.max_seq})
        if self.model_path and os.path.isdir(self.model_path):
            for fname in _TOKENIZER_FILES:
                src = os.path.join(self.model_path, fname)
                if os.path.exists(src):
                    shutil.copy(src, os.path.join(path, fname))


class AutoModelForCausalLM:
    """``from_pretrained`` of an HF checkpoint or a low-bit directory, and
    ``load_low_bit``."""

    @classmethod
    def from_pretrained(cls, pretrained_model_name_or_path: str, *,
                        load_in_4bit: bool = False,
                        load_in_low_bit: Optional[str] = None,
                        modules_to_not_convert=(),
                        max_seq: Optional[int] = None,
                        quantize_kv_cache: Optional[bool] = None,
                        kv_cache_dtype: Optional[str] = None,
                        speculative: bool = False,
                        embedding_qtype: Optional[str] = None,
                        imatrix: Optional[Any] = None,
                        merge_projections: bool = True, device="cuda",
                        **_ignored) -> TpuCausalLM:
        """Load onto `device` (the card unless the caller asks for the
        CPU). A low-bit directory goes through `load_low_bit`, which
        ignores the quantization keywords (the directory's qtype is what
        it holds) and refuses ``speculative`` and ``imatrix`` (both need
        the original checkpoint). An HF directory is converted with the
        qtype of ``load_in_low_bit`` (a ported qtype, or "fp16" / "bf16" /
        "fp32" for dense weights), else sym_int4 with ``load_in_4bit``,
        else dense; linears whose HF name contains an entry of
        ``modules_to_not_convert`` stay dense. ``kv_cache_dtype`` wins
        over the deprecated ``quantize_kv_cache`` (True is fp8_e5m2); with
        neither, the flag default decides. Other HF-style keywords
        (``optimize_model``, ...) are ignored."""
        if kv_cache_dtype is None and quantize_kv_cache is not None:
            kv_cache_dtype = resolve_kv_cache_dtype(quantize_kv_cache)
        path = pretrained_model_name_or_path
        if lowbit_io.is_low_bit_dir(path):
            if speculative:
                raise ValueError(
                    "speculative=True needs an original checkpoint to build "
                    "the low-bit draft; this path is an already-quantized "
                    "save_low_bit directory")
            if imatrix is not None:
                raise ValueError(
                    "imatrix applies at quantization time; this path is an "
                    "already-quantized save_low_bit directory: re-convert "
                    "from the original checkpoint with the imatrix")
            return cls.load_low_bit(path, max_seq=max_seq,
                                    kv_cache_dtype=kv_cache_dtype,
                                    merge_projections=merge_projections,
                                    device=device)
        if os.path.isfile(path) and path.endswith(".gguf"):
            raise NotImplementedError(
                "GGUF ingestion is not ported (ROADMAP A11)")
        if speculative:
            raise NotImplementedError(
                "speculative=True (the low-bit draft model) is not ported "
                "(ROADMAP A12)")
        if imatrix is not None:
            raise NotImplementedError(
                "imatrix-weighted quantization is not ported (ROADMAP A11)")
        if embedding_qtype is not None:
            raise NotImplementedError(
                "embedding_qtype (a quantized embedding table) is not "
                "ported (ROADMAP A3)")
        qtype = _resolve_qtype(load_in_4bit, load_in_low_bit)
        hf_config = load_hf_config(path)
        if hf_config.get("quantization_config"):
            raise NotImplementedError(
                "GPTQ/AWQ checkpoints (repacked at load) are not ported "
                "(ROADMAP A11)")
        if "visual" in hf_config:
            raise NotImplementedError(
                "Qwen-VL (a vision tower) is not ported (ROADMAP A13)")
        archs = hf_config.get("architectures") or ["?"]
        family = get_family(archs[0])
        cfg = family.config_from_hf(hf_config)
        family.check_supported(cfg)
        params = family.convert_hf_params(
            iter_hf_tensors(path), cfg,
            qtype=None if qtype in FLOAT_QTYPES else qtype,
            modules_to_not_convert=tuple(modules_to_not_convert),
            device=device)
        params = _maybe_merge(params, cfg, family, merge_projections)
        return TpuCausalLM(params, cfg, family, hf_config, qtype,
                           model_path=path, max_seq=max_seq or 2048,
                           kv_cache_dtype=kv_cache_dtype)

    @classmethod
    def load_low_bit(cls, path: str, max_seq: Optional[int] = None,
                     quantize_kv_cache: Optional[bool] = None,
                     kv_cache_dtype: Optional[str] = None,
                     merge_projections: bool = True, device="cuda",
                     **_ignored) -> TpuCausalLM:
        """Load a ``save_low_bit`` directory onto `device`, merged and
        prepacked. Unknown keyword arguments are ignored, as the JAX
        package's facade ignores them."""
        if kv_cache_dtype is None and quantize_kv_cache is not None:
            kv_cache_dtype = resolve_kv_cache_dtype(quantize_kv_cache)
        params, manifest = lowbit_io.load_low_bit(path, device=device)
        hf_config = manifest["config"]
        archs = hf_config.get("architectures") or ["?"]
        family = get_family(archs[0])
        cfg = family.config_from_hf(hf_config)
        params = _maybe_merge(params, cfg, family, merge_projections)
        return TpuCausalLM(
            params, cfg, family, hf_config,
            qtype=manifest.get(lowbit_io.MARKER), model_path=path,
            max_seq=max_seq or manifest.get("extra", {}).get("max_seq",
                                                             2048),
            kv_cache_dtype=kv_cache_dtype)
