"""User-facing model API: ``TpuCausalLM`` and
``AutoModelForCausalLM.load_low_bit`` / ``from_pretrained`` over a
low-bit directory (counterpart of ``bigdl_tpu/transformers/model.py``).

A low-bit directory (``lowbit_io``) loads leaf by leaf onto the device,
the projections are merged (q/k/v, gate/up) and the weights prepacked
(``ops/quant.prepack_tree``), in that order, as the JAX package does at
load: on the card every sym_int4 linear then takes the int4 layout that
the decode body ``mxu`` and the prefill body ``i4`` read. ``LLMEngine``
serves the result as it serves any model object. Loading from a float
(HF safetensors) checkpoint is ROADMAP A6; the generator, the draft
model, quality attribution and the memory ledger are not ported.
"""

from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Optional

from bigdl_tpu_torch.config import flags
from bigdl_tpu_torch.models import llama as llama_mod
from bigdl_tpu_torch.models.registry import get_family
from bigdl_tpu_torch.ops.kvcache import resolve_kv_cache_dtype
from bigdl_tpu_torch.ops.quant import prepack_tree
from bigdl_tpu_torch.transformers import lowbit_io

_TOKENIZER_FILES = (
    "tokenizer.json", "tokenizer.model", "tokenizer_config.json",
    "special_tokens_map.json", "vocab.json", "merges.txt",
    "generation_config.json",
)


def _maybe_merge(params: Any, cfg: Any, family, enable: bool) -> Any:
    """Merge q/k/v and gate/up for the llama family (exact: block
    quantization is per column). A directory saved from a merged model
    stays merged; loading it with ``merge_projections=False`` needs
    ``unmerge_projections``, which is not ported, and raises."""
    if family is not llama_mod:
        return params
    if enable:
        return llama_mod.merge_projections(params, cfg)
    layers = params.get("layers") or {}
    if "qkv_proj" in layers or "gate_up_proj" in layers:
        raise NotImplementedError(
            "merge_projections=False over a merged low-bit directory needs "
            "unmerge_projections, which the port does not have yet "
            "(ROADMAP A5)")
    return params


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
    """``from_pretrained`` / ``load_low_bit`` over a low-bit directory."""

    @classmethod
    def from_pretrained(cls, pretrained_model_name_or_path: str, *,
                        max_seq: Optional[int] = None,
                        quantize_kv_cache: Optional[bool] = None,
                        kv_cache_dtype: Optional[str] = None,
                        speculative: bool = False,
                        imatrix: Optional[Any] = None,
                        merge_projections: bool = True, device="cuda",
                        **_ignored) -> TpuCausalLM:
        """A low-bit directory through `load_low_bit`. HF-style keyword
        arguments (``load_in_4bit``, ``optimize_model``, ...) are accepted
        and ignored there, as the JAX package's facade does: the
        directory's qtype is what it holds. ``kv_cache_dtype`` wins over
        the deprecated ``quantize_kv_cache`` (True is ``fp8_e5m2``); with
        neither, the flag default decides. A low-bit directory refuses
        ``speculative`` and ``imatrix``: both need the original
        checkpoint."""
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
                                    quantize_kv_cache=quantize_kv_cache,
                                    kv_cache_dtype=kv_cache_dtype,
                                    merge_projections=merge_projections,
                                    device=device)
        raise NotImplementedError(
            f"{path!r} is not a save_low_bit directory; loading a float "
            "checkpoint (convert_hf_params) is ROADMAP A6")

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
