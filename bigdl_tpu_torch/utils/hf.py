"""HF checkpoint reading: config and tensors, without building an HF model
(counterpart of ``bigdl_tpu/utils/hf.py``).

Safetensors files (one ``model.safetensors`` or the shards a
``model.safetensors.index.json`` names) are read with the port's own
numpy reader (``transformers/lowbit_io.iter_safetensors``), one tensor at
a time, so the host holds one tensor, not one model. ``pytorch_model.bin``
checkpoints go through ``torch.load(weights_only=True)``, a file at a time.
Tensors come as CPU torch tensors in their stored dtype (bf16 stays bf16).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Iterator, List, Tuple

import torch

from bigdl_tpu_torch.transformers.lowbit_io import iter_safetensors


def load_hf_config(model_path: str) -> Dict[str, Any]:
    with open(os.path.join(model_path, "config.json")) as f:
        return json.load(f)


def _files(model_path: str, index: str, single: str) -> List[str]:
    idx = os.path.join(model_path, index)
    if os.path.exists(idx):
        with open(idx) as f:
            names = sorted(set(json.load(f)["weight_map"].values()))
        return [os.path.join(model_path, n) for n in names]
    one = os.path.join(model_path, single)
    return [one] if os.path.exists(one) else []


def iter_hf_tensors(model_path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield (name, CPU tensor) for every tensor of the checkpoint."""
    st_files = _files(model_path, "model.safetensors.index.json",
                      "model.safetensors")
    if st_files:
        for path in st_files:
            yield from iter_safetensors(path)
        return
    pt_files = _files(model_path, "pytorch_model.bin.index.json",
                      "pytorch_model.bin")
    if pt_files:
        for path in pt_files:
            sd = torch.load(path, map_location="cpu", weights_only=True)
            for name in list(sd):
                yield name, sd.pop(name)
        return
    raise FileNotFoundError(
        f"no model.safetensors[.index.json] or pytorch_model.bin in "
        f"{model_path}")


def load_hf_state_dict(model_path: str) -> Dict[str, torch.Tensor]:
    return dict(iter_hf_tensors(model_path))
