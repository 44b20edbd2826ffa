"""Architecture registry: HF ``architectures[0]`` -> the family's model
module (counterpart of ``bigdl_tpu/models/registry.py::get_family``).

A family here is the module ``LLMEngine`` drives (``check_supported``,
``forward``, ``new_cache``, ...), named by its ``FAMILY`` string (the
``family`` a low-bit manifest records). The port carries the llama and
mixtral modules; the JAX package's other architectures are ROADMAP A9.
"""

from __future__ import annotations

import importlib

_REGISTRY = {
    "LlamaForCausalLM": "bigdl_tpu_torch.models.llama",
    "MixtralForCausalLM": "bigdl_tpu_torch.models.mixtral",
}


def get_family(arch: str):
    """The model module of architecture `arch`; any other architecture
    raises (ROADMAP A9 ports the rest of the JAX registry)."""
    try:
        return importlib.import_module(_REGISTRY[arch])
    except KeyError:
        raise NotImplementedError(
            f"architecture {arch!r} is not ported (ROADMAP A9); the port "
            f"supports {sorted(_REGISTRY)}") from None
