"""The load entry point: low-bit checkpoint directories (``lowbit_io``) and
the ``TpuCausalLM`` / ``AutoModelForCausalLM`` facade (``model``)."""
