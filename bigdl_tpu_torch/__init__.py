"""bigdl_tpu_torch: the PyTorch/CUDA port of bigdl_tpu for NVIDIA Hopper.

Imports torch and numpy only. The dequant-matmul and attention kernels
are hand-written CUDA C++ under ``csrc/``, built with nvcc at first use
(``_native.py``); on CPU tensors every kernel wrapper runs its plain
PyTorch version instead.
"""

__version__ = "0.1.0"
