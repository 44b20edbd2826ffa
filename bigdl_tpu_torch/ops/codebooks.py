"""Codebook tables for the lookup-based 4-bit formats (nf4, nf3, fp4).

The values are the same float32 constants the JAX package uses, kept as a
copy here so the port never imports it.
"""

import numpy as np

# QLoRA NF4 levels (QLoRA paper / bitsandbytes).
NF4_CODE = np.array(
    [
        -1.0,
        -0.6961928009986877,
        -0.5250730514526367,
        -0.39491748809814453,
        -0.28444138169288635,
        -0.18477343022823334,
        -0.09105003625154495,
        0.0,
        0.07958029955625534,
        0.16093020141124725,
        0.24611230194568634,
        0.33791524171829224,
        0.44070982933044434,
        0.5626170039176941,
        0.7229568362236023,
        1.0,
    ],
    dtype=np.float32,
)

# 8-level NormalFloat (nf3): signed quantiles of N(0,1) normalized to [-1, 1].
NF3_CODE = np.array(
    [-1.0, -0.5350227355957031, -0.2469314038753510, 0.0,
     0.1833375245332718, 0.3819939494132996, 0.6229856610298157, 1.0],
    dtype=np.float32,
)

# FP4 (e2m1): bitsandbytes table, normalized so max |v| == 1.
FP4_CODE = np.array(
    [0.0, 0.0052, 0.6667, 1.0, 0.3333, 0.5, 0.1667, 0.25,
     -0.0, -0.0052, -0.6667, -1.0, -0.3333, -0.5, -0.1667, -0.25],
    dtype=np.float32,
)

CODEBOOKS = {
    "nf4": NF4_CODE,
    "nf3": NF3_CODE,
    "fp4": FP4_CODE,
}


def padded_lut(name: str) -> np.ndarray:
    """[16] float32 table, zero-padded past the codebook's own entries
    (nf3 has 8): the form the dequant kernels index with a 4-bit code."""
    lut = np.zeros((16,), np.float32)
    code = CODEBOOKS[name]
    lut[:len(code)] = code
    return lut
