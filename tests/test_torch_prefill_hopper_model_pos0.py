"""B4's arithmetic, modelled in torch, against ``prefill_attention_pallas``
in interpret mode at pos 0 (tests/prefill_model.py; the cases at pos
256 are tests/test_torch_prefill_hopper_model_pos256.py):
every storage kind, MHA and GQA, hd 64 and 128, Sq 128 and 256, at
per-row scales from 1e-3 to 1e2, within 3e-2 (see
tests/test_torch_prefill_hopper.py).
"""

import pytest

from prefill_model import KINDS, check_model_matches_pallas
from torch_threads import one_intra_op_thread  # noqa: F401


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("h,hkv", [(8, 8), (8, 2)])
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("sq", [128, 256])
@pytest.mark.parametrize("pos", [0])
def test_model_matches_pallas_interpret(kind, h, hkv, hd, sq, pos):
    check_model_matches_pallas(kind, h, hkv, hd, sq, pos)
