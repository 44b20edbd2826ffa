"""The mxu8 body's arithmetic (B1 ``_gemv_kernel_mxu8`` on the small-M body,
``csrc/dequant_smallm.cuh``'s Q8 policy), modelled in torch on the CPU.

The kernel cannot run here. ``q8_kernel_model`` repeats what it computes,
in its order: x quantized per 32-K block by the steps of the kernel's
``quantize_b`` (``kernel_quantize_q8``: the amax as an integer max over the
bf16 bits with the sign cleared, per lane and then over the four lanes of
a block, sx = amax times f32(1 / 127), the reciprocal rounded to nearest,
each product rounded to f32 and then to an integer half to even), held bit
for bit against ``quantize_x_q8`` and the JAX expression; one
exact int32 partial per quant block and column, times the column's f32
scale and then the token's f32 activation scale (two roundings), summed
in f32 by each warp over its chunks (chunk ``c_begin + warp + 4 i`` of a
K split, block 0 before block 1), the four warps added in order, and the
K splits added in split order. The model is held against
``plain_q_matmul_q8`` within one bf16 ulp (the sums differ only in their
order) and against the Pallas body in interpret mode within the tolerance
tests/test_torch_matmul.py gives mxu8 (6e-2: its tiles sum in another
order); its block partials are checked to be the exact integer products.
On the card chip_smoke.py holds the kernel against ``plain_q_matmul_q8``.
"""

from fractions import Fraction

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bigdl_tpu.config import flags as jflags
from bigdl_tpu.config import set_flags
from bigdl_tpu.ops.pallas.dequant_matmul import q_matmul_pallas
from bigdl_tpu.ops.quant import quantize as jax_quantize
from bigdl_tpu.ops.quant import to_mxu_layout as jax_to_mxu
from bigdl_tpu_torch import bridge
from bigdl_tpu_torch.ops.cuda import dequant_matmul as dm
from bigdl_tpu_torch.ops.quant import to_mxu_layout, unpack_int4_rows
from torch_threads import one_intra_op_thread  # noqa: F401

CHUNK = 64          # K a staged chunk (kChunk)
WARPS = 4           # warps of a block, each on every fourth chunk
BLOCK = dm.Q8_BLOCK


def _pair(k, n, qtype, layout, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((k, n)) * 0.1).astype(np.float32)
    jw = jax_quantize(jnp.asarray(w), qtype)
    tw = bridge.qtensor_from_numpy(jax.tree.map(np.asarray, jw), device="cpu")
    if layout == "int4":
        jw, tw = jax_to_mxu(jw), to_mxu_layout(tw)
    return jw, tw


def _x(m, k, seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 0.3).astype(np.float32)
    x[0, :BLOCK] = 0.0                  # a zero block: sx 0, codes 0
    return x


def _bits_f32(bits):
    """bf16 bit patterns (uint16) as the f32 values they are."""
    return (bits.astype(np.uint32) << 16).view(np.float32)


def _rcp_rn(s):
    """__frcp_rn: the f32 nearest 1 / s (ties to the even significand),
    found from the exact rational, for a positive normal f32 s."""
    exact = Fraction(1) / Fraction(float(s))
    c = np.float32(float(exact))
    best = None
    for v in (np.nextafter(c, np.float32(0)), c,
              np.nextafter(c, np.float32(np.inf))):
        d = abs(Fraction(float(v)) - exact)
        even = int(np.float32(v).view(np.uint32)) & 1 == 0
        if best is None or d < best[0] or (d == best[0] and even):
            best = (d, v)
    return best[1]


def kernel_quantize_q8(x2):
    """x [M, Kp] (Kp a multiple of 32) -> (codes int8 [M, Kp], sx f32
    [M, Kp / 32]) by the steps of ``quantize_b`` in csrc/dequant_smallm.cuh.
    Lane t of a block's quad holds its k slots 4t..4t+3 and 16+4t..16+4t+3;
    ``__vmaxu2`` takes the integer max of the sign-cleared bf16 bits, even
    and odd slots apart; ``fmaxf`` joins the two and then the four lanes;
    sx = ``__fmul_rn(amax, 1.0f / 127.0f)``; inv = ``__frcp_rn(sx)`` (0
    where sx is 0); code = ``__float2int_rn(__fmul_rn(x, inv))``."""
    bits = x2.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
    m, kp = bits.shape
    r = kp // BLOCK
    blk = bits.reshape(m, r, BLOCK)
    lanes = np.concatenate([blk[..., :16].reshape(m, r, 4, 4),
                            blk[..., 16:].reshape(m, r, 4, 4)], axis=-1)
    mag = lanes & np.uint16(0x7FFF)
    lane_max = np.maximum(_bits_f32(mag[..., 0::2].max(-1)),
                          _bits_f32(mag[..., 1::2].max(-1)))
    amax = lane_max.max(-1)                                   # [M, r]
    sx = (amax * np.float32(1.0 / 127.0)).astype(np.float32)
    inv = np.zeros_like(sx)
    for i, v in np.ndenumerate(sx):
        if v != 0:
            inv[i] = _rcp_rn(v)
    prod = (_bits_f32(blk) * inv[..., None]).astype(np.float32)
    codes = np.rint(prod).astype(np.int8)                     # half to even
    return torch.from_numpy(codes.reshape(m, kp)), torch.from_numpy(sx)


def _jax_quantize_q8(x2):
    """The JAX package's expression (``_q_gemv_pallas`` L532-537)."""
    m, kp = x2.shape
    xb = jnp.asarray(x2.float().numpy(), jnp.bfloat16)
    xf = xb.reshape(m, kp // BLOCK, BLOCK).astype(jnp.float32)
    sxt = jnp.max(jnp.abs(xf), axis=-1) * (1.0 / 127.0)
    inv = jnp.where(sxt == 0, 0.0, 1.0 / jnp.where(sxt == 0, 1.0, sxt))
    xq = jnp.round(xf * inv[..., None]).astype(jnp.int8)
    return np.asarray(xq).reshape(m, kp), np.asarray(sxt)


def _block_partials(x, w):
    """(the codes' per-block int64 products [r, M, N], sx [M, r], the f32
    partials the kernel's s8 mma returns)."""
    kp = w.kp
    x2 = torch.nn.functional.pad(x.to(torch.bfloat16), (0, kp - w.k))
    xq, sx = kernel_quantize_q8(x2)
    codes = unpack_int4_rows(w.data) if w.is_int4 else w.data
    rows = kp // BLOCK
    xb = xq.to(torch.int64).reshape(-1, rows, BLOCK).transpose(0, 1)
    cb = codes.to(torch.int64).reshape(rows, BLOCK, -1)
    exact = torch.bmm(xb, cb)                                 # [r, M, N]
    part = torch.bmm(xb.to(torch.float64), cb.to(torch.float64)).to(
        torch.float32)
    return exact, sx, part


def q8_kernel_model(x, w, split=1, per=None):
    """y = bf16 of the kernel's sums for x [M, K] and an int4-layout or
    sym_int8 weight, its K cut into `split` splits of `per` chunks."""
    _, sx, part = _block_partials(x, w)
    rows = part.shape[0]
    s = w.scale.to(torch.float32)                             # [r, N]
    term = (part * s[:, None, :]) * sx.t()[:, :, None]        # [r, M, N]
    nchunks = -(-w.kp // CHUNK)
    per = per or -(-nchunks // split)
    y = None
    for sp in range(split):
        c_begin, c_end = sp * per, min(nchunks, (sp + 1) * per)
        block = None
        for warp in range(WARPS):
            acc = torch.zeros_like(term[0])
            for c in range(c_begin + warp, c_end, WARPS):
                for b in range(CHUNK // BLOCK):
                    r = c * (CHUNK // BLOCK) + b
                    if r < rows:
                        acc = acc + term[r]
            block = acc if block is None else block + acc
        y = block if y is None else y + block
    return y.to(torch.bfloat16)


def _ulps(got, want):
    got, want = got.float().numpy(), want.float().numpy()
    mag = np.maximum(np.maximum(np.abs(got), np.abs(want)),
                     np.abs(want).max() * 2.0 ** -16)
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    return float(np.max(np.abs(got - want) / ulp))


CASES = [("sym_int4", "int4", 512, 256), ("sym_int4", "int4", 1000, 96),
         ("sym_int8", "canonical", 512, 256),
         ("sym_int8", "canonical", 1000, 96)]


@pytest.mark.parametrize("qtype,layout,k,n", CASES)
@pytest.mark.parametrize("m", [1, 8, 17, 32])
def test_block_partials_are_exact_integers(qtype, layout, k, n, m):
    """Each block's s8 x s8 product is an integer below 2^24, so the
    kernel's int32 partial and its f32 value are exact."""
    _, tw = _pair(k, n, qtype, layout, seed=60)
    exact, _, part = _block_partials(torch.from_numpy(_x(m, k, 61)), tw)
    assert int(exact.abs().max()) < 2 ** 24
    assert torch.equal(part.to(torch.int64), exact)


@pytest.mark.parametrize("qtype,layout,k,n", CASES)
@pytest.mark.parametrize("m", [1, 8, 17, 32])
@pytest.mark.parametrize("split", [1, 3])
def test_model_within_one_ulp_of_plain(qtype, layout, k, n, m, split):
    """The kernel's order of the same f32 terms stays within one bf16 ulp
    of the plain version's, with and without a K split."""
    _, tw = _pair(k, n, qtype, layout, seed=62)
    x = torch.from_numpy(_x(m, k, 63))
    got = q8_kernel_model(x, tw, split)
    want = dm.plain_q_matmul_q8(x, tw)
    assert got.shape == (m, n) and got.dtype == torch.bfloat16
    assert _ulps(got, want) <= 1.0


@pytest.fixture
def jax_mxu8():
    before = jflags().matmul_gemv
    set_flags(matmul_gemv="mxu8")
    jax.clear_caches()               # flags are read at trace time
    yield
    set_flags(matmul_gemv=before)
    jax.clear_caches()


@pytest.mark.parametrize("qtype,layout", [("sym_int4", "int4"),
                                          ("sym_int8", "canonical")])
@pytest.mark.parametrize("m", [1, 8, 17, 32])
def test_model_matches_pallas_interpret(jax_mxu8, qtype, layout, m):
    k, n = 512, 256
    jw, tw = _pair(k, n, qtype, layout, seed=64)
    x = _x(m, k, 65)
    want = np.asarray(q_matmul_pallas(jnp.asarray(x), jw, interpret=True),
                      np.float32)
    got = q8_kernel_model(torch.from_numpy(x), tw, split=2)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=6e-2,
                               atol=6e-2)


def test_kernel_quantize_constant_is_the_jax_one():
    """The kernel multiplies amax by 1.0f / 127.0f, which nvcc folds in
    f32: the same f32 as the JAX expression's ``1.0 / 127.0``; 1 / sx is the
    correctly rounded reciprocal, which an IEEE division also gives."""
    assert np.float32(1.0) / np.float32(127.0) == np.float32(1.0 / 127.0)
    src = open(dm._native.CSRC + "/dequant_smallm.cuh").read()
    assert "__fmul_rn(amax, 1.0f / 127.0f)" in src
    assert "__frcp_rn(sx)" in src and "__float2int_rn" in src


def _edge_x(m, k, scale, seed):
    """Random x at `scale` whose first blocks are a zero block, a block of
    maximum 127 (sx 1, inv 1: x.5 values are ties), a block whose largest
    magnitude is negative (-1: inv 127, so +-0.5 lands on +-63.5), and a
    block of mixed signs with -127 its largest magnitude."""
    x = _x(m, k, seed) * np.float32(scale)
    ties = np.array([127.0, 2.5, -3.5, 0.5, 1.5, -126.5, -0.5, 5.5] * 4,
                    np.float32)
    neg = np.array([-1.0, 0.5, -0.5, 0.25, 0.75, -0.375, 0.0, 0.5] * 4,
                   np.float32)
    mixed = np.array([-127.0, 126.5, 64.5, -64.5, 3.0, -2.5, 1.5, -0.5] * 4,
                     np.float32)
    rows = [(0, 0), (min(1, m - 1), 1), (0, 2), (m - 1, 3)]
    for (row, b), vals in zip(rows, ([0.0] * BLOCK, ties, neg, mixed)):
        x[row, b * BLOCK:(b + 1) * BLOCK] = vals
    return x


@pytest.mark.parametrize("scale", [1.0, 1e-20, 3e15])
@pytest.mark.parametrize("m,k", [(1, 256), (8, 512), (17, 160), (32, 512)])
def test_kernel_quantize_steps_bit_identical(m, k, scale):
    """The kernel's quantize steps give the plain version's codes and sx
    bit for bit, and the JAX expression's: a zero block, ties at .5, and
    negative maxima included."""
    x2 = torch.from_numpy(_edge_x(m, k, scale, 66)).to(torch.bfloat16)
    got_q, got_s = kernel_quantize_q8(x2)
    want_q, want_s = dm.quantize_x_q8(x2)
    jq, js = _jax_quantize_q8(x2)
    assert torch.equal(got_q, want_q)
    np.testing.assert_array_equal(got_s.numpy().view(np.int32),
                                  want_s.numpy().view(np.int32))
    np.testing.assert_array_equal(got_q.numpy(), jq)
    np.testing.assert_array_equal(got_s.numpy().view(np.int32),
                                  js.view(np.int32))
    # the edge blocks took the cases they were made for
    assert not got_q[0, :BLOCK].any() and got_s[0, 0] == 0
    if scale == 1.0 and m > 1:
        assert got_s[1, 1] == 1.0
        assert got_q[1, BLOCK:BLOCK + 8].tolist() == [127, 2, -4, 0, 2,
                                                      -126, 0, 6]
        assert got_q[0, 2 * BLOCK:2 * BLOCK + 3].tolist() == [-127, 64, -64]
