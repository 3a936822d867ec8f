"""Kernel K2's plain version (ops/attention.py attention_reference) against
the JAX package: the Pallas kernel in interpret mode and
jax.nn.dot_product_attention, on the cases of tests/test_pallas_attention.py.

Tolerances are that file's: rtol = atol = 2e-5 in fp32 (fp32 sums taken in
another order), 2e-2 in bf16 (the output's bf16 rounding dominates).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from telescope_cam_detection_tpu.ops.pallas_attention import flash_attention
from telescope_cam_detection_tpu_torch.ops import cuda_attention
from telescope_cam_detection_tpu_torch.ops.attention import attention_reference
import torch_port_utils  # noqa: F401  (caps torch's threads per worker)

FP32_TOL = 2e-5
BF16_TOL = 2e-2


def _qkv(b, t, h, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(0, 1, (b, t, h, d)).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("b,t,h,d", [
    (1, 128, 2, 64),    # exactly one q-block of the TPU kernel
    (2, 577, 4, 64),    # EVA02-L sequence: ragged against every tile
    (1, 130, 1, 48),    # ragged T and a head dim that is not 64
    (2, 65, 3, 64),     # the shipped eva02-tiny@112 sequence
    (1, 7, 2, 32),      # the small test model's head dim
])
def test_reference_matches_jax_fp32(b, t, h, d):
    q, k, v = _qkv(b, t, h, d)
    got = attention_reference(*(torch.from_numpy(x) for x in (q, k, v))).numpy()
    jq, jk, jv = (jnp.asarray(x) for x in (q, k, v))
    assert got.shape == (b, t, h, d) and got.dtype == np.float32
    np.testing.assert_allclose(
        got, np.asarray(flash_attention(jq, jk, jv, interpret=True)),
        rtol=FP32_TOL, atol=FP32_TOL)
    np.testing.assert_allclose(
        got, np.asarray(jax.nn.dot_product_attention(jq, jk, jv)),
        rtol=FP32_TOL, atol=FP32_TOL)


def test_reference_matches_jax_bf16():
    q, k, v = _qkv(1, 160, 2, 64)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = attention_reference(tq, tk, tv)
    assert got.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    for want in (flash_attention(jq, jk, jv, interpret=True),
                 jax.nn.dot_product_attention(jq, jk, jv)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=BF16_TOL, atol=BF16_TOL)


def test_reference_subtracts_the_row_maximum():
    """Scores past 88 overflow exp() in fp32 unless the maximum is taken
    off first; the result stays finite and equal to JAX's (2e-5)."""
    q, k, v = _qkv(1, 130, 2, 64, seed=4)
    q = q * 30.0
    assert (np.einsum("bthd,bshd->bhts", q, k) / 8.0).max() > 88.0
    got = attention_reference(*(torch.from_numpy(x) for x in (q, k, v))).numpy()
    assert np.isfinite(got).all()
    want = np.asarray(jax.nn.dot_product_attention(
        *(jnp.asarray(x) for x in (q, k, v))))
    np.testing.assert_allclose(got, want, rtol=FP32_TOL, atol=FP32_TOL)


def test_wrapper_takes_the_plain_version_on_cpu_and_counts_no_launch():
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 20, 2, 32))
    before = cuda_attention.LAUNCHES
    got = cuda_attention.attention(q, k, v)
    assert cuda_attention.LAUNCHES == before      # no kernel ran
    assert torch.equal(got, attention_reference(q, k, v))
    assert got.is_contiguous()


@pytest.mark.parametrize("d", [8, 24, 72, 144])
def test_unsupported_head_dim_raises(d):
    q = torch.zeros(1, 4, 1, d)
    with pytest.raises(ValueError, match="head dim"):
        cuda_attention.attention(q, q, q)


def test_bad_inputs_raise():
    q = torch.zeros(1, 4, 2, 32)
    with pytest.raises(ValueError, match="one shape"):
        cuda_attention.attention(q, q[:, :3], q)
    with pytest.raises(ValueError, match="one shape"):
        cuda_attention.attention(q[0], q[0], q[0])
    with pytest.raises(TypeError):
        cuda_attention.attention(q.double(), q.double(), q.double())
    with pytest.raises(TypeError):
        cuda_attention.attention(q, q.to(torch.bfloat16), q)


# ---------------------------------------------------------------------------
# The fp32 route of the CUDA kernel (csrc/attention.cu) takes each product
# as three TF32 products on the tensor cores. A numpy emulation of that
# split, against an fp64 reference, at the distributions of chip_smoke.py's
# K2 cases.
# ---------------------------------------------------------------------------

def _tf32(x):
    """cvt.rna.tf32.f32: round to nearest, ties away from zero, to 10
    mantissa bits (the low 13 bits of the fp32 pattern cleared)."""
    bits = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _matmul(a, b):
    """a @ b through torch (its CPU threads are capped per worker, numpy's
    BLAS threads are not)."""
    return torch.matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()


def _mm3(a, b, terms=3):
    """a @ b with each operand split hi + lo: lo hi' + hi lo' + hi hi',
    products exact (TF32 x TF32 fits fp32's 24 bits), sums in fp32.
    terms=1 is plain TF32 (hi hi' alone)."""
    (a_hi, a_lo), (b_hi, b_lo) = _split(a), _split(b)
    out = _matmul(a_hi, b_hi)
    if terms == 3:
        out = _matmul(a_lo, b_hi) + _matmul(a_hi, b_lo) + out
    return out.astype(np.float32)


def _emulated_attention(q, k, v, terms=3):
    """The kernel's arithmetic for (H, T, D) fp32 inputs: split scores, the
    softmax in fp32 with exp2 and log2(e) folded into the scale (one fma),
    p split for p v."""
    c = np.float32(1.0 / np.sqrt(q.shape[-1]) * np.log2(np.e))
    s = _mm3(q, np.ascontiguousarray(np.swapaxes(k, -1, -2)), terms)
    m = s.max(-1, keepdims=True)
    # fmaf(s, c, -m c): s c exact in fp64, one rounding to fp32
    arg = (s.astype(np.float64) * c - (m * c).astype(np.float32)).astype(
        np.float32)
    p = np.exp2(arg).astype(np.float32)
    return _mm3(p, v, terms) / p.sum(-1, keepdims=True, dtype=np.float32)


def _exact_attention(q, k, v):
    q, k, v = (x.astype(np.float64) for x in (q, k, v))
    s = _matmul(q, np.ascontiguousarray(np.swapaxes(k, -1, -2)))
    s = s / np.sqrt(q.shape[-1])
    p = np.exp(s - s.max(-1, keepdims=True))
    return _matmul(p, v) / p.sum(-1, keepdims=True)


@pytest.mark.parametrize("t,h,d,q_scale", [
    (577, 2, 64, 1.0),     # eva02-large@336 sequence
    (65, 6, 64, 1.0),      # eva02-tiny@112 sequence
    (130, 2, 48, 1.0),
    (33, 2, 128, 1.0),
    (577, 2, 64, 30.0),    # scores past 88, q and k on quarters
])
def test_3xtf32_split_holds_the_fp32_tolerance(t, h, d, q_scale):
    rng = np.random.default_rng(t + d)
    q, k, v = (rng.normal(0, 1, (h, t, d)).astype(np.float32)
               for _ in range(3))
    if q_scale != 1.0:
        q = (np.round(q * 4) / 4 * q_scale).astype(np.float32)
        k = (np.round(k * 4) / 4).astype(np.float32)
        # lo == 0: the tensor cores see q and k exactly
        assert not _split(q)[1].any() and not _split(k)[1].any()
    want = _exact_attention(q, k, v)
    err3 = np.abs(_emulated_attention(q, k, v) - want).max()
    assert err3 < FP32_TOL / 4, err3            # well inside 2e-5
    if q_scale == 1.0:
        # one TF32 product alone would not hold it: the split is needed
        err1 = np.abs(_emulated_attention(q, k, v, terms=1) - want).max()
        assert err1 > FP32_TOL, err1


def test_tf32_rounding_is_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)               # TF32's spacing at 1
    half = np.float32(2.0 ** -11)
    x = np.array([one + half, -(one + half), one + half * np.float32(0.5),
                  one + ulp + half], np.float32)
    np.testing.assert_array_equal(
        _tf32(x), np.array([one + ulp, -(one + ulp), one, one + 2 * ulp],
                           np.float32))
