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
