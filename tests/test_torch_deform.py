"""The plain version of kernel K3 (telescope_cam_detection_tpu_torch/ops/deform.py)
against the JAX package's deformable sampling, on the CPU.

The same numpy-seeded values, locations and weights go through
``models/rtdetr.py ms_deformable_attention`` (and, at a tiny shape, the
Pallas kernel in interpret mode) and through the port. Tolerance: rtol 1e-4,
atol 1e-5, that of tests/test_pallas_deform.py; both sides compute in fp32
with the same order of arithmetic, so they agree far inside it."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from telescope_cam_detection_tpu.models.rtdetr import (
    bilinear_corner_fractions as jax_corner_fractions,
    ms_deformable_attention,
)
from telescope_cam_detection_tpu.ops.pallas_deform import (
    ms_deformable_attention_pallas,
)
from telescope_cam_detection_tpu_torch.ops import cuda_deform
from telescope_cam_detection_tpu_torch.ops.deform import (
    bilinear_corner_fractions,
    ms_deformable_attention_reference,
    split_levels,
)
import torch_port_utils  # noqa: F401  (caps torch's threads)

TOL = dict(rtol=1e-4, atol=1e-5)


def _inputs(seed, b, q, heads, hd, p, level_hw, lo=0.05, hi=0.95):
    rng = np.random.default_rng(seed)
    values = [rng.normal(size=(b, h, w, heads, hd)).astype(np.float32)
              for h, w in level_hw]
    locs = rng.uniform(lo, hi, (b, q, heads, len(level_hw), p, 2)) \
        .astype(np.float32)
    weights = rng.uniform(0, 1, (b, q, heads, len(level_hw), p))
    weights = (weights / weights.sum(axis=(3, 4), keepdims=True)) \
        .astype(np.float32)
    return values, locs, weights


def _jax(values, locs, weights):
    return np.asarray(ms_deformable_attention(
        [jnp.asarray(v) for v in values], jnp.asarray(locs),
        jnp.asarray(weights)))


def _port(values, locs, weights):
    return ms_deformable_attention_reference(
        [torch.from_numpy(v) for v in values], torch.from_numpy(locs),
        torch.from_numpy(weights)).numpy()


@pytest.mark.parametrize("seed,q,lo,hi", [
    (0, 30, 0.05, 0.95),        # the shapes of tests/test_pallas_deform.py
    (1, 30, 0.05, 0.95),
    (2, 30, -0.5, 1.5),         # outside [0, 1]: corners clamp to the edge
    (3, 30, -3.0, 4.0),         # far outside
])
def test_reference_matches_jax(seed, q, lo, hi):
    # H != W on every level, Q divides no block size
    values, locs, weights = _inputs(seed, 2, q, 4, 8, 4,
                                    [(12, 16), (6, 8), (3, 4)], lo, hi)
    want = _jax(values, locs, weights)
    got = _port(values, locs, weights)
    assert got.shape == want.shape == (2, q, 4, 8) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


def test_reference_on_pixel_centres_and_edges():
    """Locations exactly on pixel centres return that pixel times the weight;
    on pixel edges the mean of the neighbours; past the border the edge
    pixel (the cases of tests/test_rtdetr.py, and the border clamp)."""
    h, w = 4, 6
    v = np.arange(h * w, dtype=np.float32).reshape(1, h, w, 1, 1) * 10.0
    xs = np.array([0.5, 2.5, 5.5, 1.0, 3.0, -2.0, 8.0], np.float32) / w
    ys = np.array([0.5, 1.5, 3.5, 1.0, 2.0, -1.0, 5.0], np.float32) / h
    locs = np.stack(np.broadcast_arrays(xs[:, None], ys[None, :]), -1) \
        .reshape(1, -1, 1, 1, 1, 2).astype(np.float32)
    weights = np.full(locs.shape[:-1], 0.5, np.float32)
    got = _port([v], locs, weights)[0, :, 0, 0]
    np.testing.assert_array_equal(got, _jax([v], locs, weights)[0, :, 0, 0])
    px = np.clip(xs * w - 0.5, 0, w - 1)
    py = np.clip(ys * h - 0.5, 0, h - 1)
    want = 0.5 * 10.0 * (py[None, :] * w + px[:, None]).reshape(-1)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    # the corner split itself is the JAX package's
    x0, y0, fx, fy = bilinear_corner_fractions(torch.from_numpy(locs), h, w)
    for a, b in zip((x0, y0, fx, fy),
                    jax_corner_fractions(jnp.asarray(locs), h, w)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_reference_matches_pallas_kernel_interpret():
    """The Pallas TPU kernel itself, interpreted on the CPU, at a tiny
    shape (interpret mode is slow)."""
    values, locs, weights = _inputs(4, 1, 5, 2, 4, 2, [(4, 6), (2, 3)],
                                    -0.2, 1.2)
    want = np.asarray(ms_deformable_attention_pallas(
        [jnp.asarray(v) for v in values], jnp.asarray(locs),
        jnp.asarray(weights), interpret=True))
    np.testing.assert_allclose(_port(values, locs, weights), want, **TOL)


def test_deform_sample_on_the_cpu_is_the_plain_version():
    """The kernel's wrapper takes concatenated levels; on CPU tensors it
    runs the plain version and launches nothing."""
    level_hw = [(12, 16), (6, 8), (3, 4)]
    values, locs, weights = _inputs(5, 2, 30, 4, 8, 4, level_hw, -0.1, 1.1)
    flat = torch.cat([torch.from_numpy(v).reshape(2, -1, 4, 8)
                      for v in values], 1)
    before = cuda_deform.LAUNCHES
    got = cuda_deform.deform_sample(flat, level_hw, torch.from_numpy(locs),
                                    torch.from_numpy(weights))
    assert cuda_deform.LAUNCHES == before
    for a, b in zip(split_levels(flat, level_hw), values):
        np.testing.assert_array_equal(a.numpy(), b)
    np.testing.assert_allclose(got.numpy(), _jax(values, locs, weights), **TOL)


@pytest.mark.parametrize("change,match", [
    (dict(level_hw=[(10, 12), (5, 6)]), "levels"),
    (dict(level_hw=[(10, 12), (5, 6), (3, 4)]), "positions"),
    (dict(locs=torch.zeros(2, 30, 8, 3, 4, 3)), "do not match"),
    (dict(weights=torch.zeros(2, 30, 8, 3, 5)), "do not match"),
    (dict(values=torch.zeros(2, 165, 8)), "expected values"),
])
def test_deform_sample_refuses_bad_shapes(change, match):
    args = dict(values=torch.zeros(2, 165, 8, 32),
                level_hw=[(10, 12), (5, 6), (3, 3)],
                locs=torch.zeros(2, 30, 8, 3, 4, 2),
                weights=torch.zeros(2, 30, 8, 3, 4))
    args.update(change)
    with pytest.raises(ValueError, match=match):
        cuda_deform.deform_sample(**args)


def _two_phase_mirror(values, level_hw, locs, weights):
    """numpy float32 mirror of csrc/deform.cu's two phases. Phase 1: per
    sample (item, level, point), the four clamped corner positions, the
    four bilinear products and the weight (the kernel's shared-memory
    table). Phase 2: per item, the gather in the kernel's order: per level
    c00 g00 + c01 g01 + c10 g10 + c11 g11 left to right, times the weight,
    summed over levels from 0, then over points from 0. Every numpy
    operation here rounds once in float32, as -fmad=false makes the
    kernel's."""
    f32 = np.float32
    b, _, heads, hd = values.shape
    _, q, _, n_levels, n_points, _ = locs.shape
    loc = locs.reshape(-1, n_levels, n_points, 2)
    items = loc.shape[0]
    pos = np.empty((items, n_levels, n_points, 4), np.int64)
    coef = np.empty((items, n_levels, n_points, 4), f32)
    start = 0
    for lvl, (h, w) in enumerate(level_hw):
        x = loc[:, lvl, :, 0] * f32(w) - f32(0.5)
        y = loc[:, lvl, :, 1] * f32(h) - f32(0.5)
        x0, y0 = np.floor(x), np.floor(y)
        fx, fy = x - x0, y - y0
        xa = np.clip(x0, 0, w - 1).astype(np.int64)
        xb = np.clip(x0 + f32(1), 0, w - 1).astype(np.int64)
        ya = start + np.clip(y0, 0, h - 1).astype(np.int64) * w
        yb = start + np.clip(y0 + f32(1), 0, h - 1).astype(np.int64) * w
        pos[:, lvl] = np.stack([ya + xa, ya + xb, yb + xa, yb + xb], -1)
        ox, oy = f32(1) - fx, f32(1) - fy
        coef[:, lvl] = np.stack([oy * ox, oy * fx, fy * ox, fy * fx], -1)
        start += h * w
    wgt = weights.reshape(items, n_levels, n_points)
    image = np.arange(items) // (q * heads)
    head = np.arange(items) % heads
    total = np.zeros((items, hd), f32)
    for p in range(n_points):
        acc = np.zeros((items, hd), f32)
        for lvl in range(n_levels):
            g = [values[image, pos[:, lvl, p, k], head] for k in range(4)]
            c = [coef[:, lvl, p, k, None] for k in range(4)]
            s = c[0] * g[0]
            s = s + c[1] * g[1]
            s = s + c[2] * g[2]
            s = s + c[3] * g[3]
            acc = acc + s * wgt[:, lvl, p, None]
        total = total + acc
    return total.reshape(b, q, heads, hd)


def _half_pixel_locs(rng, shape, level_hw):
    """Locations on multiples of half a pixel of each level, a little past
    the border too: the coordinates where a rounding error moves a corner."""
    locs = np.empty(shape, np.float32)
    for lvl, (h, w) in enumerate(level_hw):
        for axis, n in ((0, w), (1, h)):
            k = rng.integers(-2, 2 * n + 3, shape[:3] + shape[4:5])
            locs[:, :, :, lvl, :, axis] = (k / (2.0 * n)).astype(np.float32)
    return locs


@pytest.mark.parametrize("case", ["decoder", "outside", "half_pixel",
                                  "one_pixel"])
def test_two_phase_mirror_bit_equal_to_plain(case):
    """The kernel's arithmetic, a geometry table and then the gather, is
    bit-equal to ms_deformable_attention_reference (not merely within the
    tolerance): RT-DETR's shape (3 levels, 4 points, head dim 32) at small
    levels, locations outside [0, 1], on pixel centres and edges, and levels
    one pixel wide."""
    level_hw = {"one_pixel": [(4, 4), (1, 1), (1, 3)]}.get(
        case, [(12, 16), (6, 8), (3, 4)])
    lo, hi = {"outside": (-0.5, 1.5), "one_pixel": (-1.0, 2.0)}.get(
        case, (0.0, 1.0))
    values, locs, weights = _inputs(11, 2, 13, 8, 32, 4, level_hw, lo, hi)
    if case == "half_pixel":
        locs = _half_pixel_locs(np.random.default_rng(12), locs.shape, level_hw)
    flat = np.concatenate([v.reshape(2, -1, 8, 32) for v in values], 1)
    got = _two_phase_mirror(flat, level_hw, locs, weights)
    want = _port(values, locs, weights)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
