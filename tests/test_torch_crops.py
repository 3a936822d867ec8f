"""Port crop sampling and classifier preprocess
(telescope_cam_detection_tpu_torch/ops/crops.py, ops/preprocess.py,
utils/bbox.py) against the JAX package on the CPU, same numpy inputs.

Tolerances, on the 0..255 pixel scale:

- ``preprocess_classifier``: 1e-3 (two fp32 matrix products summed in
  another order), which is 1.5e-5 after the 1/255 and 1/std of the output.
- ``sample_crops`` on smooth frames (neighbouring pixels a few levels
  apart, as camera frames are): 1e-3.
- ``sample_crops`` on uint8 noise frames: 5e-3. The source coordinate
  ``y1 + g * bh - 0.5`` is one fp32 ulp apart between the two (XLA contracts
  it into an FMA, torch rounds the product first): 7.6e-6 for coordinates
  below 128, times a pixel step of up to 255, in x and in y, is 3.9e-3. The
  blend itself is summed in the same order in both.

``boxes_with_padding`` and the bbox helpers are host arithmetic and equal."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from telescope_cam_detection_tpu.ops import crops as jax_crops
from telescope_cam_detection_tpu.ops import preprocess as jax_pre
from telescope_cam_detection_tpu.utils import bbox as jax_bbox
from telescope_cam_detection_tpu_torch.ops import crops as port_crops
from telescope_cam_detection_tpu_torch.ops import preprocess as port_pre
from telescope_cam_detection_tpu_torch.utils import bbox as port_bbox
import torch_port_utils  # noqa: F401  (caps torch's threads per worker)

PIXEL_TOL = 1e-3
NOISE_TOL = 5e-3


def _frames(b=3, h=90, w=120, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (b, h, w, 3), np.uint8)


def _smooth_frames(b=3, h=90, w=120):
    """Gradients and a slow wave: neighbouring pixels at most 4 levels apart."""
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    planes = [np.stack([2.0 * x + 0.5 * y + 10 * i,
                        200 - 1.5 * y + 20 * np.sin(x / 9.0 + i),
                        0.01 * x * y + 30 * i], -1) for i in range(b)]
    return np.clip(np.stack(planes), 0, 255).astype(np.uint8)


def _both(frames, boxes, out_hw):
    want = np.asarray(jax_crops.sample_crops(
        jnp.asarray(frames), jnp.asarray(boxes), out_hw))
    got = port_crops.sample_crops(torch.from_numpy(frames),
                                  torch.from_numpy(boxes), out_hw)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    return got.numpy(), want


BOX_CASES = {
    "inner boxes, every frame": [[0, 10.3, 5.2, 80.7, 60.1],
                                 [1, 0, 0, 50, 50], [2, 33.3, 20, 119, 89]],
    "identity box": [[0, 0, 0, 120, 90]],
    "padded rows": [[1, 20, 10, 60, 70], [-1, -1, -1, -1, -1],
                    [-1, -1, -1, -1, -1], [-1, -1, -1, -1, -1]],
    "past the frame edge": [[2, -15.5, -8.0, 40, 30], [0, 100, 70, 140, 110],
                            [1, 118, 88, 130, 95]],
    "degenerate and inverted": [[0, 50, 40, 50.2, 40.1], [1, 60, 50, 30, 20]],
    "fractional batch index": [[1.7, 5, 5, 50, 50], [7, 5, 5, 50, 50]],
}


@pytest.mark.parametrize("name", sorted(BOX_CASES))
@pytest.mark.parametrize("out_hw", [(56, 56), (24, 40)])
def test_sample_crops_matches_jax(name, out_hw):
    boxes = np.asarray(BOX_CASES[name], np.float32)
    got, want = _both(_smooth_frames(), boxes, out_hw)
    np.testing.assert_allclose(got, want, rtol=0, atol=PIXEL_TOL)


@pytest.mark.parametrize("name", sorted(BOX_CASES))
def test_sample_crops_matches_jax_on_noise(name):
    boxes = np.asarray(BOX_CASES[name], np.float32)
    got, want = _both(_frames(), boxes, (56, 56))
    np.testing.assert_allclose(got, want, rtol=0, atol=NOISE_TOL)


def test_sample_crops_identity_and_batch_index():
    frames = _frames(b=2, h=32, w=32, seed=1)
    boxes = np.asarray([[0, 0, 0, 32, 32], [1, 0, 0, 32, 32]], np.float32)
    got, want = _both(frames, boxes, (32, 32))
    np.testing.assert_allclose(got, want, rtol=0, atol=NOISE_TOL)
    # an identity box at the frame's own size samples pixel centres exactly
    np.testing.assert_allclose(got[0], frames[0], atol=PIXEL_TOL)
    np.testing.assert_allclose(got[1], frames[1], atol=PIXEL_TOL)


def test_sample_crops_float_frames():
    frames = _frames(b=1).astype(np.float32) / 3.0
    boxes = np.asarray([[0, 4.5, 3.5, 100, 77]], np.float32)
    got, want = _both(frames, boxes, (20, 20))
    np.testing.assert_allclose(got, want, rtol=0, atol=NOISE_TOL)


@pytest.mark.parametrize("padding,k", [(20.0, 4), (0.0, 2), (50.0, 1)])
def test_boxes_with_padding_equal(padding, k):
    bboxes = [{"x1": 10, "y1": 20, "x2": 110, "y2": 70},
              {"x1": 0.0, "y1": 0.0, "x2": 5.0, "y2": 5.0},
              {"x1": 600.5, "y1": 400.25, "x2": 640.0, "y2": 480.0}]
    want = jax_crops.boxes_with_padding((480, 640), bboxes, [0, 1, 0], padding, k)
    got = port_crops.boxes_with_padding((480, 640), bboxes, [0, 1, 0], padding, k)
    assert got.dtype == np.float32 and got.shape == (k, 5)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("in_hw,out", [((90, 80), 56), ((56, 56), 56),
                                       ((30, 200), 112)])
def test_preprocess_classifier_matches_jax(in_hw, out):
    crops = _frames(b=2, h=in_hw[0], w=in_hw[1], seed=2)
    want = np.asarray(jax_pre.preprocess_classifier(jnp.asarray(crops),
                                                    (out, out)))
    got = port_pre.preprocess_classifier(torch.from_numpy(crops), (out, out))
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, out, out, 3)
    # 1e-3 of a pixel, carried through 1/255 and the smallest std (0.261)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=PIXEL_TOL / 255.0 / 0.261)
    assert port_pre.CLIP_MEAN == jax_pre.CLIP_MEAN
    assert port_pre.CLIP_STD == jax_pre.CLIP_STD


def test_preprocess_classifier_swaps_channels_and_normalises():
    crops = np.zeros((1, 8, 8, 3), np.uint8)
    crops[..., 0] = 255                                 # blue in BGR
    got = port_pre.preprocess_classifier(torch.from_numpy(crops), (8, 8))[0, 0, 0]
    mean, std = np.asarray(port_pre.CLIP_MEAN), np.asarray(port_pre.CLIP_STD)
    np.testing.assert_allclose(got.numpy(), (np.asarray([0, 0, 1.0]) - mean) / std,
                               rtol=1e-5, atol=1e-5)    # fp32 division vs 1/std


def test_bbox_helpers_equal():
    rng = np.random.default_rng(3)
    for _ in range(50):
        x1, y1, x2, y2 = (float(v) for v in rng.uniform(-5, 50, 4))
        bb = {"x1": x1, "y1": y1, "x2": x2, "y2": y2}
        other = {"x1": 10.0, "y1": 10.0, "x2": 30.0, "y2": 25.0}
        assert port_bbox.validate_bbox_coords(x1, y1, x2, y2, 2) == \
            jax_bbox.validate_bbox_coords(x1, y1, x2, y2, 2)
        assert port_bbox.ensure_valid_bbox(bb) == jax_bbox.ensure_valid_bbox(bb)
        assert port_bbox.is_valid_bbox(bb) == jax_bbox.is_valid_bbox(bb)
        assert port_bbox.bbox_iou(bb, other) == jax_bbox.bbox_iou(bb, other)
    assert not port_bbox.is_valid_bbox({"x1": 0})
    boxes = rng.uniform(-5, 50, (4, 7, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        port_bbox.sanitize_boxes(torch.from_numpy(boxes), 1.5).numpy(),
        np.asarray(jax_bbox.sanitize_boxes_jax(jnp.asarray(boxes), 1.5)))
