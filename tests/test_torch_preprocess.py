"""Port preprocess (telescope_cam_detection_tpu_torch/ops/resize.py,
ops/preprocess.py, runtime/delta.py) against the JAX package, on the CPU.

Resize and preprocess are fp32 matrix products whose sums run in another
order in the two frameworks: within 1e-4 on 0..255 pixel values. The
YUV 4:2:0 unpack and the integer packer are elementwise and bit-equal."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from telescope_cam_detection_tpu.ops import preprocess as jax_pre
from telescope_cam_detection_tpu.ops import resize as jax_resize
from telescope_cam_detection_tpu.runtime.program import _pack_yuv420_numpy
from telescope_cam_detection_tpu_torch.ops import preprocess as port_pre
from telescope_cam_detection_tpu_torch.ops import resize as port_resize
from telescope_cam_detection_tpu_torch.runtime.delta import pack_yuv420_numpy
from telescope_cam_detection_tpu_torch.utils.frames import SyntheticFrameSource


def _frames(n, h, w, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (n, h, w, 3),
                                                np.uint8)


@pytest.mark.parametrize("in_hw,out_hw", [
    ((48, 64), (96, 80)),     # upscale
    ((90, 160), (64, 64)),    # downscale, the 16:9 capture -> square case
    ((64, 64), (64, 64)),     # identity
])
def test_resize_and_preprocess_match_jax(in_hw, out_hw):
    frames = _frames(2, *in_hw)
    want = np.asarray(jax_pre.preprocess_yolox(jnp.asarray(frames), out_hw))
    got = port_pre.preprocess_yolox(torch.from_numpy(frames), out_hw).numpy()
    assert got.shape == want.shape == (2, *out_hw, 3)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
    np.testing.assert_array_equal(
        port_resize._resize_matrix_np(in_hw[0], out_hw[0]),
        jax_resize._resize_matrix_np(in_hw[0], out_hw[0]))


def test_resize_matches_torch_interpolate():
    frames = _frames(1, 30, 50).astype(np.float32)
    got = port_resize.resize_bilinear_nhwc(torch.from_numpy(frames), (45, 20))
    want = torch.nn.functional.interpolate(
        torch.from_numpy(frames).permute(0, 3, 1, 2), size=(45, 20),
        mode="bilinear", align_corners=False,
        antialias=False).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-3)


def test_scale_boxes_back_matches_jax():
    boxes = np.random.default_rng(1).uniform(0, 640, (2, 7, 4)).astype(
        np.float32)
    want = np.asarray(jax_pre.scale_boxes_back(jnp.asarray(boxes), (640, 640),
                                               (1440, 2560)))
    got = port_pre.scale_boxes_back(torch.from_numpy(boxes), (640, 640),
                                    (1440, 2560)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_yuv420_pack_and_unpack_bit_equal(seed):
    rng = np.random.default_rng(seed)
    frames = [rng.integers(0, 256, (32, 48, 3), np.uint8),
              SyntheticFrameSource(width=64, height=48, seed=seed).frame_at(3)]
    for frame in frames:
        packed = pack_yuv420_numpy(frame)
        np.testing.assert_array_equal(packed, _pack_yuv420_numpy(frame))
        want = np.asarray(jax_pre.yuv420_to_bgr(jnp.asarray(packed[None])))
        got = port_pre.yuv420_to_bgr(torch.from_numpy(packed[None])).numpy()
        assert got.shape == (1, *frame.shape)
        np.testing.assert_array_equal(got, want)
