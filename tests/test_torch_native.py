"""The port's host frame library (telescope_cam_detection_tpu_torch/utils/native.py,
csrc/frameio.cpp) against cv2, the numpy packer and the JAX package's native
library, on the CPU.

Mirrors tests/test_native.py for the port's copy of the resize and YUV420
functions. The port's library builds with g++ into the package's _build/;
the JAX package's library is built from a copy of native/ under a temporary
directory, so no test writes into the repository's native/."""
import sys

import numpy as np
import pytest

from telescope_cam_detection_tpu_torch.ops import cuda_build
from telescope_cam_detection_tpu_torch.runtime.delta import pack_yuv420_numpy
from telescope_cam_detection_tpu_torch.utils import native
from torch_port_utils import redirect_jax_native


def test_resize_matches_cv2():
    import cv2
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (97, 133, 3), np.uint8)
    ours = native.resize_bilinear(frame, (48, 64))
    theirs = cv2.resize(frame, (64, 48), interpolation=cv2.INTER_LINEAR)
    diff = np.abs(ours.astype(int) - theirs.astype(int))
    # cv2 uses fixed-point arithmetic; the float path matches within 2 LSB
    assert diff.max() <= 2, diff.max()
    assert (diff > 1).mean() < 0.01


def test_resize_batch():
    rng = np.random.default_rng(1)
    frames = rng.integers(0, 256, (3, 64, 80, 3), np.uint8)
    out = native.resize_batch(frames, (32, 40))
    assert out.shape == (3, 32, 40, 3)
    for i in range(3):
        np.testing.assert_array_equal(out[i],
                                      native.resize_bilinear(frames[i], (32, 40)))


def test_resize_identity():
    rng = np.random.default_rng(2)
    frame = rng.integers(0, 256, (32, 32, 3), np.uint8)
    np.testing.assert_array_equal(native.resize_bilinear(frame, (32, 32)), frame)


def test_bgr_to_yuv420_roundtrip_luma():
    # uniform gray: Y == gray value, U == V == 128
    frame = np.full((16, 16, 3), 130, np.uint8)
    out = native.bgr_to_yuv420(frame)
    assert out.shape == (24, 16)
    assert np.all(np.abs(out[:16].astype(int) - 130) <= 1)
    assert np.all(np.abs(out[16:].astype(int) - 128) <= 1)


def test_bgr_to_yuv420_pure_blue():
    frame = np.zeros((8, 8, 3), np.uint8)
    frame[..., 0] = 255  # blue
    y = native.bgr_to_yuv420(frame)[:8]
    assert np.all(np.abs(y.astype(int) - 29) <= 1)  # 0.114*255


@pytest.mark.parametrize("hw", [(8, 8), (96, 128), (144, 256)])
def test_bgr_to_yuv420_bit_equal_to_numpy(hw):
    """The native packer that transfer="yuv420" runs and its plain numpy
    version agree bit for bit (Q16 fixed point, integer-exact)."""
    rng = np.random.default_rng(hw[0])
    frame = rng.integers(0, 256, (*hw, 3), np.uint8)
    frame[0, :4] = [[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 0, 255]]
    np.testing.assert_array_equal(native.bgr_to_yuv420(frame),
                                  pack_yuv420_numpy(frame))


def test_resize_bit_equal_to_jax_native(monkeypatch, tmp_path):
    """The port's copy and the JAX package's frameio, built with the same
    compiler and flags on this host, resize the same frames to the same
    bytes (downscale, upscale, odd sizes)."""
    jax_native = redirect_jax_native(monkeypatch, tmp_path)
    rng = np.random.default_rng(3)
    frames = rng.integers(0, 256, (2, 288, 512, 3), np.uint8)
    for out_hw in ((128, 128), (97, 131), (300, 520)):
        want = jax_native.resize_batch(frames, out_hw)
        assert want is not None, "the JAX package's frameio did not build"
        np.testing.assert_array_equal(native.resize_batch(frames, out_hw), want)
    assert jax_native._LIB_PATH.parent == tmp_path / "native"


def test_refuses_what_the_library_cannot_take():
    with pytest.raises(ValueError, match="uint8"):
        native.resize_batch(np.zeros((1, 8, 8, 3), np.float32), (4, 4))
    with pytest.raises(ValueError, match="3 channels"):
        native.resize_batch(np.zeros((1, 8, 8, 4), np.uint8), (4, 4))
    with pytest.raises(ValueError, match="even"):
        native.bgr_to_yuv420(np.zeros((7, 8, 3), np.uint8))


def test_failed_build_raises_with_the_compiler_output(monkeypatch, tmp_path):
    """A source that does not compile raises with g++'s message; no
    library is left half-written in the build directory."""
    bad = tmp_path / "bad.cpp"
    bad.write_text('extern "C" int f() { return undeclared_name; }\n')
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    lib = cuda_build.HostLibrary("frameio.cpp")
    lib.source = bad
    with pytest.raises(RuntimeError, match="undeclared_name"):
        lib.load()
    assert list((tmp_path / "build").iterdir()) == []


def test_no_compiler_raises(monkeypatch, tmp_path):
    """Without g++ on the path and no library built yet, the first call
    raises; nothing returns a result computed some other way."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(native, "LIBRARY", cuda_build.HostLibrary(
        "frameio.cpp", native._declare))
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        native.resize_batch(np.zeros((1, 8, 8, 3), np.uint8), (4, 4))
