"""ctypes bindings for the port's host frame library (``csrc/frameio.cpp``).

Counterpart of the resize and packing functions of
``telescope_cam_detection_tpu/utils/native.py``. The library is built with
``g++`` at first use into the package's ``_build/`` (``ops/cuda_build.py
HostLibrary``). A failed build raises with the compiler's output; nothing
here returns ``None`` for the caller to do something else instead.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from telescope_cam_detection_tpu_torch.ops.cuda_build import HostLibrary


def _declare(lib: ctypes.CDLL) -> None:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    lib.frameio_resize_bilinear_u8.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.frameio_resize_bilinear_u8.restype = None
    lib.frameio_resize_batch_u8.argtypes = [
        u8p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        u8p, ctypes.c_int, ctypes.c_int]
    lib.frameio_resize_batch_u8.restype = None
    lib.frameio_bgr_to_yuv420.argtypes = [u8p, ctypes.c_int, ctypes.c_int, u8p]
    lib.frameio_bgr_to_yuv420.restype = None


LIBRARY = HostLibrary("frameio.cpp", _declare)


def _ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _u8(frames: np.ndarray, ndim: int) -> np.ndarray:
    if frames.dtype != np.uint8 or frames.ndim != ndim:
        raise ValueError(f"expected a {ndim}-d uint8 array, got "
                         f"{frames.dtype} {frames.shape}")
    return np.ascontiguousarray(frames)


def resize_bilinear(frame: np.ndarray, out_hw: Tuple[int, int],
                    n_threads: int = 4) -> np.ndarray:
    """(H, W, C) uint8 -> (h, w, C), half-pixel bilinear."""
    frame = _u8(frame, 3)
    h, w = out_hw
    out = np.empty((h, w, frame.shape[2]), np.uint8)
    LIBRARY.load().frameio_resize_bilinear_u8(
        _ptr(frame), frame.shape[0], frame.shape[1], frame.shape[2],
        _ptr(out), h, w, n_threads)
    return out


def resize_batch(frames: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """(N, H, W, 3) uint8 -> (N, h, w, 3), one thread per frame."""
    frames = _u8(frames, 4)
    n, sh, sw, c = frames.shape
    if c != 3:
        raise ValueError(f"expected 3 channels, got {frames.shape}")
    h, w = out_hw
    out = np.empty((n, h, w, 3), np.uint8)
    LIBRARY.load().frameio_resize_batch_u8(_ptr(frames), n, sh, sw, _ptr(out),
                                           h, w)
    return out


def bgr_to_yuv420(frame: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 BGR -> (H*3//2, W) planar I420, full-range BT.601;
    H and W must be even."""
    frame = _u8(frame, 3)
    h, w, c = frame.shape
    if c != 3 or h % 2 or w % 2:
        raise ValueError(f"expected (H, W, 3) with H and W even, got "
                         f"{frame.shape}")
    out = np.empty((h * 3 // 2, w), np.uint8)
    LIBRARY.load().frameio_bgr_to_yuv420(_ptr(frame), h, w, _ptr(out))
    return out
