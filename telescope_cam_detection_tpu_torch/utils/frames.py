"""Synthetic frame source for hermetic tests and the chip smoke run.

A copy of ``SyntheticFrameSource`` and its helpers from
``telescope_cam_detection_tpu/utils/frames.py`` (numpy only). Frame dicts
follow the capture contract:
  {frame: np.uint8 HxWx3 BGR, timestamp: float, frame_id: int,
   camera_id: str, camera_name: str}
"""
from __future__ import annotations

import time
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np


def make_frame_dict(
    frame: np.ndarray,
    frame_id: int,
    camera_id: str = "cam1",
    camera_name: str = "Test Camera",
    timestamp: Optional[float] = None,
) -> Dict[str, Any]:
    return {
        "frame": frame,
        "timestamp": time.time() if timestamp is None else timestamp,
        "frame_id": frame_id,
        "camera_id": camera_id,
        "camera_name": camera_name,
    }


def _smooth_background(rng: np.random.Generator, width: int,
                       height: int) -> np.ndarray:
    """Smooth low-frequency background (like a real outdoor scene), not
    per-pixel noise: real camera frames are spatially correlated, which
    matters for anything measuring transfer/encode behavior."""
    coarse = rng.integers(60, 140, size=(max(height // 32, 1),
                                         max(width // 32, 1), 3))
    ys = np.linspace(0, coarse.shape[0] - 1, height)
    xs = np.linspace(0, coarse.shape[1] - 1, width)
    yi, xi = np.floor(ys).astype(int), np.floor(xs).astype(int)
    yf, xf = (ys - yi)[:, None, None], (xs - xi)[None, :, None]
    y1 = np.minimum(yi + 1, coarse.shape[0] - 1)
    x1 = np.minimum(xi + 1, coarse.shape[1] - 1)
    base = ((1 - yf) * (1 - xf) * coarse[np.ix_(yi, xi)]
            + (1 - yf) * xf * coarse[np.ix_(yi, x1)]
            + yf * (1 - xf) * coarse[np.ix_(y1, xi)]
            + yf * xf * coarse[np.ix_(y1, x1)])
    return np.clip(base, 0, 255).astype(np.uint8)


class SyntheticFrameSource:
    """Deterministic frame generator: static desert-like background with an
    optional moving bright blob (the "animal"). Seeded so runs are
    reproducible across backends."""

    def __init__(
        self,
        width: int = 640,
        height: int = 640,
        seed: int = 0,
        moving_object: bool = True,
        object_size: int = 60,
        noise_sigma: float = 2.0,
    ):
        self.width = width
        self.height = height
        self.moving_object = moving_object
        self.object_size = object_size
        self.noise_sigma = noise_sigma
        rng = np.random.default_rng(seed)
        self._background = _smooth_background(rng, width, height)
        # Sensor noise: one precomputed plane, spatially rolled per frame,
        # so frame_at(i) is pure in i and cheap at 1440p.
        if noise_sigma > 0:
            self._noise = rng.normal(0.0, noise_sigma,
                                     size=(height, width, 3)).astype(np.int16)
        else:
            self._noise = None
        self._rng = rng
        self._frame_id = 0

    def object_position(self, frame_id: int) -> Tuple[int, int]:
        """Top-left corner of the moving blob on a diagonal trajectory."""
        span_x = max(1, self.width - self.object_size - 1)
        span_y = max(1, self.height - self.object_size - 1)
        x = (frame_id * 7) % span_x
        y = (frame_id * 5) % span_y
        return x, y

    def frame_at(self, frame_id: int) -> np.ndarray:
        if self._noise is not None:
            dy = (frame_id * 31 + 7) % self.height
            dx = (frame_id * 57 + 3) % self.width
            noise = np.roll(self._noise, (dy, dx), axis=(0, 1))
            frame = np.clip(self._background.astype(np.int16) + noise,
                            0, 255).astype(np.uint8)
        else:
            frame = self._background.copy()
        if self.moving_object:
            x, y = self.object_position(frame_id)
            s = self.object_size
            frame[y:y + s, x:x + s, :] = (200, 180, 160)  # bright BGR blob
        return frame

    def __iter__(self) -> Iterator[Dict[str, Any]]:
        return self

    def __next__(self) -> Dict[str, Any]:
        frame = self.frame_at(self._frame_id)
        d = make_frame_dict(frame, self._frame_id)
        self._frame_id += 1
        return d
