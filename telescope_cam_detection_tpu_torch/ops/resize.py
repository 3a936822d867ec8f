"""Bilinear resize as two fp32 matrix products.

Counterpart of ``telescope_cam_detection_tpu/ops/resize.py``: the resize is
a separable linear map, so the (out, in) interpolation matrices are built
once per shape pair and device and applied as two dense products. Half-pixel
centres, edges clamped, no antialias: torch
``F.interpolate(mode='bilinear', align_corners=False)``. The products run in
full fp32 (``device.resolve_device`` turns TF32 off), as the JAX package pins
``Precision.HIGHEST``.
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=256)
def _resize_matrix_np(in_size: int, out_size: int) -> np.ndarray:
    """(out_size, in_size) bilinear interpolation matrix, half-pixel centers,
    edges clamped — the align_corners=False convention."""
    out = np.zeros((out_size, in_size), dtype=np.float32)
    if in_size == out_size:
        np.fill_diagonal(out, 1.0)
        return out
    scale = in_size / out_size
    for i in range(out_size):
        src = (i + 0.5) * scale - 0.5
        src_clamped = min(max(src, 0.0), in_size - 1)
        lo = int(np.floor(src_clamped))
        hi = min(lo + 1, in_size - 1)
        frac = src_clamped - lo
        out[i, lo] += 1.0 - frac
        out[i, hi] += frac
    return out


@functools.lru_cache(maxsize=64)
def resize_matrices(in_hw: Tuple[int, int], out_hw: Tuple[int, int],
                    device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Return (R_h, R_w) with shapes (out_h, in_h) and (out_w, in_w) as fp32
    tensors on ``device``, cached per (shapes, device)."""
    r_h = torch.from_numpy(_resize_matrix_np(in_hw[0], out_hw[0]))
    r_w = torch.from_numpy(_resize_matrix_np(in_hw[1], out_hw[1]))
    return r_h.to(device), r_w.to(device)


def resize_bilinear_nhwc(images: torch.Tensor,
                         out_hw: Tuple[int, int]) -> torch.Tensor:
    """Resize (N, H, W, C) -> (N, h, w, C) fp32 via two matmuls.

    Matches torch F.interpolate(..., mode='bilinear', align_corners=False)
    for float inputs."""
    _, h, w, _ = images.shape
    r_h, r_w = resize_matrices((h, w), tuple(out_hw), images.device)
    x = images.float()
    x = torch.einsum("oh,nhwc->nowc", r_h, x)
    return torch.einsum("pw,nowc->nopc", r_w, x)
