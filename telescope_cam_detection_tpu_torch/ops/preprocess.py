"""On-device preprocess: uint8 BGR frames -> YOLOX input, and back.

Counterpart of ``telescope_cam_detection_tpu/ops/preprocess.py`` for the
YOLOX convention: plain bilinear stretch (no letterbox), stays BGR, raw
0..255 floats, no normalisation. The RT-DETR and classifier conventions
come with their slices.
"""
from __future__ import annotations

from typing import Tuple

import torch

from telescope_cam_detection_tpu_torch.ops.resize import resize_bilinear_nhwc


def preprocess_yolox(frames_bgr_u8: torch.Tensor,
                     out_hw: Tuple[int, int]) -> torch.Tensor:
    """(N,H,W,3) uint8 BGR -> (N,h,w,3) fp32 BGR in 0..255."""
    return resize_bilinear_nhwc(frames_bgr_u8, out_hw)


def scale_boxes_back(boxes: torch.Tensor, model_hw: Tuple[int, int],
                     orig_hw: Tuple[int, int]) -> torch.Tensor:
    """Map xyxy boxes from model input coords back to original frame coords
    (inverse of the plain-stretch resize)."""
    sy = orig_hw[0] / model_hw[0]
    sx = orig_hw[1] / model_hw[1]
    scale = torch.tensor([sx, sy, sx, sy], dtype=boxes.dtype,
                         device=boxes.device)
    return boxes * scale


def yuv420_to_bgr(yuv: torch.Tensor) -> torch.Tensor:
    """(B, H*3//2, W) planar I420 uint8 -> (B, H, W, 3) fp32 BGR.

    Nearest-neighbour chroma upsample + full-range BT.601 inverse, the
    device half of ``transfer="yuv420"`` (``runtime/delta.py`` packs)."""
    b, h15, w = yuv.shape
    h = h15 * 2 // 3
    y = yuv[:, :h, :].float()
    u = yuv[:, h:h + h // 4, :].reshape(b, h // 2, w // 2)
    v = yuv[:, h + h // 4:, :].reshape(b, h // 2, w // 2)

    def up2(c: torch.Tensor) -> torch.Tensor:
        c = c[:, :, None, :, None].expand(b, h // 2, 2, w // 2, 2)
        return c.reshape(b, h, w).float()

    u = up2(u) - 128.0
    v = up2(v) - 128.0
    r = y + 1.403 * v
    g = y - 0.714 * v - 0.344 * u
    bch = y + 1.773 * u
    return torch.clamp(torch.stack([bch, g, r], dim=-1), 0.0, 255.0)
