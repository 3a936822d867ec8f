"""On-device preprocess: uint8 BGR frames -> detector/classifier input.

Counterpart of ``telescope_cam_detection_tpu/ops/preprocess.py``, with its
three pixel conventions:
  * YOLOX: plain bilinear stretch (no letterbox), stays BGR, raw 0..255
    floats, no normalisation.
  * RT-DETR: resize, BGR->RGB, scale to 0..1.
  * EVA02 classifier: resize, BGR->RGB, scale to 0..1, CLIP mean/std.
"""
from __future__ import annotations

from typing import Tuple

import torch

from telescope_cam_detection_tpu_torch.ops.resize import resize_bilinear_nhwc


# OpenAI-CLIP normalization used by EVA02 (timm cfg for eva02_large_clip_336)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess_yolox(frames_bgr_u8: torch.Tensor,
                     out_hw: Tuple[int, int]) -> torch.Tensor:
    """(N,H,W,3) uint8 BGR -> (N,h,w,3) fp32 BGR in 0..255."""
    return resize_bilinear_nhwc(frames_bgr_u8, out_hw)


def preprocess_rtdetr(frames_bgr_u8: torch.Tensor,
                      out_hw: Tuple[int, int]) -> torch.Tensor:
    """(N,H,W,3) uint8 BGR -> (N,h,w,3) fp32 RGB in 0..1. Multiplies by the
    reciprocal of 255, as the JAX package does (not a division)."""
    return resize_bilinear_nhwc(frames_bgr_u8, out_hw).flip(-1) * (1.0 / 255.0)


def preprocess_classifier(
    crops_bgr_u8: torch.Tensor,
    out_hw: Tuple[int, int],
    mean: Tuple[float, float, float] = CLIP_MEAN,
    std: Tuple[float, float, float] = CLIP_STD,
) -> torch.Tensor:
    """(N,H,W,3) uint8 BGR crops -> (N,h,w,3) normalized RGB fp32."""
    x = resize_bilinear_nhwc(crops_bgr_u8, out_hw)
    return normalize_rgb(x.flip(-1) * (1.0 / 255.0), mean, std)


def normalize_rgb(x: torch.Tensor,
                  mean: Tuple[float, float, float] = CLIP_MEAN,
                  std: Tuple[float, float, float] = CLIP_STD) -> torch.Tensor:
    """(x - mean) * (1 / std) over the last (channel) axis of 0..1 RGB."""
    mean_t = torch.tensor(mean, dtype=torch.float32, device=x.device)
    inv_std = 1.0 / torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - mean_t) * inv_std


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
