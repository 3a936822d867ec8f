"""Device-side batched crop extraction (ROI bilinear sampling).

Counterpart of ``telescope_cam_detection_tpu/ops/crops.py``. Crops are
sampled on the device from the detection frames that are already there: a
fixed number K of boxes per dispatch, each bilinearly resampled straight to
the classifier input resolution by gathers. No second host->device transfer,
no per-crop host resize.

sample_crops(frames, boxes, out_hw):
  frames: (B, H, W, 3) uint8/float
  boxes:  (K, 5) float — [batch_idx, x1, y1, x2, y2] in frame pixel coords;
          batch_idx < 0 marks padding (output garbage, callers mask).
  -> (K, out_h, out_w, 3) float32

Sampling uses half-pixel centers within the box (align_corners=False
convention), matching a cv2/torch resize of the equivalent host crop.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def sample_crops(frames: torch.Tensor, boxes: torch.Tensor,
                 out_hw: Tuple[int, int] = (336, 336)) -> torch.Tensor:
    b, h, w, c = frames.shape
    k = boxes.shape[0]
    oh, ow = out_hw
    dev = frames.device
    boxes = boxes.to(device=dev, dtype=torch.float32)

    batch_idx = torch.clamp(boxes[:, 0].to(torch.int64), 0, b - 1)   # (K,)
    x1, y1, x2, y2 = boxes[:, 1], boxes[:, 2], boxes[:, 3], boxes[:, 4]
    bw = torch.clamp(x2 - x1, min=1.0)
    bh = torch.clamp(y2 - y1, min=1.0)

    # output-pixel centers in source coords (half-pixel convention within
    # the box, like resizing the [x1:x2, y1:y2] crop to (oh, ow))
    gy = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) / oh
    gx = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) / ow
    sy = y1[:, None] + gy[None] * bh[:, None] - 0.5                  # (K, oh)
    sx = x1[:, None] + gx[None] * bw[:, None] - 0.5                  # (K, ow)

    sy = torch.clamp(sy, 0.0, h - 1.0)
    sx = torch.clamp(sx, 0.0, w - 1.0)
    y0 = torch.floor(sy)
    x0 = torch.floor(sx)
    fy = (sy - y0)[:, :, None, None]                                 # (K,oh,1,1)
    fx = (sx - x0)[:, None, :, None]                                 # (K,1,ow,1)
    y0i = y0.to(torch.int64)
    x0i = x0.to(torch.int64)
    y1i = torch.clamp(y0i + 1, max=h - 1)
    x1i = torch.clamp(x0i + 1, max=w - 1)

    flat = frames.reshape(b * h * w, c)
    base = batch_idx[:, None, None] * (h * w)

    def gather(yy: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
        idx = base + yy[:, :, None] * w + xx[:, None, :]             # (K,oh,ow)
        return flat[idx.reshape(-1)].reshape(k, oh, ow, c).float()

    g00 = gather(y0i, x0i)
    g01 = gather(y0i, x1i)
    g10 = gather(y1i, x0i)
    g11 = gather(y1i, x1i)
    return ((1 - fy) * (1 - fx) * g00 + (1 - fy) * fx * g01
            + fy * (1 - fx) * g10 + fy * fx * g11)


def boxes_with_padding(frame_hw: Tuple[int, int], bboxes, batch_indices,
                       padding_percent: float, k: int) -> np.ndarray:
    """Host helper: detection bboxes -> (K, 5) padded-box array for
    sample_crops. Applies the percentage padding + frame clamp of the host
    crop path (``TwoStageDetectionPipeline.extract_crop``); rows beyond
    len(bboxes) get batch_idx=-1."""
    h, w = frame_hw
    out = np.full((k, 5), -1.0, np.float32)
    pad = padding_percent / 100.0
    for i, (bidx, bb) in enumerate(zip(batch_indices, bboxes)):
        if i >= k:
            break
        x1, y1, x2, y2 = bb["x1"], bb["y1"], bb["x2"], bb["y2"]
        bw_, bh_ = max(x2 - x1, 1.0), max(y2 - y1, 1.0)
        out[i] = [bidx,
                  max(0.0, x1 - bw_ * pad / 2),
                  max(0.0, y1 - bh_ * pad / 2),
                  min(float(w), x2 + bw_ * pad / 2),
                  min(float(h), y2 + bh_ * pad / 2)]
    return out
