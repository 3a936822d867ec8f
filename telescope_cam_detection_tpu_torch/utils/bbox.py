"""Bounding-box validation applied at every consumer boundary.

Behavioral parity with the reference's ``src/bbox_utils.py:12-122``:
inverted coordinates are swapped, a minimum size is enforced, and
width/height/area are recomputed. Counterpart of
``telescope_cam_detection_tpu/utils/bbox.py``; ``sanitize_boxes`` is the
vectorized tensor variant (``sanitize_boxes_jax`` there) for on-device use.
"""
from __future__ import annotations

import logging
from typing import Any, Dict, Tuple

import torch

logger = logging.getLogger(__name__)

BBoxDict = Dict[str, Any]


def ensure_valid_bbox(bbox: BBoxDict, min_size: int = 1) -> BBoxDict:
    """Normalize a bbox dict: swap inverted coords, clamp to min size,
    recompute width/height/area. Reference: bbox_utils.py:12."""
    x1, y1, x2, y2 = validate_bbox_coords(
        bbox["x1"], bbox["y1"], bbox["x2"], bbox["y2"], min_size=min_size
    )
    w, h = x2 - x1, y2 - y1
    return {"x1": x1, "y1": y1, "x2": x2, "y2": y2,
            "width": w, "height": h, "area": w * h}


def validate_bbox_coords(
    x1: float, y1: float, x2: float, y2: float, min_size: int = 1
) -> Tuple[float, float, float, float]:
    """Tuple-form normalization. Reference: bbox_utils.py:62."""
    if x1 > x2:
        x1, x2 = x2, x1
    if y1 > y2:
        y1, y2 = y2, y1
    if x2 - x1 < min_size:
        x2 = x1 + min_size
    if y2 - y1 < min_size:
        y2 = y1 + min_size
    return (x1, y1, x2, y2)


def is_valid_bbox(bbox: BBoxDict, min_size: int = 1) -> bool:
    """Strict validity check (no normalization). Reference: bbox_utils.py:88."""
    try:
        x1, y1, x2, y2 = bbox["x1"], bbox["y1"], bbox["x2"], bbox["y2"]
    except (KeyError, TypeError):
        return False
    if x1 >= x2 or y1 >= y2:
        return False
    if x2 - x1 < min_size or y2 - y1 < min_size:
        return False
    if min(x1, y1, x2, y2) < 0:
        return False
    return True


def sanitize_boxes(boxes: torch.Tensor, min_size: float = 1.0) -> torch.Tensor:
    """Vectorized equivalent of :func:`validate_bbox_coords` for (..., 4)
    xyxy tensors (swap + min-size clamp)."""
    x1 = torch.minimum(boxes[..., 0], boxes[..., 2])
    y1 = torch.minimum(boxes[..., 1], boxes[..., 3])
    x2 = torch.maximum(boxes[..., 0], boxes[..., 2])
    y2 = torch.maximum(boxes[..., 1], boxes[..., 3])
    x2 = torch.maximum(x2, x1 + min_size)
    y2 = torch.maximum(y2, y1 + min_size)
    return torch.stack([x1, y1, x2, y2], dim=-1)


def bbox_iou(a: BBoxDict, b: BBoxDict) -> float:
    """IoU between two bbox dicts (host-side, used by the golden comparator)."""
    ix1 = max(a["x1"], b["x1"])
    iy1 = max(a["y1"], b["y1"])
    ix2 = min(a["x2"], b["x2"])
    iy2 = min(a["y2"], b["y2"])
    iw = max(0.0, ix2 - ix1)
    ih = max(0.0, iy2 - iy1)
    inter = iw * ih
    area_a = max(0.0, a["x2"] - a["x1"]) * max(0.0, a["y2"] - a["y1"])
    area_b = max(0.0, b["x2"] - b["x1"]) * max(0.0, b["y2"] - b["y1"])
    union = area_a + area_b - inter
    return inter / union if union > 0 else 0.0
