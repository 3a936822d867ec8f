"""Batched class-aware NMS with static output shapes.

Counterpart of ``telescope_cam_detection_tpu/ops/nms.py``:

  raw head outputs (A anchors) -> confidence mask -> top-K prefilter ->
  greedy class-aware suppression -> fixed (max_det, 7) rows
  [x1, y1, x2, y2, obj_conf, class_conf, class_id], invalid rows all -1.

The JAX module vmaps per-image functions; here every function carries the
batch dimension itself. Greedy suppression goes through
``ops/cuda_nms.suppress``: the hand-written CUDA kernel for a CUDA tensor,
the plain fixpoint ``_greedy_suppress`` below for a CPU tensor.

Top-k is a stable descending sort, sliced: ``jax.lax.top_k`` puts the lower
index first among equal values, and ties are real here (saturated sigmoids
give exactly 1.0; every padded or invalid score is -1). ``torch.topk`` makes
no such promise on CUDA.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def iou_matrix(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU between (..., M, 4) and (..., N, 4) xyxy boxes ->
    (..., M, N). Widths clamp at 0; a pair whose union is not positive has
    IoU 0."""
    area_a = torch.clamp(boxes_a[..., 2] - boxes_a[..., 0], min=0) * \
        torch.clamp(boxes_a[..., 3] - boxes_a[..., 1], min=0)
    area_b = torch.clamp(boxes_b[..., 2] - boxes_b[..., 0], min=0) * \
        torch.clamp(boxes_b[..., 3] - boxes_b[..., 1], min=0)
    lt = torch.maximum(boxes_a[..., :, None, :2], boxes_b[..., None, :, :2])
    rb = torch.minimum(boxes_a[..., :, None, 2:], boxes_b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    positive = union > 0
    return torch.where(positive, inter / torch.where(positive, union, 1.0),
                       0.0)


def _greedy_suppress(iou: torch.Tensor, valid: torch.Tensor,
                     iou_threshold: float) -> torch.Tensor:
    """Greedy keep mask over score-desc-sorted candidates, (B, K, K) IoU and
    (B, K) valid -> (B, K) bool.

    keep[i] = valid[i] and no kept j<i has IoU(j,i) > threshold.

    The plain version of the CUDA kernel: the JAX package's fixpoint. Start
    with keep = valid and re-evaluate the recurrence as one masked (K, K)
    reduction until the mask stops changing (at most K passes; a fixpoint
    of one image stays fixed while the others converge)."""
    k = iou.shape[-1]
    upper = torch.ones(k, k, dtype=torch.bool, device=iou.device).triu(1)
    over = (iou > iou_threshold) & upper        # j < i, strictly upper
    keep = valid
    for _ in range(k):
        suppressed = (over & keep[..., :, None]).any(dim=-2)
        new_keep = valid & ~suppressed
        if torch.equal(new_keep, keep):
            break
        keep = new_keep
    return keep


def _stable_topk(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Top-k along the last dim with ``jax.lax.top_k``'s tie order (lower
    index first among equal values)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], idx[..., :k]


def _prep_single(boxes: torch.Tensor, obj_conf: torch.Tensor,
                 class_probs: torch.Tensor, conf_threshold: float,
                 pre_nms_topk: int, class_agnostic: bool):
    """Confidence mask + top-K prefilter + class coordinate offsets, over a
    batch: (B, A, 4), (B, A), (B, A, C) -> offset boxes (B, K, 4), valid,
    scores and anchor indices (B, K), class conf and ids (B, A)."""
    num_anchors = class_probs.shape[1]
    class_conf, class_id = torch.max(class_probs, dim=-1)
    score = obj_conf * class_conf
    valid = score >= conf_threshold

    k = min(pre_nms_topk, num_anchors)
    top_scores, top_idx = _stable_topk(
        torch.where(valid, score, torch.full_like(score, -1.0)), k)
    top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(-1, -1, 4))
    top_valid = top_scores >= 0.0
    top_cls = torch.gather(class_id, 1, top_idx)

    if class_agnostic:
        offset_boxes = top_boxes
    else:
        # torchvision batched_nms trick: displace each class into its own
        # coordinate region so cross-class pairs never overlap. The span is
        # per image, over its own top-k boxes.
        span = torch.amax(torch.abs(top_boxes), dim=(1, 2)) + 1.0
        offset_boxes = top_boxes + \
            (top_cls.to(top_boxes.dtype) * span[:, None])[..., None]
    return (offset_boxes.contiguous(), top_valid, top_scores, top_idx,
            class_conf, class_id)


def _compact_single(keep, top_scores, top_idx, boxes, obj_conf, class_conf,
                    class_id, max_det: int) -> torch.Tensor:
    """Kept rows -> front, score order preserved -> (B, max_det, 7)."""
    b, k = top_scores.shape
    kept_scores = torch.where(keep, top_scores,
                              torch.full_like(top_scores, -1.0))
    if max_det > k:  # pad the candidate pool so top-k(max_det) is well-formed
        pad = max_det - k
        kept_scores = torch.cat(
            [kept_scores, kept_scores.new_full((b, pad), -1.0)], dim=1)
        top_idx = torch.cat([top_idx, top_idx.new_zeros((b, pad))], dim=1)
    out_scores, order = _stable_topk(kept_scores, max_det)
    sel = torch.gather(top_idx, 1, order)
    rows = torch.cat([
        torch.gather(boxes, 1, sel[..., None].expand(-1, -1, 4)),
        torch.gather(obj_conf, 1, sel)[..., None],
        torch.gather(class_conf, 1, sel)[..., None],
        torch.gather(class_id, 1, sel).to(boxes.dtype)[..., None],
    ], dim=-1)
    # Invalidate rows beyond the kept count.
    return torch.where((out_scores >= 0.0)[..., None], rows,
                       torch.full_like(rows, -1.0))


def batched_nms(
    boxes: torch.Tensor,        # (B, A, 4)
    obj_conf: torch.Tensor,     # (B, A)
    class_probs: torch.Tensor,  # (B, A, C)
    conf_threshold: float = 0.25,
    iou_threshold: float = 0.45,
    max_det: int = 300,
    pre_nms_topk: int = 1000,
    class_agnostic: bool = False,
) -> torch.Tensor:
    """Batch of images -> (B, max_det, 7). Suppression runs in the CUDA
    kernel for CUDA tensors and in the plain version for CPU tensors."""
    from telescope_cam_detection_tpu_torch.ops.cuda_nms import suppress
    offset_boxes, top_valid, top_scores, top_idx, class_conf, class_id = \
        _prep_single(boxes, obj_conf, class_probs, conf_threshold,
                     pre_nms_topk, class_agnostic)
    keep = suppress(offset_boxes, top_valid, iou_threshold)
    return _compact_single(keep, top_scores, top_idx, boxes, obj_conf,
                           class_conf, class_id, max_det)


# ---------------------------------------------------------------------------
# Host-side reference implementation (numpy) for tests / parity checks
# ---------------------------------------------------------------------------

def nms_reference_numpy(
    boxes: np.ndarray,
    obj_conf: np.ndarray,
    class_probs: np.ndarray,
    conf_threshold: float,
    iou_threshold: float,
    max_det: int,
    class_agnostic: bool = False,
) -> np.ndarray:
    """Straightforward O(n^2) greedy NMS, torchvision-ordered. Returns
    (n_kept, 7) rows in score-descending order."""
    class_conf = class_probs.max(axis=-1)
    class_id = class_probs.argmax(axis=-1)
    score = obj_conf * class_conf
    idx = np.argsort(-score, kind="stable")
    idx = idx[score[idx] >= conf_threshold]

    kept = []
    for i in idx:
        ok = True
        for j in kept:
            if not class_agnostic and class_id[i] != class_id[j]:
                continue
            ix1 = max(boxes[i, 0], boxes[j, 0])
            iy1 = max(boxes[i, 1], boxes[j, 1])
            ix2 = min(boxes[i, 2], boxes[j, 2])
            iy2 = min(boxes[i, 3], boxes[j, 3])
            inter = max(0.0, ix2 - ix1) * max(0.0, iy2 - iy1)
            area_i = max(0.0, boxes[i, 2] - boxes[i, 0]) * max(0.0, boxes[i, 3] - boxes[i, 1])
            area_j = max(0.0, boxes[j, 2] - boxes[j, 0]) * max(0.0, boxes[j, 3] - boxes[j, 1])
            union = area_i + area_j - inter
            if union > 0 and inter / union > iou_threshold:
                ok = False
                break
        if ok:
            kept.append(i)
            if len(kept) >= max_det:
                break
    rows = [
        [*boxes[i], obj_conf[i], class_conf[i], float(class_id[i])]
        for i in kept
    ]
    return np.asarray(rows, dtype=np.float32).reshape(len(kept), 7)
