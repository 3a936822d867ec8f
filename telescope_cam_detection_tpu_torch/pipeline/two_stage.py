"""Two-stage detection pipeline: Stage-1 boxes -> batched Stage-2 species IDs.

Counterpart of ``telescope_cam_detection_tpu/pipeline/two_stage.py``: instead
of one classifier forward per detection, eligible crops are sampled on the
device from the frame that is already there (``device_crops``), or extracted
host-side and resized to a common square, and classified as ONE padded
device batch — Stage-2 latency stays bounded as detection count grows.

Preserved semantics: bbox validation, min-crop-size gate, percentage padding
around the box, optional enhancement with an LRU cache keyed by an 8x8
thumbnail hash, time-of-day re-ranking (penalize inactive species, re-sort),
and rejection of vague taxonomic levels (order/class).
"""
from __future__ import annotations

import hashlib
import logging
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from telescope_cam_detection_tpu_torch.coco_constants import CLASS_ID_TO_CATEGORY
from telescope_cam_detection_tpu_torch.ops.crops import boxes_with_padding
from telescope_cam_detection_tpu_torch.pipeline.activity import is_species_likely_active
from telescope_cam_detection_tpu_torch.pipeline.species import crop_bucket
from telescope_cam_detection_tpu_torch.utils.bbox import validate_bbox_coords

logger = logging.getLogger(__name__)

# taxonomic levels too vague to surface as species labels
# (two_stage_pipeline_yolox.py:432-439)
VAGUE_LEVELS = ("order", "class")


class EnhancementCache:
    """LRU cache of enhanced crops keyed by an 8x8-grayscale-thumbnail MD5
    (reference two_stage_pipeline_yolox.py:142-160,312-368): enhancement is
    costly per crop, and repeated animals at similar positions hit often."""

    def __init__(self, max_entries: int = 100):
        self.max_entries = max_entries
        self._cache: OrderedDict[str, np.ndarray] = OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    @staticmethod
    def crop_key(crop: np.ndarray) -> str:
        h, w = crop.shape[:2]
        ys = np.linspace(0, h - 1, 8).astype(int)
        xs = np.linspace(0, w - 1, 8).astype(int)
        thumb = crop[np.ix_(ys, xs)].mean(axis=-1).astype(np.uint8)
        # shape is part of the key: different-sized crops must never share
        # an entry (the cached value may be an upscaled enhancement output)
        return hashlib.md5(f"{h}x{w}:".encode()
                           + thumb.tobytes()).hexdigest()

    def get(self, key: str) -> Optional[np.ndarray]:
        with self._lock:
            if key in self._cache:
                self._cache.move_to_end(key)
                self.hits += 1
                return self._cache[key]
            self.misses += 1
            return None

    def put(self, key: str, value: np.ndarray) -> None:
        with self._lock:
            self._cache[key] = value
            self._cache.move_to_end(key)
            while len(self._cache) > self.max_entries:
                self._cache.popitem(last=False)

    def stats(self) -> Dict[str, Any]:
        total = self.hits + self.misses
        return {"entries": len(self._cache), "hits": self.hits,
                "misses": self.misses,
                "hit_rate": self.hits / total if total else 0.0}


class TwoStageDetectionPipeline:
    def __init__(
        self,
        species_classifier=None,
        enhancer=None,
        crop_padding_percent: float = 20.0,
        min_crop_size: int = 64,
        confidence_threshold: float = 0.3,
        time_of_day_penalty: float = 0.5,
        classify_classes: Optional[Dict[int, str]] = None,
        crop_batch_size_hw: int = 336,
        enhancement_cache_size: int = 100,
        device_crops: bool = False,
        use_fused_raw: bool = True,
    ):
        # device_crops: sample crops ON DEVICE from an already-uploaded frame
        # (ops/crops.py) instead of host crop+resize+re-upload, for when the
        # full-resolution frame is device-resident (transfer="device");
        # incompatible with host-side enhancement.
        self.species_classifier = species_classifier
        self.enhancer = enhancer
        self.crop_padding_percent = crop_padding_percent
        self.min_crop_size = min_crop_size
        self.confidence_threshold = confidence_threshold
        self.time_of_day_penalty = time_of_day_penalty
        self.classify_classes = (dict(classify_classes)
                                 if classify_classes is not None
                                 else dict(CLASS_ID_TO_CATEGORY))
        self.crop_hw = crop_batch_size_hw
        self.device_crops = device_crops
        # use_fused_raw=False: this camera's Stage-2 settings diverge from
        # the globals baked into the fused device classifier (per-camera
        # stage2_preprocessing overrides), so device results are discarded
        # and crops classify host-side with the camera's own settings
        self.use_fused_raw = use_fused_raw
        self.cache = EnhancementCache(enhancement_cache_size)

        self.total_detections = 0
        self.total_classified = 0
        self.total_skipped_small = 0
        self._stage2_times: List[float] = []
        self._lock = threading.Lock()

    def add_species_classifier(self, classifier) -> None:
        self.species_classifier = classifier

    # -- crop extraction -------------------------------------------------------
    def extract_crop(self, frame: np.ndarray,
                     bbox: Dict[str, float]) -> Optional[np.ndarray]:
        """Padded crop (reference two_stage_pipeline_yolox.py:261-289):
        expand the box by crop_padding_percent, clamp to frame."""
        h, w = frame.shape[:2]
        x1, y1, x2, y2 = validate_bbox_coords(
            bbox["x1"], bbox["y1"], bbox["x2"], bbox["y2"])
        pad = self.crop_padding_percent / 100.0
        bw, bh = x2 - x1, y2 - y1
        x1 = int(max(0, x1 - bw * pad / 2))
        y1 = int(max(0, y1 - bh * pad / 2))
        x2 = int(min(w, x2 + bw * pad / 2))
        y2 = int(min(h, y2 + bh * pad / 2))
        if x2 <= x1 or y2 <= y1:
            return None
        return frame[y1:y2, x1:x2]

    def _enhance(self, crop: np.ndarray) -> np.ndarray:
        if self.enhancer is None:
            return crop
        key = EnhancementCache.crop_key(crop)
        cached = self.cache.get(key)
        # no shape comparison: enhancement may upscale (Real-ESRGAN 4x), so
        # the cached output legitimately differs in shape from the input
        if cached is not None:
            return cached
        enhanced = self.enhancer.enhance(crop)
        self.cache.put(key, enhanced)
        return enhanced

    def _resize_host(self, crops: List[np.ndarray]) -> np.ndarray:
        """Crops of any size -> (N, crop_hw, crop_hw, 3) uint8, with cv2."""
        try:
            import cv2
        except ImportError as e:
            raise RuntimeError(
                "host crops need cv2; use device_crops=True with the frame "
                "on the device") from e
        size = self.crop_hw
        return np.stack([cv2.resize(c, (size, size)) for c in crops])

    # -- main entry -------------------------------------------------------------
    def _eligible_indices(self, frame: np.ndarray,
                          detections: List[Dict[str, Any]]) -> List[int]:
        out = []
        h, w = frame.shape[:2]
        for idx, det in enumerate(detections):
            if det.get("class_id") not in self.classify_classes:
                continue
            bbox = det["bbox"]
            if min(bbox["x2"] - bbox["x1"], bbox["y2"] - bbox["y1"]) \
                    < self.min_crop_size:
                with self._lock:
                    self.total_skipped_small += 1
                continue
            out.append(idx)
        return out

    def process_detections(
        self, frame: np.ndarray, detections: List[Dict[str, Any]],
        frame_dev=None,
    ) -> List[Dict[str, Any]]:
        """Annotate eligible detections with species info. Batched: all
        eligible crops classify in one device dispatch. With device_crops and
        a device-resident frame, crops never touch the host."""
        if self.species_classifier is None or not detections:
            return detections
        t0 = time.perf_counter()
        with self._lock:
            self.total_detections += len(detections)

        # species_raw is fused-Stage-2 transport, not output — pop it from
        # EVERY detection up front so the wire format stays reference-shaped
        # on every branch (including cameras that ignore fused results)
        raws = [d.pop("species_raw", None) for d in detections]
        if (self.use_fused_raw and self.enhancer is None
                and any(r is not None for r in raws)):
            # fused Stage-2 transport: the classifier forward already ran
            # INSIDE the detector dispatch; here we only apply host
            # eligibility rules + taxonomy formatting + re-ranking. (The
            # port's DetectorProgram does not produce species_raw yet.)
            eligible = []
            results = []
            leftovers = []
            for idx, det in enumerate(detections):
                if det.get("class_id") not in self.classify_classes:
                    continue
                if raws[idx] is None:
                    # eligible here but not classified on device (beyond
                    # the fused max_crops window, or outside the device's
                    # global eligibility mask): classify host-side below
                    leftovers.append(idx)
                    continue
                bb = det["bbox"]
                if min(bb["x2"] - bb["x1"], bb["y2"] - bb["y1"]) \
                        < self.min_crop_size:
                    with self._lock:
                        self.total_skipped_small += 1
                    continue
                eligible.append((idx, None))
                results.append(
                    self.species_classifier.format_topk(
                        raws[idx][1], raws[idx][0]))
            if leftovers:
                crops, kept = [], []
                for idx in leftovers:
                    crop = self.extract_crop(frame, detections[idx]["bbox"])
                    if crop is None or min(crop.shape[:2]) < self.min_crop_size:
                        with self._lock:
                            self.total_skipped_small += 1
                        continue
                    kept.append(idx)
                    crops.append(crop)
                if kept:
                    results += self.species_classifier.classify_batch_uniform(
                        self._resize_host(crops), top_k=5)
                    eligible += [(i, None) for i in kept]
            if not eligible:
                return detections
        elif self.device_crops and self.enhancer is None:
            indices = self._eligible_indices(frame, detections)
            if not indices:
                return detections
            if frame_dev is None:
                frame_dev = torch.from_numpy(np.ascontiguousarray(frame)).to(
                    self.species_classifier.device)
            k = crop_bucket(len(indices))
            indices = indices[:k]
            boxes = boxes_with_padding(
                frame.shape[:2], [detections[i]["bbox"] for i in indices],
                [0] * len(indices), self.crop_padding_percent, k)
            results = self.species_classifier.classify_boxes_device(
                frame_dev[None] if frame_dev.ndim == 3 else frame_dev,
                boxes, n_valid=len(indices), top_k=5)
            eligible = [(i, None) for i in indices]
        else:
            eligible = []
            for idx, det in enumerate(detections):
                if det.get("class_id") not in self.classify_classes:
                    continue
                crop = self.extract_crop(frame, det["bbox"])
                if crop is None or min(crop.shape[:2]) < self.min_crop_size:
                    with self._lock:
                        self.total_skipped_small += 1
                    continue
                crop = self._enhance(crop)
                eligible.append((idx, crop))

            if not eligible:
                return detections

            # uniform square resize host-side (cheap), batch on device
            results = self.species_classifier.classify_batch_uniform(
                self._resize_host([c for _, c in eligible]), top_k=5)

        for (idx, _), preds in zip(eligible, results):
            det = detections[idx]
            preds = self._rerank_time_of_day(det, preds)
            preds = [p for p in preds
                     if p["taxonomic_level"] not in VAGUE_LEVELS]
            if not preds or preds[0]["confidence"] < self.confidence_threshold:
                continue
            best = preds[0]
            det["species"] = best["species_name"]
            det["species_confidence"] = best["confidence"]
            det["taxonomic_level"] = best["taxonomic_level"]
            det["species_top_k"] = preds
            with self._lock:
                self.total_classified += 1

        with self._lock:
            self._stage2_times.append((time.perf_counter() - t0) * 1000.0)
            if len(self._stage2_times) > 200:
                self._stage2_times = self._stage2_times[-200:]
        return detections

    def _rerank_time_of_day(
        self, det: Dict[str, Any], preds: List[Dict[str, Any]]
    ) -> List[Dict[str, Any]]:
        """Penalize species unlikely to be active now, then re-sort
        (reference two_stage_pipeline_yolox.py:388-414)."""
        tod = det.get("time_of_day")
        if not tod or not preds:
            return preds
        out = []
        for p in preds:
            p = dict(p)
            if not is_species_likely_active(p["species_name"], tod):
                p["confidence"] *= self.time_of_day_penalty
                p["time_of_day_penalized"] = True
            out.append(p)
        out.sort(key=lambda p: p["confidence"], reverse=True)
        return out

    def get_stats(self) -> Dict[str, Any]:
        with self._lock:
            times = list(self._stage2_times)
            return {
                "total_detections": self.total_detections,
                "total_classified": self.total_classified,
                "total_skipped_small": self.total_skipped_small,
                "avg_stage2_ms": float(np.mean(times)) if times else 0.0,
                "enhancement_cache": self.cache.stats(),
                "classifier": (self.species_classifier.get_stats()
                               if self.species_classifier else None),
            }
