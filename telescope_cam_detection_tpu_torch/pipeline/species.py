"""Stage-2 species classifier: EVA02 on the device + taxonomy/geographic logic.

Counterpart of ``telescope_cam_detection_tpu/pipeline/species.py``. The
device side runs, per crop-batch bucket: preprocess (resize/BGR->RGB/
normalize) -> EVA02 forward (attention in the CUDA kernel K2) -> softmax ->
top-k, with one readback. The taxonomy hierarchy fallback, geographic
whitelist, and label logic are host Python (hierarchy thresholds species
0.5 / genus 0.4 / family 0.3 / order 0.3 / class 0.2).

Crops classify as a single padded batch, bounding Stage-2 latency when many
detections fire. The port serves fp32; bf16 and int8 are not yet ported.
"""
from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from telescope_cam_detection_tpu_torch.device import resolve_device
from telescope_cam_detection_tpu_torch.models.convert import load_strict
from telescope_cam_detection_tpu_torch.models.eva02 import build_eva02, init_eva02
from telescope_cam_detection_tpu_torch.ops.crops import sample_crops
from telescope_cam_detection_tpu_torch.ops.nms import _stable_topk
from telescope_cam_detection_tpu_torch.ops.preprocess import (
    normalize_rgb,
    preprocess_classifier,
)

logger = logging.getLogger(__name__)

HIERARCHY_THRESHOLDS = {
    "species": 0.5,
    "genus": 0.4,
    "family": 0.3,
    "order": 0.3,
    "class": 0.2,
}

CROP_BATCH_BUCKETS = (1, 2, 4, 8, 16)


def crop_bucket(n: int) -> int:
    """The smallest bucket that holds n crops, else the largest bucket."""
    for b in CROP_BATCH_BUCKETS:
        if n <= b:
            return b
    return CROP_BATCH_BUCKETS[-1]


def load_taxonomy(taxonomy_file: str) -> Dict[str, Any]:
    """Load class_id -> taxonomy mapping from JSON (dict entries with
    common_name/name/genus/family/order/class) or plain text (one name per
    line)."""
    path = Path(taxonomy_file)
    if not path.exists():
        logger.warning("taxonomy file not found: %s", taxonomy_file)
        return {}
    try:
        if path.suffix == ".json":
            with open(path) as f:
                data = json.load(f)
            if isinstance(data, list):
                return {str(i): entry for i, entry in enumerate(data)}
            return {str(k): v for k, v in data.items()}
        with open(path) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        return {str(i): name for i, name in enumerate(lines)}
    except (json.JSONDecodeError, OSError):
        logger.exception("failed to load taxonomy %s", taxonomy_file)
        return {}


class SpeciesClassifier:
    def __init__(
        self,
        model_name: str = "eva02-large",
        num_classes: int = 10000,
        input_size: int = 336,
        taxonomy_file: Optional[str] = None,
        confidence_threshold: float = 0.3,
        use_hierarchical: bool = True,
        enable_geographic_filter: bool = False,
        allowed_species: Optional[Sequence[str]] = None,
        state_dict: Optional[Mapping[str, torch.Tensor]] = None,
        seed: int = 0,
        quant: str = "none",
        device: Union[str, torch.device] = "cuda",
    ):
        """state_dict: fp32 weights named as ``models/eva02.EVA02`` names
        them (``models/convert.eva02_state_dict_from_flax``); None builds a
        random-init model from ``seed``. device: "cuda" (default) or "cpu"."""
        self.device = resolve_device(device)
        self.model_name = model_name
        self.num_classes = num_classes
        self.input_size = input_size
        self.confidence_threshold = confidence_threshold
        self.use_hierarchical = use_hierarchical
        self.hierarchy_thresholds = dict(HIERARCHY_THRESHOLDS)
        self.enable_geographic_filter = enable_geographic_filter
        self.allowed_species = set(allowed_species or [])
        self.taxonomy: Dict[str, Any] = (
            load_taxonomy(taxonomy_file) if taxonomy_file else {})

        if state_dict is None:
            logger.warning("SpeciesClassifier: random-init weights "
                           "(no checkpoint)")
            model = init_eva02(model_name, num_classes, input_size, seed,
                               quant=quant)
        else:
            model = build_eva02(model_name, num_classes, input_size,
                                quant=quant)
            load_strict(model, state_dict)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self.total_classified = 0
        self.total_batches = 0
        self._classify_times: List[float] = []

    # -- device programs ------------------------------------------------------
    def _top_k(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Normalized crops -> (top_p, top_i) of the softmax, on the device.
        A custom fine-tuned head may have fewer classes than the top-k
        window. The stable sort orders ties as ``jax.lax.top_k`` does."""
        logits = self.model(x)
        probs = torch.softmax(logits.float(), dim=-1)
        return _stable_topk(probs, min(10, self.num_classes))

    @torch.inference_mode()
    def _program(self, crops_u8: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        size = self.input_size
        return self._top_k(preprocess_classifier(crops_u8, (size, size)))

    @torch.inference_mode()
    def _device_crop_program(self, frames: torch.Tensor, boxes: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
        """ROI-sample K crops from on-device frames -> normalize -> EVA02 ->
        top-k. Avoids re-shipping crops to the device (the frames already
        went up for detection)."""
        size = self.input_size
        crops = sample_crops(frames, boxes, (size, size))       # BGR float
        return self._top_k(normalize_rgb(crops.flip(-1) * (1.0 / 255.0)))

    def _read_back(self, top_p: torch.Tensor, top_i: torch.Tensor, n: int,
                   top_k: int) -> List[List[Dict[str, Any]]]:
        """One readback of the first n rows of (top_p, top_i), packed into
        one fp32 tensor (class ids are exact in fp32), then formatted."""
        packed = torch.cat([top_p[:n, :top_k],
                            top_i[:n, :top_k].to(top_p.dtype)], dim=-1)
        packed = packed.cpu().numpy()
        k = packed.shape[1] // 2
        return [self._format_predictions(row[:k], row[k:].astype(np.int64))
                for row in packed]

    def _note_batch(self, n: int, t0: float) -> None:
        self.total_batches += 1
        self.total_classified += n
        self._classify_times.append((time.perf_counter() - t0) * 1000.0)
        if len(self._classify_times) > 200:
            self._classify_times = self._classify_times[-200:]

    def classify_batch_uniform(
        self, crops: np.ndarray, top_k: int = 5
    ) -> List[List[Dict[str, Any]]]:
        """(N, H, W, 3) uint8 BGR crops (same size) -> per-crop top-k lists."""
        n = crops.shape[0]
        padded = crop_bucket(n)
        results: List[List[Dict[str, Any]]] = []
        t0 = time.perf_counter()
        for start in range(0, n, padded):
            chunk = crops[start:start + padded]
            buf = np.zeros((padded, *crops.shape[1:]), np.uint8)
            buf[:chunk.shape[0]] = chunk
            top_p, top_i = self._program(torch.from_numpy(buf).to(self.device))
            results += self._read_back(top_p, top_i, chunk.shape[0], top_k)
        self._note_batch(n, t0)
        return results

    def classify(self, crop: np.ndarray, top_k: int = 5) -> List[Dict[str, Any]]:
        """Single-crop convenience."""
        return self.classify_batch_uniform(crop[None], top_k)[0]

    def classify_boxes_device(
        self, frames_dev: torch.Tensor, boxes: np.ndarray, n_valid: int,
        top_k: int = 5
    ) -> List[List[Dict[str, Any]]]:
        """frames_dev: (B, H, W, 3) uint8 tensor on this classifier's device;
        boxes: (K, 5) [batch_idx, x1, y1, x2, y2] with padding rows
        batch_idx < 0. Returns top-k prediction lists for the first n_valid
        boxes, after one readback of (top_p, top_i)."""
        t0 = time.perf_counter()
        if frames_dev.device.type != self.device.type:
            raise ValueError(f"frames on {frames_dev.device}, classifier on "
                             f"{self.device}")
        boxes_dev = torch.from_numpy(np.asarray(boxes, np.float32)
                                     ).to(frames_dev.device)
        top_p, top_i = self._device_crop_program(frames_dev, boxes_dev)
        results = self._read_back(top_p, top_i, n_valid, top_k)
        self._note_batch(n_valid, t0)
        return results

    def format_topk(self, probs, ids, top_k: int = 5
                    ) -> List[Dict[str, Any]]:
        """Raw device top-k (probs, ids) -> prediction dicts with the same
        taxonomy/hierarchy/geo treatment as classify(). For the fused
        Stage-2 transport (``species_raw``), where the classifier forward
        already ran inside the detector dispatch."""
        self.total_classified += 1
        return self._format_predictions(np.asarray(probs)[:top_k],
                                        np.asarray(ids)[:top_k])

    # -- label logic ------------------------------------------------------------
    def _format_predictions(self, probs: np.ndarray,
                            ids: np.ndarray) -> List[Dict[str, Any]]:
        preds = []
        for p, cid in zip(probs, ids):
            p = float(p)
            cid = int(cid)
            label, level = self.get_hierarchical_label(cid, p)
            if label is None:
                continue
            if self.enable_geographic_filter and self.allowed_species and \
                    label not in self.allowed_species:
                continue
            preds.append({
                "species_id": cid,
                "species_name": label,
                "taxonomic_level": level,
                "confidence": p,
            })
        return preds

    def get_hierarchical_label(
        self, class_id: int, confidence: float
    ) -> Tuple[Optional[str], Optional[str]]:
        """Confidence-banded taxonomy fallback."""
        entry = self.taxonomy.get(str(class_id), {})
        if isinstance(entry, str):
            return (entry, "species")
        if not isinstance(entry, dict):
            entry = {}
        common = entry.get("common_name") or entry.get("name") or \
            f"species_{class_id}"
        if not self.use_hierarchical:
            return (common, "species")
        th = self.hierarchy_thresholds
        if confidence >= th["species"]:
            return (common, "species")
        for level in ("genus", "family", "order", "class"):
            if confidence >= th[level] and entry.get(level):
                return (entry[level], level)
        return (None, None)

    def get_stats(self) -> Dict[str, Any]:
        times = self._classify_times
        return {
            "model_name": self.model_name,
            "num_classes": self.num_classes,
            "total_classified": self.total_classified,
            "total_batches": self.total_batches,
            "avg_classify_ms": float(np.mean(times)) if times else 0.0,
            "taxonomy_entries": len(self.taxonomy),
            "geographic_filter": self.enable_geographic_filter,
        }
