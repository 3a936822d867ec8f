"""The per-batch detector program and its host-facing wrapper.

Counterpart of ``telescope_cam_detection_tpu/runtime/program.py``, plain
single-device branch:

    uint8 frames -> bilinear resize -> YOLOX forward -> head decode
    -> batched class-aware NMS (CUDA kernel K1) -> scale back to capture
    coordinates -> per-class confidence/size/wildlife filter
    -> (B, max_det, 7) rows, one readback.

With ``detector_type="rtdetr"`` the detector is RT-DETRv2, which is NMS-free:
resize, BGR->RGB, 0..1 -> RT-DETR forward (deformable sampling in CUDA
kernel K3) -> top-k rows, truncated or padded with -1 rows to ``max_det``
-> the same scale back, filter and compaction.

PyTorch runs eagerly, so a "program" here is the function that closes over
one capture resolution; ``stats["compilations"]`` counts how many were
built. Thresholds are runtime tensors on the device, so ``update_filters``
swaps tensors and builds nothing.

Not yet ported, and refused at construction with ``ValueError``:
``transfer="delta"``, ``gates="device"``, a ``mesh``;
``attach_classifier`` raises the same way.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from telescope_cam_detection_tpu_torch.coco_constants import (
    COCO_CLASSES,
    NUM_COCO_CLASSES,
    WILDLIFE_CLASSES,
    class_name,
)
from telescope_cam_detection_tpu_torch.device import resolve_device
from telescope_cam_detection_tpu_torch.models.convert import load_strict
from telescope_cam_detection_tpu_torch.models.rtdetr import build_rtdetr
from telescope_cam_detection_tpu_torch.models.yolox import build_yolox, decode_outputs
from telescope_cam_detection_tpu_torch.ops.nms import _stable_topk, batched_nms
from telescope_cam_detection_tpu_torch.ops.preprocess import (
    preprocess_rtdetr,
    preprocess_yolox,
    yuv420_to_bgr,
)
from telescope_cam_detection_tpu_torch.utils import native

logger = logging.getLogger(__name__)

_TRANSFERS = ("auto", "device", "host", "yuv420")


@dataclasses.dataclass(frozen=True)
class ProgramSpec:
    """Static configuration of one detector program."""
    detector_type: str = "yolox"          # or "rtdetr"
    variant: str = "yolox-s"
    num_classes: int = NUM_COCO_CLASSES
    input_hw: Tuple[int, int] = (640, 640)
    nms_threshold: float = 0.45
    max_det: int = 300
    pre_nms_topk: int = 1000
    # Transfer policy. "auto": resize on the host (cv2, else the native
    # library) when the capture resolution exceeds the model input, so
    # fewer bytes cross to the device; "host": always resize on the host;
    # "device": ship capture frames and resize on the device; "yuv420":
    # host resize, then pack to planar 4:2:0 with the native library (half
    # the bytes, slight chroma loss). "delta" is not yet ported.
    transfer: str = "auto"
    # Compact the readback to the top-K valid rows (None: all max_det).
    readback_topk: Optional[int] = None
    gates: str = "none"                   # "device" is not yet ported


@dataclasses.dataclass
class FilterSettings:
    """Hot-reloadable stage-1 filter settings -> device tensors: base conf
    threshold, per-class overrides, min/max box area, per-class size
    limits, wildlife-only mask."""
    conf_threshold: float = 0.25
    class_confidence_overrides: Dict[str, float] = dataclasses.field(default_factory=dict)
    min_box_area: float = 0.0
    max_box_area: float = float("inf")
    wildlife_only: bool = True
    class_size_limits: Dict[str, Tuple[float, float]] = dataclasses.field(default_factory=dict)

    def to_arrays(self, num_classes: int,
                  device: Union[str, torch.device] = "cpu"
                  ) -> Dict[str, torch.Tensor]:
        conf = np.full((num_classes,), self.conf_threshold, np.float32)
        for name, thr in (self.class_confidence_overrides or {}).items():
            try:
                conf[COCO_CLASSES.index(name)] = thr
            except ValueError:
                logger.warning("unknown class in confidence overrides: %s", name)
        min_area = np.full((num_classes,), max(self.min_box_area, 0.0), np.float32)
        max_area = np.full((num_classes,),
                           self.max_box_area if np.isfinite(self.max_box_area) else 1e18,
                           np.float32)
        for name, (lo, hi) in (self.class_size_limits or {}).items():
            try:
                idx = COCO_CLASSES.index(name)
                min_area[idx] = max(lo, min_area[idx])
                max_area[idx] = min(hi, max_area[idx])
            except ValueError:
                logger.warning("unknown class in size limits: %s", name)
        allowed = np.ones((num_classes,), bool)
        if self.wildlife_only and num_classes == NUM_COCO_CLASSES:
            allowed[:] = False
            for cid in WILDLIFE_CLASSES:
                allowed[cid] = True
        arrays = {"class_conf": conf, "min_area": min_area,
                  "max_area": max_area, "class_allowed": allowed}
        return {k: torch.from_numpy(v).to(device) for k, v in arrays.items()}


def _filter_rows(rows: torch.Tensor, filt: Mapping[str, torch.Tensor]
                 ) -> torch.Tensor:
    """(B, D, 7) NMS rows -> same shape with failing rows invalidated (-1)."""
    cls = torch.clamp(rows[..., 6].to(torch.int32), 0,
                      filt["class_conf"].shape[0] - 1).long()
    score = rows[..., 4] * rows[..., 5]
    valid = rows[..., 5] >= 0.0
    valid &= score >= filt["class_conf"][cls]
    area = torch.clamp(rows[..., 2] - rows[..., 0], min=0) * \
        torch.clamp(rows[..., 3] - rows[..., 1], min=0)
    valid &= (area >= filt["min_area"][cls]) & (area <= filt["max_area"][cls])
    valid &= filt["class_allowed"][cls]
    return torch.where(valid[..., None], rows, torch.full_like(rows, -1.0))


def _compact_rows(rows: torch.Tensor, k: int) -> torch.Tensor:
    """(B, D, 7) -> (B, k, 7): keep the k best rows, valid-first then by
    score (invalid rows are all -1, so obj*cls would be +1 — mask them)."""
    valid = rows[..., 5] >= 0.0
    score = torch.where(valid, rows[..., 4] * rows[..., 5],
                        torch.full_like(rows[..., 4], -1.0))
    _, order = _stable_topk(score, k)
    return torch.gather(rows, 1, order[..., None].expand(-1, -1, 7))


class DetectorDispatchTail:
    """Blocking-call surface over the ``dispatch_batch``/``materialize``
    pair plus a ``stats`` dict and ``_warmup_hw()`` hook."""

    def detect_batch_rows(self, frames: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) uint8 BGR -> (B, max_det, 7) numpy rows in capture
        coords; invalid rows are all -1."""
        t0 = time.perf_counter()
        rows, _ = self.materialize(self.dispatch_batch(frames), len(frames))
        self.stats["last_infer_ms"] = (time.perf_counter() - t0) * 1000.0
        return rows

    def detect_batch(self, frames: np.ndarray) -> List[List[Dict[str, Any]]]:
        """Detection-dict output, one list per frame."""
        rows = self.detect_batch_rows(frames)
        return [rows_to_detections(r) for r in rows]

    def detect(self, frame: np.ndarray) -> List[Dict[str, Any]]:
        return self.detect_batch(frame[None])[0]

    def warmup(self, batches: Sequence[int] = (1,),
               capture_hw: Optional[Tuple[int, int]] = None) -> None:
        hw = capture_hw or self._warmup_hw()
        for b in batches:
            self.detect_batch_rows(np.zeros((b, *hw, 3), np.uint8))

    def get_stats(self) -> Dict[str, Any]:
        return dict(self.stats)


class DetectorProgram(DetectorDispatchTail):
    """Host-facing detector (YOLOX or RT-DETR) on one device: owns the model
    and a cache of per-capture_hw programs."""

    def __init__(
        self,
        spec: ProgramSpec,
        state_dict: Optional[Mapping[str, torch.Tensor]] = None,
        seed: int = 0,
        device: Union[str, torch.device] = "cuda",
        mesh: Any = None,
    ):
        """state_dict: fp32 weights (``models/convert.yolox_state_dict_from_flax``
        or ``rtdetr_state_dict_from_flax``); None builds a random-init model
        from ``seed``. device: "cuda" (default) or "cpu"."""
        if mesh is not None:
            raise ValueError("mesh: multi-device serving is not yet ported")
        constructors = {"yolox": build_yolox, "rtdetr": build_rtdetr}
        if spec.detector_type not in constructors:
            raise ValueError(f"unknown detector_type {spec.detector_type!r}")
        if spec.transfer == "delta":
            raise ValueError("transfer='delta' is not yet ported")
        if spec.transfer not in _TRANSFERS:
            raise ValueError(f"unknown transfer mode {spec.transfer!r}")
        if spec.gates == "device":
            raise ValueError("gates='device' is not yet ported")
        if spec.gates != "none":
            raise ValueError(f"unknown gates mode {spec.gates!r} "
                             "(valid: none, device)")
        self.device = resolve_device(device)
        self.spec = spec
        build = constructors[spec.detector_type]
        if state_dict is None:
            logger.warning("DetectorProgram: random-init weights (no checkpoint)")
            with torch.random.fork_rng(devices=[]):
                torch.manual_seed(seed)
                model = build(spec.variant, spec.num_classes)
        else:
            model = build(spec.variant, spec.num_classes)
            load_strict(model, state_dict)
        self.model = model.to(self.device).eval().requires_grad_(False)
        self._filters = FilterSettings()
        self._filter_arrays = self._filters.to_arrays(spec.num_classes,
                                                      self.device)
        self._programs: Dict[Tuple, Callable] = {}
        self.stats: Dict[str, Any] = {"compilations": 0, "batches": 0,
                                      "frames": 0, "last_infer_ms": 0.0}

    def attach_classifier(self, *args, **kwargs) -> None:
        raise ValueError("attach_classifier: fused Stage-2 is not yet ported")

    # -- hot reload ---------------------------------------------------------
    def update_filters(self, settings: FilterSettings) -> None:
        """Swap the filter tensors; no program is rebuilt."""
        self._filters = settings
        self._filter_arrays = settings.to_arrays(self.spec.num_classes,
                                                 self.device)

    @property
    def filters(self) -> FilterSettings:
        return self._filters

    # -- transfer policy -------------------------------------------------------
    def _host_resize_active(self, capture_hw: Tuple[int, int]) -> bool:
        if self.spec.transfer == "device":
            return False
        if self.spec.transfer in ("host", "yuv420"):
            return capture_hw != self.spec.input_hw
        # auto: only when it shrinks the transfer
        return (capture_hw[0] * capture_hw[1] >
                self.spec.input_hw[0] * self.spec.input_hw[1])

    def _resize_host(self, frames: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) -> (B, *input_hw, 3) on the host: cv2 where it
        imports (its SIMD resize is the faster), else the port's native
        library (``utils/native.py``), as the reference does. Records the
        route and its ms in ``stats``."""
        ih, iw = self.spec.input_hw
        t0 = time.perf_counter()
        try:
            import cv2
        except ImportError:
            try:
                frames = native.resize_batch(frames, (ih, iw))
            except RuntimeError as e:
                raise RuntimeError("host-resize needs cv2 or the native "
                                   f"frameio library: {e}") from e
            route = "native"
        else:
            frames = np.stack([cv2.resize(f, (iw, ih),
                                          interpolation=cv2.INTER_LINEAR)
                               for f in frames])
            route = "cv2"
        self.stats["host_resize"] = route
        self.stats["host_resize_ms"] = (time.perf_counter() - t0) * 1e3
        return frames

    # -- program construction -------------------------------------------------
    def _detect_core(self, capture_hw: Tuple[int, int]) -> Callable:
        """(frames uint8 on the device, filter tensors) -> (B, D, 7) rows in
        capture coords, filtered and compacted."""
        spec = self.spec
        model = self.model
        sy = capture_hw[0] / spec.input_hw[0]
        sx = capture_hw[1] / spec.input_hw[1]
        back_scale = torch.tensor([sx, sy, sx, sy], dtype=torch.float32,
                                  device=self.device)

        @torch.inference_mode()
        def core(frames_u8: torch.Tensor,
                 filt: Mapping[str, torch.Tensor]) -> torch.Tensor:
            if spec.transfer == "yuv420":
                frames_u8 = yuv420_to_bgr(frames_u8).to(torch.uint8)
            if spec.detector_type == "yolox":
                x = preprocess_yolox(frames_u8, spec.input_hw)
                boxes, obj, cls_probs = decode_outputs(model(x))
                rows = batched_nms(
                    boxes, obj, cls_probs,
                    conf_threshold=0.0,  # confidence via runtime tensors below
                    iou_threshold=spec.nms_threshold,
                    max_det=spec.max_det,
                    pre_nms_topk=spec.pre_nms_topk,
                )
            else:
                # RT-DETR is NMS-free: predict's top-k gives (B, Q, 7) rows
                rows = model.predict(preprocess_rtdetr(frames_u8, spec.input_hw))
                rows = rows[:, :spec.max_det]
                if rows.shape[1] < spec.max_det:
                    rows = torch.cat([rows, rows.new_full(
                        (rows.shape[0], spec.max_det - rows.shape[1], 7),
                        -1.0)], dim=1)
            # scale boxes back to capture coords, then filter
            rows[..., :4] *= back_scale
            rows = _filter_rows(rows, filt)
            if spec.readback_topk and spec.readback_topk < spec.max_det:
                rows = _compact_rows(rows, spec.readback_topk)
            return rows

        return core

    def _get_program(self, capture_hw: Tuple[int, int]) -> Callable:
        fn = self._programs.get(capture_hw)
        if fn is None:
            fn = self._detect_core(capture_hw)
            self._programs[capture_hw] = fn
            self.stats["compilations"] += 1
            logger.info("built detector program capture=%s input=%s",
                        capture_hw, self.spec.input_hw)
        return fn

    def dispatch_batch(self, frames: np.ndarray,
                       capture_hw: Optional[Tuple[int, int]] = None
                       ) -> torch.Tensor:
        """Transfer one batch and enqueue its program; return the rows
        tensor on the device without reading it back.

        capture_hw: when the frames were already resized to input_hw,
        the ORIGINAL capture (H, W), so boxes come back in capture
        coordinates."""
        if isinstance(frames, (list, tuple)):
            frames = np.stack(frames)
        if frames.ndim != 4 or frames.shape[-1] != 3:
            raise ValueError(f"expected (B,H,W,3) uint8 frames, got {frames.shape}")
        frame_hw = (frames.shape[1], frames.shape[2])
        if capture_hw is not None and frame_hw != tuple(self.spec.input_hw):
            raise ValueError("capture_hw is only valid for frames already "
                             f"resized to input_hw={self.spec.input_hw}")
        batch = frames.shape[0]
        capture_hw = tuple(capture_hw) if capture_hw is not None else frame_hw
        if self._host_resize_active(frame_hw):
            frames = self._resize_host(frames)
        if self.spec.transfer == "yuv420":
            frames = np.stack([native.bgr_to_yuv420(f) for f in frames])
        fn = self._get_program(capture_hw)
        x = torch.from_numpy(np.ascontiguousarray(frames)).to(self.device)
        rows = fn(x, self._filter_arrays)
        self.stats["batches"] += 1
        self.stats["frames"] += batch
        return rows

    def warm(self, batch: int, capture_hw: Tuple[int, int]) -> None:
        """Run the program for (batch, capture_hw) once on blank frames, so
        serving does not pay the first call's cuDNN algorithm selection."""
        frames = np.zeros((batch, *capture_hw, 3), np.uint8)
        self.materialize(self.dispatch_batch(frames), batch)

    def materialize(self, handle: torch.Tensor, n: int
                    ) -> Tuple[np.ndarray, None]:
        """Read a ``dispatch_batch`` handle back to host memory in one
        transfer: (rows (n, D, 7) numpy, None)."""
        return handle[:n].cpu().numpy(), None

    def _warmup_hw(self) -> Tuple[int, int]:
        return self.spec.input_hw


def rows_to_detections(rows: np.ndarray) -> List[Dict[str, Any]]:
    """(max_det, 7) rows -> list of detection dicts:
    {class_id, class_name, confidence, objectness, class_confidence,
    bbox{x1,y1,x2,y2,width,height,area}}."""
    dets: List[Dict[str, Any]] = []
    for row in rows:
        if row[5] < 0:  # invalid marker
            continue
        x1, y1, x2, y2, obj_c, cls_c, cid = (float(v) for v in row)
        class_id = int(cid)
        w, h = x2 - x1, y2 - y1
        dets.append({
            "class_id": class_id,
            "class_name": class_name(class_id),
            "confidence": obj_c * cls_c,
            "objectness": obj_c,
            "class_confidence": cls_c,
            "bbox": {"x1": x1, "y1": y1, "x2": x2, "y2": y2,
                     "width": w, "height": h, "area": w * h},
        })
    return dets
