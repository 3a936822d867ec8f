"""NMS suppression kernel K1: CUDA C++ for Hopper, bound with ctypes.

Counterpart of ``telescope_cam_detection_tpu/ops/pallas_nms.py``. The
kernel source is ``csrc/nms_suppress.cu`` (its header note gives the design
and the bound). ``ops/cuda_build.py`` compiles it with ``nvcc`` for
``sm_90a`` at first use and loads it with ``ctypes``. Importing this module
needs no ``nvcc`` and no card.

``suppress`` takes the kernel for CUDA tensors and the plain PyTorch version
(``ops/nms.py _greedy_suppress``) for CPU tensors; there is no fallback from
one to the other. ``LAUNCHES`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from telescope_cam_detection_tpu_torch.ops.cuda_build import CudaLibrary
from telescope_cam_detection_tpu_torch.ops.nms import _greedy_suppress, iou_matrix

_SMEM_LIMIT = 48 * 1024        # default dynamic shared memory of one block

# Launches of the kernel (one per ``suppress`` call on CUDA tensors).
LAUNCHES = 0


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.nms_suppress_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int


# -fmad=false: keep masks are bit-equal to the plain version (see the source)
LIBRARY = CudaLibrary("nms_suppress.cu", ("-fmad=false",), _declare)


def suppress_reference(boxes: torch.Tensor, valid: torch.Tensor,
                       iou_threshold: float = 0.45) -> torch.Tensor:
    """The kernel's plain PyTorch version, on any device."""
    return _greedy_suppress(iou_matrix(boxes, boxes), valid, iou_threshold)


def suppress(boxes: torch.Tensor, valid: torch.Tensor,
             iou_threshold: float = 0.45) -> torch.Tensor:
    """Greedy keep mask per image -> (B, K) bool.

    boxes (B, K, 4) fp32 xyxy, score-descending, class offsets applied;
    valid (B, K) bool. CPU tensors take the plain version; CUDA tensors
    launch the kernel on the current stream, or raise."""
    if boxes.dim() != 3 or boxes.shape[-1] != 4 or \
            tuple(valid.shape) != tuple(boxes.shape[:2]):
        raise ValueError(f"expected boxes (B, K, 4) and valid (B, K), got "
                         f"{tuple(boxes.shape)} and {tuple(valid.shape)}")
    if boxes.device.type == "cpu" and valid.device.type == "cpu":
        return suppress_reference(boxes, valid, iou_threshold)
    if boxes.device.type != "cuda" or valid.device != boxes.device:
        raise ValueError(f"suppress needs both tensors on one CUDA device or "
                         f"on the CPU, got {boxes.device} and {valid.device}")
    if boxes.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError(f"expected float32 boxes and bool valid, got "
                        f"{boxes.dtype} and {valid.dtype}")
    if not (boxes.is_contiguous() and valid.is_contiguous()):
        raise ValueError("suppress needs contiguous boxes and valid")
    if boxes.data_ptr() % 16:
        raise ValueError("boxes must be 16-byte aligned (read as float4)")
    b, k = valid.shape
    if b == 0 or k == 0:
        return torch.zeros((b, k), dtype=torch.bool, device=boxes.device)
    words = (k + 63) // 64
    if words * 8 + k > _SMEM_LIMIT:
        raise ValueError(f"K={k} exceeds the scan kernel's shared memory")
    keep = torch.empty((b, k), dtype=torch.bool, device=boxes.device)
    mask = torch.empty((b, k, words), dtype=torch.int64, device=boxes.device)
    fn = LIBRARY.load().nms_suppress_launch
    with torch.cuda.device(boxes.device):
        stream = torch.cuda.current_stream(boxes.device).cuda_stream
        err = fn(boxes.data_ptr(), valid.data_ptr(), b, k,
                 float(iou_threshold), mask.data_ptr(), keep.data_ptr(),
                 stream)
    if err != 0:
        raise RuntimeError(f"nms_suppress launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return keep
