"""NMS suppression kernel K1: CUDA C++ for Hopper, bound with ctypes.

Counterpart of ``telescope_cam_detection_tpu/ops/pallas_nms.py``. The
kernel source is ``csrc/nms_suppress.cu`` (its header note gives the design
and the bound). It is compiled with ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface at first use, under ``_build/`` beside this
package (listed in ``.gitignore``), and loaded with ``ctypes``. Importing
this module needs no ``nvcc`` and no card.

``suppress`` takes the kernel for CUDA tensors and the plain PyTorch version
(``ops/nms.py _greedy_suppress``) for CPU tensors; there is no fallback from
one to the other. ``LAUNCHES`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import torch

from telescope_cam_detection_tpu_torch.ops.nms import _greedy_suppress, iou_matrix

PACKAGE_DIR = Path(__file__).resolve().parents[1]
SOURCE = PACKAGE_DIR / "csrc" / "nms_suppress.cu"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler", "-fPIC")
_SMEM_LIMIT = 48 * 1024        # default dynamic shared memory of one block

# Launches of the kernel (one per ``suppress`` call on CUDA tensors).
LAUNCHES = 0

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
BUILD_LOG = ""                 # nvcc's output (ptxas registers/smem) of the build


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the NMS kernel is built from "
                           f"{SOURCE} on a host with the CUDA toolkit")
    return path


def build() -> Path:
    """Compile ``csrc/nms_suppress.cu`` into ``_build/`` unless a library
    built from the same source and flags is there; return its path."""
    global BUILD_LOG
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
                            ).hexdigest()[:12]
    target = BUILD_DIR / f"libnms_suppress-{digest}.so"
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(SOURCE)],
                              capture_output=True, text=True)
        BUILD_LOG = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {SOURCE}:\n{BUILD_LOG}")
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return target


def _library() -> ctypes.CDLL:
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.nms_suppress_launch
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_float, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib


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
    fn = _library().nms_suppress_launch
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
