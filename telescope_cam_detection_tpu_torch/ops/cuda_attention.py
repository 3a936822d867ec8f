"""Fused attention kernel K2: CUDA C++ for Hopper, bound with ctypes.

Counterpart of ``telescope_cam_detection_tpu/ops/pallas_attention.py``
(``flash_attention``). The kernel source is ``csrc/attention.cu`` (its
header note gives the design and the bound). ``ops/cuda_build.py`` compiles
it with ``nvcc`` for ``sm_90a`` at first use and loads it with ``ctypes``.
Importing this module needs no ``nvcc`` and no card.

``attention`` takes the kernel for CUDA tensors and the plain PyTorch version
(``ops/attention.py attention_reference``) for CPU tensors; there is no
fallback from one to the other. ``LAUNCHES`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from telescope_cam_detection_tpu_torch.ops.attention import (
    attention_reference,
    check_qkv,
)
from telescope_cam_detection_tpu_torch.ops.cuda_build import CudaLibrary

_MAX_GRID_Y = 65535

# Launches of the kernel (one per ``attention`` call on CUDA tensors).
LAUNCHES = 0


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.attention_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int


LIBRARY = CudaLibrary("attention.cu", (), _declare)


def attention(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> torch.Tensor:
    """``softmax(q k^T / sqrt(D)) v`` over (B, T, H, D) -> (B, T, H, D).

    fp32 or bf16, D a multiple of 16 up to 128. CPU tensors take the plain
    version; CUDA tensors launch the kernel on the current stream, or
    raise."""
    check_qkv(q, k, v)
    devices = {q.device, k.device, v.device}
    if devices == {torch.device("cpu")}:
        return attention_reference(q, k, v)
    if len(devices) != 1 or q.device.type != "cuda":
        raise ValueError(f"attention needs q, k, v on one CUDA device or on "
                         f"the CPU, got {q.device}, {k.device}, {v.device}")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("attention needs contiguous (B, T, H, D) q, k, v")
    if any(x.data_ptr() % 16 for x in (q, k, v)):
        raise ValueError("q, k, v must be 16-byte aligned (vector loads)")
    b, t, h, d = q.shape
    if b * h > _MAX_GRID_Y:
        raise ValueError(f"B * H = {b * h} exceeds the grid's {_MAX_GRID_Y}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    fn = LIBRARY.load().attention_launch
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, t, h, d, 1.0 / math.sqrt(d),
                 int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"attention launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out
