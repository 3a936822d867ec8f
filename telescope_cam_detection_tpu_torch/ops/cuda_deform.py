"""Multi-scale deformable sampling kernel K3: CUDA C++ for Hopper, ctypes.

Counterpart of ``telescope_cam_detection_tpu/ops/pallas_deform.py``
(``ms_deformable_attention_pallas``). The kernel source is
``csrc/deform.cu`` (its header note gives the design and the bound).
``ops/cuda_build.py`` compiles it with ``nvcc`` for ``sm_90a`` at first use
and loads it with ``ctypes``. Importing this module needs no ``nvcc`` and no
card.

``deform_sample`` takes the kernel for CUDA tensors and the plain PyTorch
version (``ops/deform.py ms_deformable_attention_reference``) for CPU
tensors; there is no fallback from one to the other. ``LAUNCHES`` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from telescope_cam_detection_tpu_torch.ops.cuda_build import CudaLibrary
from telescope_cam_detection_tpu_torch.ops.deform import (
    check_deform_inputs,
    ms_deformable_attention_reference,
    split_levels,
)

# RT-DETR's decoder: the only shape the kernel takes (kLevels, kPoints and
# kHeadDim in csrc/deform.cu)
LEVELS, POINTS, HEAD_DIM = 3, 4, 32

# Launches of the kernel (one per ``deform_sample`` call on CUDA tensors).
LAUNCHES = 0


def _declare(lib: ctypes.CDLL) -> None:
    fn = lib.deform_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int


# -fmad=false: corner indices round as the plain version's (see the source)
LIBRARY = CudaLibrary("deform.cu", ("-fmad=false",), _declare)


def deform_sample(values: torch.Tensor, level_hw: Sequence[Tuple[int, int]],
                  locs: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of every level, border-clamped, weighted and summed
    -> (B, Q, heads, hd) fp32.

    values (B, S, heads, hd): the levels of ``level_hw`` concatenated in
    order, each row-major; locs (B, Q, heads, L, P, 2) normalised xy;
    weights (B, Q, heads, L, P) softmaxed. CPU tensors take the plain
    version (any L, P, hd); CUDA tensors launch the kernel on the current
    stream (L = 3, P = 4, hd = 32 only), or raise."""
    check_deform_inputs(values, level_hw, locs, weights)
    devices = {values.device, locs.device, weights.device}
    if devices == {torch.device("cpu")}:
        return ms_deformable_attention_reference(
            split_levels(values, level_hw), locs, weights)
    if len(devices) != 1 or values.device.type != "cuda":
        raise ValueError(f"deform_sample needs values, locs, weights on one "
                         f"CUDA device or on the CPU, got {values.device}, "
                         f"{locs.device}, {weights.device}")
    if any(x.dtype != torch.float32 for x in (values, locs, weights)):
        raise TypeError(f"expected float32 values, locs, weights, got "
                        f"{values.dtype}, {locs.dtype}, {weights.dtype}")
    if not (values.is_contiguous() and locs.is_contiguous()
            and weights.is_contiguous()):
        raise ValueError("deform_sample needs contiguous values, locs, weights")
    if locs.data_ptr() % 8:
        raise ValueError("locs must be 8-byte aligned (read as float2)")
    b, s, heads, hd = values.shape
    q, n_levels, points = locs.shape[1], locs.shape[3], locs.shape[4]
    if (n_levels, points, hd) != (LEVELS, POINTS, HEAD_DIM):
        raise ValueError(f"the kernel takes {LEVELS} levels, {POINTS} points "
                         f"and head dim {HEAD_DIM} (RT-DETR's decoder), got "
                         f"{n_levels}, {points}, {hd}")
    out = torch.empty((b, q, heads, hd), dtype=torch.float32,
                      device=values.device)
    if out.numel() == 0:
        return out
    triples, start = [], 0
    for h, w in level_hw:
        triples += [h, w, start]
        start += h * w
    fn = LIBRARY.load().deform_launch
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        err = fn(values.data_ptr(), (ctypes.c_int * len(triples))(*triples),
                 locs.data_ptr(), weights.data_ptr(), out.data_ptr(),
                 b, s, q, heads, stream)
    if err != 0:
        raise RuntimeError(f"deform launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out
