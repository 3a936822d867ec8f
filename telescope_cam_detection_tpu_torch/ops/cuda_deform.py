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
from typing import Dict, Sequence, Tuple

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

# shapes that passed the kernel's shape checks -> (B, S, Q, heads, the
# levels' (h, w, start) triples for the launch); checked once per shape
_SHAPES: Dict[tuple, Tuple[int, int, int, int, ctypes.Array]] = {}


def _launch_shape(values: torch.Tensor, level_hw: Sequence[Tuple[int, int]],
                  locs: torch.Tensor, weights: torch.Tensor):
    key = (tuple(map(tuple, level_hw)), values.shape, locs.shape,
           weights.shape)
    shape = _SHAPES.get(key)
    if shape is not None:
        return shape
    check_deform_inputs(values, level_hw, locs, weights)
    b, s, heads, hd = values.shape
    q, n_levels, points = locs.shape[1], locs.shape[3], locs.shape[4]
    if (n_levels, points, hd) != (LEVELS, POINTS, HEAD_DIM):
        raise ValueError(f"the kernel takes {LEVELS} levels, {POINTS} points "
                         f"and head dim {HEAD_DIM} (RT-DETR's decoder), got "
                         f"{n_levels}, {points}, {hd}")
    if s * heads * hd >= 2 ** 31:
        raise ValueError(f"the kernel offsets an image's values in int32: "
                         f"{s} positions x {heads} heads x {hd} is too many")
    if b > 65535 or heads > 65535:
        raise ValueError(f"the kernel's grid takes at most 65535 images and "
                         f"heads, got {b} and {heads}")
    triples, start = [], 0
    for h, w in key[0]:
        triples += [h, w, start]
        start += h * w
    shape = _SHAPES[key] = (b, s, q, heads,
                            (ctypes.c_int * len(triples))(*triples))
    return shape


def deform_sample(values: torch.Tensor, level_hw: Sequence[Tuple[int, int]],
                  locs: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of every level, border-clamped, weighted and summed
    -> (B, Q, heads, hd) fp32.

    values (B, S, heads, hd): the levels of ``level_hw`` concatenated in
    order, each row-major; locs (B, Q, heads, L, P, 2) normalised xy;
    weights (B, Q, heads, L, P) softmaxed. CPU tensors take the plain
    version (any L, P, hd); CUDA tensors launch the kernel on the current
    stream (L = 3, P = 4, hd = 32 only), or raise."""
    device = values.device
    if not (values.is_cuda and locs.device == device
            and weights.device == device):
        check_deform_inputs(values, level_hw, locs, weights)
        if {device.type, locs.device.type, weights.device.type} == {"cpu"}:
            return ms_deformable_attention_reference(
                split_levels(values, level_hw), locs, weights)
        raise ValueError(f"deform_sample needs values, locs, weights on one "
                         f"CUDA device or on the CPU, got {device}, "
                         f"{locs.device}, {weights.device}")
    if not (values.dtype == locs.dtype == weights.dtype == torch.float32):
        raise TypeError(f"expected float32 values, locs, weights, got "
                        f"{values.dtype}, {locs.dtype}, {weights.dtype}")
    if not (values.is_contiguous() and locs.is_contiguous()
            and weights.is_contiguous()):
        raise ValueError("deform_sample needs contiguous values, locs, weights")
    if locs.data_ptr() % 8:
        raise ValueError("locs must be 8-byte aligned (read as float2)")
    if values.data_ptr() % 16:
        raise ValueError("values must be 16-byte aligned (read as float4)")
    b, s, q, heads, levels = _launch_shape(values, level_hw, locs, weights)
    out = torch.empty((b, q, heads, HEAD_DIM), dtype=torch.float32,
                      device=device)
    if out.numel() == 0:
        return out
    fn = LIBRARY.load().deform_launch
    args = (values.data_ptr(), levels, locs.data_ptr(), weights.data_ptr(),
            out.data_ptr(), b, s, q, heads)
    if device.index is None or device.index == torch.cuda.current_device():
        err = fn(*args, torch.cuda.current_stream().cuda_stream)
    else:
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"deform launch failed: CUDA error {err}")
    global LAUNCHES
    LAUNCHES += 1
    return out
