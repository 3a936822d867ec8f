"""Device selection for the port's entry points.

The port serves fp32 and its reference is fp32 (the JAX resize pins
``Precision.HIGHEST``), so selecting a CUDA device also turns TF32 off for
both cuDNN convolutions and cuBLAS matmuls: TF32 keeps about three decimal
digits, which moves box coordinates past the IoU >= 0.99 parity gate.
"""
from __future__ import annotations

from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """Return ``torch.device(device)``; raise if it is CUDA and CUDA is
    missing. Nothing falls back to the CPU silently: the caller asks for it
    with ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the port's "
                "plain PyTorch path on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
