"""Multi-head attention over (B, T, H, D) q/k/v: the plain PyTorch version.

Counterpart of ``telescope_cam_detection_tpu/ops/pallas_attention.py``
(``_attn_kernel``): ``softmax(q k^T / sqrt(D)) v`` with no mask over real
tokens. ``attention_reference`` repeats that kernel's arithmetic step by
step; the CUDA kernel (``ops/cuda_attention.py``) is held against it, and
the CPU tests hold it against the JAX package.
"""
from __future__ import annotations

import math

import torch

SUPPORTED_DTYPES = (torch.float32, torch.bfloat16)


def check_qkv(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    """Raise on what neither the kernel nor its plain version takes."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"expected q, k, v of one shape (B, T, H, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if q.dtype not in SUPPORTED_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"expected q, k, v all float32 or all bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    d = q.shape[-1]
    if d % 16 or not 16 <= d <= 128:
        raise ValueError(f"head dim {d} is not a multiple of 16 in 16..128")


def attention_reference(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """(B, T, H, D) q/k/v -> (B, T, H, D), on any device.

    The order of the TPU kernel: scores = q k^T accumulated in fp32, then
    times the scale; row max; ``p = exp(scores - max)``; the denominator sums
    the fp32 ``p``; ``p`` is cast to ``v``'s dtype before ``p v``, which
    accumulates in fp32; divide; cast to the input dtype."""
    check_qkv(q, k, v)
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d)
    # (B, H, T, D); the float() of bf16 values is exact, so the fp32 product
    # below is the input-dtype product with fp32 accumulation
    qh, kh, vh = (x.permute(0, 2, 1, 3).float() for x in (q, k, v))
    scores = torch.matmul(qh, kh.transpose(-1, -2)) * scale
    m = scores.amax(dim=-1, keepdim=True)
    p = torch.exp(scores - m)
    denom = p.sum(dim=-1, keepdim=True)
    out = torch.matmul(p.to(v.dtype).float(), vh) / denom
    return out.to(q.dtype).permute(0, 2, 1, 3).contiguous()
