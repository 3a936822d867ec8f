"""Multi-scale deformable sampling: the plain PyTorch version of kernel K3.

Counterpart of ``telescope_cam_detection_tpu/models/rtdetr.py``
(``bilinear_corner_fractions`` and ``ms_deformable_attention``), the function
that ``ops/pallas_deform.py _deform_kernel`` computes on the TPU. Each query
and head samples every level at P locations with half-pixel centres; each of
the four bilinear corners has its integer index **clamped to the border**
(``clip(., 0, h - 1)``), so a location outside [0, 1] reads the edge pixel.
That is not the zero padding of upstream MSDeformAttn or of
``grid_sample(padding_mode="zeros")``. The samples are weighted by the
softmaxed attention weights and summed over levels, then over points.

``ms_deformable_attention_reference`` keeps the JAX order of arithmetic:
per level ``(1-fy)(1-fx) g00 + (1-fy) fx g01 + fy (1-fx) g10 + fy fx g11``,
times the weight, a sum over levels, then a sum over points. The CUDA kernel
(``ops/cuda_deform.py``) is held against it.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch


def bilinear_corner_fractions(loc: torch.Tensor, h: int, w: int):
    """loc (..., 2) normalised xy -> (x0, y0, fx, fy): the floor corner (as
    floats) and the fractions towards the next pixel."""
    x = loc[..., 0] * w - 0.5
    y = loc[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    return x0, y0, x - x0, y - y0


def check_deform_inputs(values: torch.Tensor,
                        level_hw: Sequence[Tuple[int, int]],
                        locs: torch.Tensor, weights: torch.Tensor) -> None:
    """Raise on shapes that neither the kernel nor its plain version takes:
    values (B, S, heads, hd) with S the sum of the levels' h * w; locs
    (B, Q, heads, L, P, 2); weights (B, Q, heads, L, P)."""
    if values.dim() != 4 or locs.dim() != 6 or weights.dim() != 5:
        raise ValueError(f"expected values (B, S, heads, hd), locs "
                         f"(B, Q, heads, L, P, 2), weights (B, Q, heads, L, P); "
                         f"got {tuple(values.shape)}, {tuple(locs.shape)}, "
                         f"{tuple(weights.shape)}")
    b, s, heads, _ = values.shape
    if locs.shape[-1] != 2 or tuple(weights.shape) != tuple(locs.shape[:-1]) \
            or locs.shape[0] != b or locs.shape[2] != heads:
        raise ValueError(f"locs {tuple(locs.shape)} and weights "
                         f"{tuple(weights.shape)} do not match values "
                         f"{tuple(values.shape)}")
    if len(level_hw) != locs.shape[3] or \
            any(h < 1 or w < 1 for h, w in level_hw):
        raise ValueError(f"level_hw {list(level_hw)} does not give the "
                         f"{locs.shape[3]} levels of locs")
    if sum(h * w for h, w in level_hw) != s:
        raise ValueError(f"values hold {s} positions, the levels "
                         f"{list(level_hw)} {sum(h * w for h, w in level_hw)}")


def split_levels(values: torch.Tensor, level_hw: Sequence[Tuple[int, int]]
                 ) -> List[torch.Tensor]:
    """(B, S, heads, hd), levels concatenated row-major in order -> one
    (B, h, w, heads, hd) view per level."""
    b, _, heads, hd = values.shape
    out, start = [], 0
    for h, w in level_hw:
        out.append(values[:, start:start + h * w].reshape(b, h, w, heads, hd))
        start += h * w
    return out


def ms_deformable_attention_reference(values: Sequence[torch.Tensor],
                                      locs: torch.Tensor,
                                      weights: torch.Tensor) -> torch.Tensor:
    """values: per level (B, H_l, W_l, heads, hd); locs (B, Q, heads, L, P, 2)
    normalised xy; weights (B, Q, heads, L, P) softmaxed. Returns
    (B, Q, heads, hd) fp32, on any device."""
    b, q, heads, n_levels, n_points, _ = locs.shape
    out = None
    for lvl in range(n_levels):
        v = values[lvl].float()
        _, h, w, _, hd = v.shape
        x0, y0, fx, fy = bilinear_corner_fractions(locs[:, :, :, lvl].float(),
                                                   h, w)
        flat = v.reshape(b, h * w, heads, hd).permute(0, 2, 1, 3)

        def gather(yy, xx):
            idx = yy.long().clamp(0, h - 1) * w + xx.long().clamp(0, w - 1)
            idx = idx.permute(0, 2, 1, 3).reshape(b, heads, q * n_points, 1)
            g = torch.gather(flat, 2, idx.expand(-1, -1, -1, hd))
            return g.reshape(b, heads, q, n_points, hd).permute(0, 2, 1, 3, 4)

        g00 = gather(y0, x0)
        g01 = gather(y0, x0 + 1)
        g10 = gather(y0 + 1, x0)
        g11 = gather(y0 + 1, x0 + 1)
        fx = fx[..., None]
        fy = fy[..., None]
        sampled = ((1 - fy) * (1 - fx) * g00 + (1 - fy) * fx * g01
                   + fy * (1 - fx) * g10 + fy * fx * g11)
        term = sampled * weights[:, :, :, lvl].float()[..., None]
        out = term if out is None else out + term
    return out.sum(dim=3)
