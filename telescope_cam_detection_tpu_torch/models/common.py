"""Shared PyTorch building blocks of the detector families (YOLOX, RT-DETR).

Counterpart of ``telescope_cam_detection_tpu/models/common.py``. The class
names are the JAX package's; the attribute names are Megvii's
(``conv``/``bn``, ``dconv``/``pconv``, ``conv1``/``conv2``/``m``), so a state
dict from ``models/convert.py`` loads strictly. Tensors are NCHW inside the
model, where cuDNN runs the convolutions. BatchNorm runs on its running
statistics (the model is served in ``eval()`` mode). The int8
``QuantConv2D`` is not ported yet.
"""
from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn


# The JAX package's ``ACTIVATIONS`` that the port's models use
ACTIVATIONS = {"silu": nn.SiLU, "relu": nn.ReLU, "identity": nn.Identity}


class ConvBnAct(nn.Module):
    """Conv2D + BatchNorm(eps 1e-3) + activation, the basic detector block
    (SiLU for YOLOX; ReLU and identity for ResNet-vd and the RT-DETR
    encoder)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1, groups: int = 1, act: str = "silu"):
        super().__init__()
        self.conv = nn.Conv2d(in_ch, out_ch, kernel, stride, (kernel - 1) // 2,
                              groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(out_ch, eps=1e-3)
        self.act = ACTIVATIONS[act]()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(self.conv(x)))


class DWConvBlock(nn.Module):
    """Depthwise-separable conv (YOLOX-nano uses these)."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3,
                 stride: int = 1):
        super().__init__()
        self.dconv = ConvBnAct(in_ch, in_ch, kernel, stride, groups=in_ch)
        self.pconv = ConvBnAct(in_ch, out_ch, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.pconv(self.dconv(x))


def conv_block(depthwise: bool):
    return DWConvBlock if depthwise else ConvBnAct


class Bottleneck(nn.Module):
    """1x1 -> 3x3 with optional residual."""

    def __init__(self, in_ch: int, out_ch: int, shortcut: bool = True,
                 expansion: float = 0.5, depthwise: bool = False):
        super().__init__()
        hidden = int(out_ch * expansion)
        self.conv1 = ConvBnAct(in_ch, hidden, 1, 1)
        self.conv2 = conv_block(depthwise)(hidden, out_ch, 3, 1)
        self.use_add = shortcut and in_ch == out_ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv2(self.conv1(x))
        return y + x if self.use_add else y


class CSPLayer(nn.Module):
    """Cross-stage-partial layer: split -> n bottlenecks -> concat -> fuse."""

    def __init__(self, in_ch: int, out_ch: int, n: int = 1,
                 shortcut: bool = True, expansion: float = 0.5,
                 depthwise: bool = False):
        super().__init__()
        hidden = int(out_ch * expansion)
        self.conv1 = ConvBnAct(in_ch, hidden, 1, 1)
        self.conv2 = ConvBnAct(in_ch, hidden, 1, 1)
        self.m = nn.Sequential(*[
            Bottleneck(hidden, hidden, shortcut, 1.0, depthwise)
            for _ in range(n)])
        self.conv3 = ConvBnAct(2 * hidden, out_ch, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.m(self.conv1(x))
        return self.conv3(torch.cat([a, self.conv2(x)], dim=1))


class Focus(nn.Module):
    """Space-to-depth stem: (C,H,W) -> (4C,H/2,W/2) -> conv. The patch
    order [tl, bl, tr, br] is the JAX package's."""

    def __init__(self, in_ch: int, out_ch: int, kernel: int = 3):
        super().__init__()
        self.conv = ConvBnAct(in_ch * 4, out_ch, kernel, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tl = x[..., 0::2, 0::2]
        bl = x[..., 1::2, 0::2]
        tr = x[..., 0::2, 1::2]
        br = x[..., 1::2, 1::2]
        return self.conv(torch.cat([tl, bl, tr, br], dim=1))


class SPPBottleneck(nn.Module):
    """Spatial pyramid pooling with parallel max-pools (padding acts as
    -inf, as ``flax.linen.max_pool`` pads)."""

    def __init__(self, in_ch: int, out_ch: int,
                 kernel_sizes: Sequence[int] = (5, 9, 13)):
        super().__init__()
        hidden = in_ch // 2
        self.conv1 = ConvBnAct(in_ch, hidden, 1, 1)
        self.pools = nn.ModuleList(
            [nn.MaxPool2d(k, 1, k // 2) for k in kernel_sizes])
        self.conv2 = ConvBnAct(hidden * (len(kernel_sizes) + 1), out_ch, 1, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        return self.conv2(torch.cat([x] + [p(x) for p in self.pools], dim=1))


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an NCHW tensor (PAFPN top-down)."""
    n, c, h, w = x.shape
    x = x[:, :, :, None, :, None].expand(n, c, h, 2, w, 2)
    return x.reshape(n, c, h * 2, w * 2)
