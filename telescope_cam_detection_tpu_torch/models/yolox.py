"""YOLOX detector family in PyTorch (CSPDarknet + PAFPN + decoupled head).

Counterpart of ``telescope_cam_detection_tpu/models/yolox.py``, started from
the torch mirror that ``tests/test_torch_parity.py`` holds against Flax. The
module tree carries Megvii state-dict names (``backbone.backbone.dark3.1``,
``head.cls_preds.0``), the target of ``models/convert.py``.

``YOLOX.forward`` takes NHWC float BGR images in 0..255, as the JAX model
does, runs NCHW inside, and returns per-level NCHW head outputs;
``decode_outputs`` flattens them in the JAX package's anchor order
(row-major h*w per level, strides 8/16/32).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn as nn

from telescope_cam_detection_tpu_torch.models.common import (
    ConvBnAct,
    CSPLayer,
    Focus,
    SPPBottleneck,
    conv_block,
    upsample2x,
)

# name -> (depth_mult, width_mult, depthwise)
YOLOX_VARIANTS: Dict[str, Tuple[float, float, bool]] = {
    "yolox-nano": (0.33, 0.25, True),
    "yolox-tiny": (0.33, 0.375, False),
    "yolox-s": (0.33, 0.50, False),
    "yolox-m": (0.67, 0.75, False),
    "yolox-l": (1.00, 1.00, False),
    "yolox-x": (1.33, 1.25, False),
}

STRIDES = (8, 16, 32)

LevelOutput = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _w(width: float, ch: int) -> int:
    return int(ch * width)


def _d(depth: float, n: int) -> int:
    return max(round(n * depth), 1)


class CSPDarknet(nn.Module):
    def __init__(self, depth: float, width: float, depthwise: bool = False):
        super().__init__()
        block = conv_block(depthwise)
        base = _w(width, 64)
        self.stem = Focus(3, base, 3)
        self.dark2 = nn.Sequential(
            block(base, base * 2, 3, 2),
            CSPLayer(base * 2, base * 2, _d(depth, 3), True,
                     depthwise=depthwise))
        self.dark3 = nn.Sequential(
            block(base * 2, base * 4, 3, 2),
            CSPLayer(base * 4, base * 4, _d(depth, 9), True,
                     depthwise=depthwise))
        self.dark4 = nn.Sequential(
            block(base * 4, base * 8, 3, 2),
            CSPLayer(base * 8, base * 8, _d(depth, 9), True,
                     depthwise=depthwise))
        self.dark5 = nn.Sequential(
            block(base * 8, base * 16, 3, 2),
            SPPBottleneck(base * 16, base * 16),
            CSPLayer(base * 16, base * 16, _d(depth, 3), False,
                     depthwise=depthwise))

    def forward(self, x: torch.Tensor):
        x = self.dark2(self.stem(x))
        c3 = self.dark3(x)
        c4 = self.dark4(c3)
        return c3, c4, self.dark5(c4)


class PAFPN(nn.Module):
    """Holds the CSPDarknet as ``backbone``; named ``backbone`` itself at
    the top level (Megvii's YOLOPAFPN convention)."""

    def __init__(self, depth: float, width: float, depthwise: bool = False):
        super().__init__()
        self.backbone = CSPDarknet(depth, width, depthwise)
        block = conv_block(depthwise)
        n = _d(depth, 3)

        def ch(c: int) -> int:
            return _w(width, c)

        def csp(cin: int, cout: int) -> CSPLayer:
            return CSPLayer(cin, cout, n, False, depthwise=depthwise)

        self.lateral_conv0 = ConvBnAct(ch(1024), ch(512), 1, 1)
        self.C3_p4 = csp(ch(1024), ch(512))
        self.reduce_conv1 = ConvBnAct(ch(512), ch(256), 1, 1)
        self.C3_p3 = csp(ch(512), ch(256))
        self.bu_conv2 = block(ch(256), ch(256), 3, 2)
        self.C3_n3 = csp(ch(512), ch(512))
        self.bu_conv1 = block(ch(512), ch(512), 3, 2)
        self.C3_n4 = csp(ch(1024), ch(1024))

    def forward(self, x: torch.Tensor):
        c3, c4, c5 = self.backbone(x)
        # top-down
        p5_lat = self.lateral_conv0(c5)
        p4_td = self.C3_p4(torch.cat([upsample2x(p5_lat), c4], dim=1))
        p4_lat = self.reduce_conv1(p4_td)
        p3_out = self.C3_p3(torch.cat([upsample2x(p4_lat), c3], dim=1))
        # bottom-up
        p4_out = self.C3_n3(torch.cat([self.bu_conv2(p3_out), p4_lat], dim=1))
        p5_out = self.C3_n4(torch.cat([self.bu_conv1(p4_out), p5_lat], dim=1))
        return p3_out, p4_out, p5_out


class YOLOXHead(nn.Module):
    """Decoupled head: shared-width stems, separate cls/reg branches."""

    def __init__(self, num_classes: int = 80, width: float = 1.0,
                 depthwise: bool = False):
        super().__init__()
        hidden = _w(width, 256)
        block = conv_block(depthwise)
        self.stems = nn.ModuleList()
        self.cls_convs = nn.ModuleList()
        self.reg_convs = nn.ModuleList()
        self.cls_preds = nn.ModuleList()
        self.reg_preds = nn.ModuleList()
        self.obj_preds = nn.ModuleList()
        for in_ch in (_w(width, 256), _w(width, 512), _w(width, 1024)):
            self.stems.append(ConvBnAct(in_ch, hidden, 1, 1))
            self.cls_convs.append(nn.Sequential(
                block(hidden, hidden, 3, 1), block(hidden, hidden, 3, 1)))
            self.reg_convs.append(nn.Sequential(
                block(hidden, hidden, 3, 1), block(hidden, hidden, 3, 1)))
            self.cls_preds.append(nn.Conv2d(hidden, num_classes, 1))
            self.reg_preds.append(nn.Conv2d(hidden, 4, 1))
            self.obj_preds.append(nn.Conv2d(hidden, 1, 1))

    def forward(self, feats) -> List[LevelOutput]:
        outputs = []
        for lvl, f in enumerate(feats):
            x = self.stems[lvl](f)
            c = self.cls_convs[lvl](x)
            r = self.reg_convs[lvl](x)
            outputs.append((self.reg_preds[lvl](r), self.obj_preds[lvl](r),
                            self.cls_preds[lvl](c)))
        return outputs


class YOLOX(nn.Module):
    def __init__(self, num_classes: int = 80, depth: float = 0.33,
                 width: float = 0.50, depthwise: bool = False):
        super().__init__()
        self.backbone = PAFPN(depth, width, depthwise)
        self.head = YOLOXHead(num_classes, width, depthwise)

    def forward(self, images: torch.Tensor) -> List[LevelOutput]:
        """images: (N, H, W, 3) float BGR 0..255 (YOLOX convention).

        Returns per-level raw head outputs (reg, obj, cls), each NCHW."""
        x = images.permute(0, 3, 1, 2).contiguous()
        return self.head(self.backbone(x))


def decode_outputs(level_outputs: Sequence[LevelOutput],
                   strides: Sequence[int] = STRIDES):
    """YOLOX anchor-free decode: xy = (pred + grid) * stride,
    wh = exp(pred) * stride; sigmoid on obj/cls. Output shapes
    (N, A, 4), (N, A), (N, A, C) with A = sum(H_l * W_l), anchors
    row-major per level."""
    boxes_all, obj_all, cls_all = [], [], []
    for (reg, obj, cls), stride in zip(level_outputs, strides):
        n, _, h, w = reg.shape
        gy, gx = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=reg.device),
            torch.arange(w, dtype=torch.float32, device=reg.device),
            indexing="ij")
        cx = (reg[:, 0] + gx) * stride
        cy = (reg[:, 1] + gy) * stride
        bw = torch.exp(reg[:, 2]) * stride
        bh = torch.exp(reg[:, 3]) * stride
        boxes = torch.stack(
            [cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2], dim=-1)
        boxes_all.append(boxes.reshape(n, h * w, 4))
        obj_all.append(torch.sigmoid(obj[:, 0]).reshape(n, h * w))
        cls_all.append(
            torch.sigmoid(cls).permute(0, 2, 3, 1).reshape(n, h * w, -1))
    return (torch.cat(boxes_all, 1).float(), torch.cat(obj_all, 1).float(),
            torch.cat(cls_all, 1).float())


def build_yolox(name: str = "yolox-s", num_classes: int = 80) -> YOLOX:
    if name not in YOLOX_VARIANTS:
        raise ValueError(f"unknown YOLOX variant {name!r}; "
                         f"valid: {sorted(YOLOX_VARIANTS)}")
    depth, width, depthwise = YOLOX_VARIANTS[name]
    return YOLOX(num_classes=num_classes, depth=depth, width=width,
                 depthwise=depthwise)
