"""RT-DETRv2 detector family in PyTorch (serving path).

Counterpart of ``telescope_cam_detection_tpu/models/rtdetr.py``: ResNet-vd
backbone -> HybridEncoder (AIFI transformer on the /32 level with 2D sincos
positions built for the input's shape, CCFF cross-scale CSP fusion) ->
deformable-attention decoder (encoder top-k query selection, iterative box
refinement) -> NMS-free top-k rows (``predict``).

Input is NHWC float RGB in 0..1, as the JAX model takes; convolutions run
NCHW inside (cuDNN), the transformer parts on (B, tokens, 256). Module and
parameter names follow the Flax tree (``backbone.stage1_block0.down.conv``
for ``params/backbone/stage1_block0/down/conv/kernel``), so
``models/convert.py rtdetr_state_dict_from_flax`` only renames leaves and
transposes kernels.

The decoder's deformable sampling goes through
``ops/cuda_deform.deform_sample``: the hand-written CUDA kernel K3 for a
CUDA tensor, its plain version for a CPU tensor. The value projection runs
once per decoder layer over the encoder memory, all levels concatenated,
which is the (B, S, heads, hd) layout the kernel reads. The two
self-attentions (AIFI, decoder) are plain softmax attention, as the JAX
package leaves them to ``jax.nn.dot_product_attention``.

Training constructs (``return_aux``, denoising queries ``dn``, ``remat``)
are not ported and raise.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from telescope_cam_detection_tpu_torch.models.common import ConvBnAct
from telescope_cam_detection_tpu_torch.ops.cuda_deform import deform_sample
from telescope_cam_detection_tpu_torch.ops.nms import _stable_topk

# name -> (depth tuple per stage, decoder_layers)
RTDETR_VARIANTS: Dict[str, Tuple[Tuple[int, ...], int]] = {
    "rtdetrv2-r18vd": ((2, 2, 2, 2), 3),
    "rtdetrv2-r34vd": ((3, 4, 6, 3), 4),
    "rtdetrv2-r50vd": ((3, 4, 6, 3), 6),
}

HIDDEN = 256
NUM_QUERIES = 300
N_HEADS = 8
N_POINTS = 4
N_LEVELS = 3

_LN_EPS = 1e-6  # the Flax LayerNorm default (torch's is 1e-5)
_STAGE_CHANNELS = (64, 128, 256, 512)


def _layer_norm(dim: int = HIDDEN) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=_LN_EPS)


def _nchw_tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, C, H, W) -> (B, H*W, C), row-major positions."""
    return x.flatten(2).transpose(1, 2)


# ---------------------------------------------------------------------------
# ResNet-vd backbone
# ---------------------------------------------------------------------------

class _VdBlock(nn.Module):
    def shortcut(self, x: torch.Tensor) -> torch.Tensor:
        if not hasattr(self, "down"):
            return x
        if self.stride != 1:        # vd: avg-pool before the 1x1 conv
            x = F.avg_pool2d(x, 2, 2)
        return self.down(x)


class BasicBlockVd(_VdBlock):
    expansion = 1

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        self.conv1 = ConvBnAct(in_ch, features, 3, stride, act="relu")
        self.conv2 = ConvBnAct(features, features, 3, 1, act="identity")
        if stride != 1 or in_ch != features:
            self.down = ConvBnAct(in_ch, features, 1, 1, act="identity")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv2(self.conv1(x)) + self.shortcut(x))


class BottleneckVd(_VdBlock):
    expansion = 4

    def __init__(self, in_ch: int, features: int, stride: int = 1):
        super().__init__()
        self.stride = stride
        out = features * 4
        self.conv1 = ConvBnAct(in_ch, features, 1, 1, act="relu")
        self.conv2 = ConvBnAct(features, features, 3, stride, act="relu")
        self.conv3 = ConvBnAct(features, out, 1, 1, act="identity")
        if stride != 1 or in_ch != out:
            self.down = ConvBnAct(in_ch, out, 1, 1, act="identity")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.relu(self.conv3(self.conv2(self.conv1(x))) + self.shortcut(x))


class ResNetVd(nn.Module):
    def __init__(self, depths: Sequence[int] = (2, 2, 2, 2),
                 bottleneck: bool = False):
        super().__init__()
        self.stem1 = ConvBnAct(3, 32, 3, 2, act="relu")
        self.stem2 = ConvBnAct(32, 32, 3, 1, act="relu")
        self.stem3 = ConvBnAct(32, 64, 3, 1, act="relu")
        block = BottleneckVd if bottleneck else BasicBlockVd
        self.stages: List[List[str]] = []
        in_ch = 64
        for stage, (depth, ch) in enumerate(zip(depths, _STAGE_CHANNELS)):
            names = []
            for i in range(depth):
                stride = 2 if (i == 0 and stage > 0) else 1
                name = f"stage{stage}_block{i}"
                self.add_module(name, block(in_ch, ch, stride))
                in_ch = ch * block.expansion
                names.append(name)
            self.stages.append(names)
        self.out_channels = tuple(c * block.expansion
                                  for c in _STAGE_CHANNELS[1:])

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """(B, 3, H, W) -> S3 (/8), S4 (/16), S5 (/32), NCHW."""
        x = self.stem3(self.stem2(self.stem1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)     # pads with -inf, as Flax
        feats = []
        for stage, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if stage >= 1:
                feats.append(x)
        return feats


# ---------------------------------------------------------------------------
# Hybrid encoder
# ---------------------------------------------------------------------------

def sincos_pos_embed_2d(h: int, w: int, dim: int,
                        temperature: float = 10000.0) -> np.ndarray:
    """(h*w, dim) 2D sine-cosine embedding for any feature shape: channels
    are [sin(x), cos(x), sin(y), cos(y)] quarters, positions row-major."""
    if dim % 4:
        raise ValueError(f"dim {dim} is not a multiple of 4")
    quarter = dim // 4
    omega = 1.0 / (temperature ** (np.arange(quarter) / quarter))
    ys, xs = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out_x = np.outer(xs.reshape(-1), omega)
    out_y = np.outer(ys.reshape(-1), omega)
    return np.concatenate([np.sin(out_x), np.cos(out_x),
                           np.sin(out_y), np.cos(out_y)], axis=1).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _pos_embed(h: int, w: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(sincos_pos_embed_2d(h, w, HIDDEN))[None].to(device)


def softmax_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      heads: int) -> torch.Tensor:
    """``jax.nn.dot_product_attention`` over (B, T, heads*hd) projections,
    no mask: softmax(q k^T / sqrt(hd)) v -> (B, T, heads*hd)."""
    b, t, dim = q.shape
    hd = dim // heads

    def split(x):
        return x.reshape(b, -1, heads, hd).transpose(1, 2)

    scores = torch.matmul(split(q), split(k).transpose(-1, -2)) / math.sqrt(hd)
    out = torch.matmul(torch.softmax(scores, dim=-1), split(v))
    return out.transpose(1, 2).reshape(b, t, dim)


class TransformerEncoderLayer(nn.Module):
    """AIFI: one post-norm transformer layer over the /32 level's tokens."""

    def __init__(self, dim: int = HIDDEN, heads: int = N_HEADS,
                 ffn: int = 1024):
        super().__init__()
        self.heads = heads
        self.q = nn.Linear(dim, dim)
        self.k = nn.Linear(dim, dim)
        self.v = nn.Linear(dim, dim)
        self.proj = nn.Linear(dim, dim)
        self.norm1 = _layer_norm(dim)
        self.ffn1 = nn.Linear(dim, ffn)
        self.ffn2 = nn.Linear(ffn, dim)
        self.norm2 = _layer_norm(dim)

    def forward(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        qk = x + pos
        attn = softmax_attention(self.q(qk), self.k(qk), self.v(x), self.heads)
        x = self.norm1(x + self.proj(attn))
        # Flax nn.gelu is the tanh approximation
        y = self.ffn2(F.gelu(self.ffn1(x), approximate="tanh"))
        return self.norm2(x + y)


class RepBlock(nn.Module):
    """RepVGG-style block at inference: silu(conv3x3 + conv1x1)."""

    def __init__(self, features: int):
        super().__init__()
        self.conv3 = ConvBnAct(features, features, 3, 1, act="identity")
        self.conv1 = ConvBnAct(features, features, 1, 1, act="identity")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.silu(self.conv3(x) + self.conv1(x))


class CSPRepLayer(nn.Module):
    def __init__(self, in_ch: int, features: int, n: int = 3):
        super().__init__()
        self.n = n
        self.conv1 = ConvBnAct(in_ch, features, 1, 1, act="silu")
        self.conv2 = ConvBnAct(in_ch, features, 1, 1, act="silu")
        for i in range(n):
            self.add_module(f"rep{i}", RepBlock(features))
        self.conv3 = ConvBnAct(features, features, 1, 1, act="silu")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = self.conv1(x)
        for i in range(self.n):
            a = getattr(self, f"rep{i}")(a)
        return self.conv3(a + self.conv2(x))


def _up2(x: torch.Tensor) -> torch.Tensor:
    """Nearest x2 repeat of an NCHW tensor."""
    n, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(n, c, h, 2, w, 2) \
        .reshape(n, c, h * 2, w * 2)


class HybridEncoder(nn.Module):
    def __init__(self, in_channels: Sequence[int]):
        super().__init__()
        for i, ch in enumerate(in_channels):
            self.add_module(f"input_proj{i}",
                            ConvBnAct(ch, HIDDEN, 1, 1, act="identity"))
        self.aifi = TransformerEncoderLayer()
        self.lateral1 = ConvBnAct(HIDDEN, HIDDEN, 1, 1, act="silu")
        self.fpn_block1 = CSPRepLayer(2 * HIDDEN, HIDDEN)
        self.lateral2 = ConvBnAct(HIDDEN, HIDDEN, 1, 1, act="silu")
        self.fpn_block2 = CSPRepLayer(2 * HIDDEN, HIDDEN)
        self.down1 = ConvBnAct(HIDDEN, HIDDEN, 3, 2, act="silu")
        self.pan_block1 = CSPRepLayer(2 * HIDDEN, HIDDEN)
        self.down2 = ConvBnAct(HIDDEN, HIDDEN, 3, 2, act="silu")
        self.pan_block2 = CSPRepLayer(2 * HIDDEN, HIDDEN)

    def forward(self, feats: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        s3, s4, s5 = (getattr(self, f"input_proj{i}")(f)
                      for i, f in enumerate(feats))
        b, _, h5, w5 = s5.shape
        tokens = self.aifi(_nchw_tokens(s5), _pos_embed(h5, w5, s5.device))
        s5 = tokens.transpose(1, 2).reshape(b, HIDDEN, h5, w5)

        lat5 = self.lateral1(s5)
        p4 = self.fpn_block1(torch.cat([_up2(lat5), s4], 1))
        lat4 = self.lateral2(p4)
        p3 = self.fpn_block2(torch.cat([_up2(lat4), s3], 1))
        n4 = self.pan_block1(torch.cat([self.down1(p3), lat4], 1))
        n5 = self.pan_block2(torch.cat([self.down2(n4), lat5], 1))
        return [p3, n4, n5]


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

class DeformSampling(nn.Module):
    """Kernel K3 as a module without parameters, so that forward hooks see
    its inputs and mark its span (``chip_smoke.py`` times it apart from the
    rest of the decoder and takes its inputs from the shipped model)."""

    def forward(self, values: torch.Tensor,
                level_hw: Sequence[Tuple[int, int]], locs: torch.Tensor,
                weights: torch.Tensor) -> torch.Tensor:
        return deform_sample(values, level_hw, locs, weights)


class MSDeformAttn(nn.Module):
    """Multi-scale deformable cross-attention; sampling is kernel K3."""

    def __init__(self, dim: int = HIDDEN, heads: int = N_HEADS,
                 points: int = N_POINTS, levels: int = N_LEVELS):
        super().__init__()
        self.dim, self.heads, self.points, self.levels = dim, heads, points, levels
        # Flax DenseGeneral to (heads, hd), flattened
        self.value_proj = nn.Linear(dim, dim)
        self.sampling_offsets = nn.Linear(dim, heads * levels * points * 2)
        self.attention_weights = nn.Linear(dim, heads * levels * points)
        self.sampling = DeformSampling()
        self.output_proj = nn.Linear(dim, dim)

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                memory: torch.Tensor,
                level_hw: Sequence[Tuple[int, int]]) -> torch.Tensor:
        """query (B, Q, C); reference_points (B, Q, 4) normalised cxcywh;
        memory (B, S, C): the encoder levels of ``level_hw``, concatenated."""
        b, q, _ = query.shape
        hd = self.dim // self.heads
        values = self.value_proj(memory).reshape(b, -1, self.heads, hd)
        off = self.sampling_offsets(query).reshape(
            b, q, self.heads, self.levels, self.points, 2)
        w = torch.softmax(self.attention_weights(query).reshape(
            b, q, self.heads, self.levels * self.points), dim=-1).reshape(
            b, q, self.heads, self.levels, self.points)
        center = reference_points[:, :, None, None, None, :2]
        wh = reference_points[:, :, None, None, None, 2:]
        locs = center + off / self.points * wh * 0.5
        out = self.sampling(values, level_hw, locs, w)
        return self.output_proj(out.reshape(query.shape))


class DecoderLayer(nn.Module):
    def __init__(self, dim: int = HIDDEN, heads: int = N_HEADS,
                 ffn: int = 1024):
        super().__init__()
        self.heads = heads
        self.sa_q = nn.Linear(dim, dim)
        self.sa_k = nn.Linear(dim, dim)
        self.sa_v = nn.Linear(dim, dim)
        self.sa_proj = nn.Linear(dim, dim)
        self.norm1 = _layer_norm(dim)
        self.cross_attn = MSDeformAttn(dim, heads)
        self.norm2 = _layer_norm(dim)
        self.ffn1 = nn.Linear(dim, ffn)
        self.ffn2 = nn.Linear(ffn, dim)
        self.norm3 = _layer_norm(dim)

    def forward(self, query, query_pos, reference_points, memory, level_hw):
        qk = query + query_pos
        sa = softmax_attention(self.sa_q(qk), self.sa_k(qk), self.sa_v(query),
                               self.heads)
        query = self.norm1(query + self.sa_proj(sa))
        ca = self.cross_attn(query + query_pos, reference_points, memory,
                             level_hw)
        query = self.norm2(query + ca)
        y = self.ffn2(F.relu(self.ffn1(query)))
        return self.norm3(query + y)


class MLP(nn.Module):
    def __init__(self, in_dim: int, hidden: int, out: int, layers: int = 3):
        super().__init__()
        self.layers = layers
        dims = [in_dim] + [hidden] * (layers - 1) + [out]
        for i in range(layers):
            self.add_module(f"l{i}", nn.Linear(dims[i], dims[i + 1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.layers - 1):
            x = F.relu(getattr(self, f"l{i}")(x))
        return getattr(self, f"l{self.layers - 1}")(x)


def _inverse_sigmoid(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x = torch.clamp(x, eps, 1 - eps)
    return torch.log(x / (1 - x))


@functools.lru_cache(maxsize=32)
def _anchors(level_hw: Tuple[Tuple[int, int], ...],
             device: torch.device) -> torch.Tensor:
    """(1, S, 4) cxcywh anchors of the encoder's query selection: pixel
    centres, width and height 0.05 * 2**level."""
    out = []
    for lvl, (h, w) in enumerate(level_hw):
        gy = (torch.arange(h, dtype=torch.float32)[:, None].expand(h, w)
              + 0.5) / h
        gx = (torch.arange(w, dtype=torch.float32)[None, :].expand(h, w)
              + 0.5) / w
        wh = torch.full((h, w, 2), 0.05 * (2.0 ** lvl))
        out.append(torch.cat([gx[..., None], gy[..., None], wh], -1)
                   .reshape(h * w, 4))
    return torch.cat(out, 0)[None].to(device)


class RTDETR(nn.Module):
    def __init__(self, num_classes: int = 80,
                 depths: Sequence[int] = (2, 2, 2, 2),
                 bottleneck: bool = False, decoder_layers: int = 3,
                 num_queries: int = NUM_QUERIES):
        super().__init__()
        self.num_classes = num_classes
        self.num_queries = num_queries
        self.decoder_layers = decoder_layers
        self.backbone = ResNetVd(depths, bottleneck)
        self.encoder = HybridEncoder(self.backbone.out_channels)
        self.enc_output = nn.Linear(HIDDEN, HIDDEN)
        self.enc_norm = _layer_norm()
        self.enc_score_head = nn.Linear(HIDDEN, num_classes)
        self.enc_bbox_head = MLP(HIDDEN, HIDDEN, 4)
        self.query_pos_head = MLP(4, HIDDEN * 2, HIDDEN, layers=2)
        for i in range(decoder_layers):
            self.add_module(f"decoder{i}", DecoderLayer())
            self.add_module(f"bbox_head{i}", MLP(HIDDEN, HIDDEN, 4))
        self.class_head = nn.Linear(HIDDEN, num_classes)

    def decoders(self) -> List[Tuple[DecoderLayer, MLP]]:
        return [(getattr(self, f"decoder{i}"), getattr(self, f"bbox_head{i}"))
                for i in range(self.decoder_layers)]

    def features(self, images: torch.Tensor) -> List[torch.Tensor]:
        """(B, H, W, 3) RGB 0..1 -> the encoder's three NCHW levels."""
        h_in, w_in = images.shape[1:3]
        if h_in % 32 or w_in % 32:
            # the vd shortcut (avg-pool) and the stride-2 conv disagree on
            # odd feature sizes
            raise ValueError(
                f"RT-DETR input {h_in}x{w_in} must be divisible by 32 "
                f"(configure detection.input_size accordingly)")
        return self.encoder(self.backbone(images.permute(0, 3, 1, 2)))

    def select_queries(self, levels: Sequence[torch.Tensor]):
        """Encoder-side query selection: top ``num_queries`` tokens by their
        max class logit (a stable descending sort, as ``jnp.argsort`` of the
        negated logits). -> (memory (B, S, C), level_hw, query (B, Q, C),
        reference boxes (B, Q, 4) cxcywh)."""
        level_hw = tuple((f.shape[2], f.shape[3]) for f in levels)
        memory = torch.cat([_nchw_tokens(f) for f in levels], 1)
        enc_out = self.enc_norm(self.enc_output(memory))
        enc_logits = self.enc_score_head(enc_out)
        anchors = _anchors(level_hw, memory.device)
        enc_boxes = torch.sigmoid(self.enc_bbox_head(enc_out)
                                  + _inverse_sigmoid(anchors))
        _, order = torch.sort(-enc_logits.amax(-1), dim=1, stable=True)
        topk = order[:, :self.num_queries, None]
        boxes = torch.gather(enc_boxes, 1, topk.expand(-1, -1, 4))
        query = torch.gather(enc_out, 1, topk.expand(-1, -1, HIDDEN))
        return memory, level_hw, query, boxes

    def forward(self, images: torch.Tensor, return_aux: bool = False,
                dn=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """images (B, H, W, 3) float RGB 0..1 -> (logits (B, Q, classes),
        boxes cxcywh normalised (B, Q, 4))."""
        if return_aux or dn is not None:
            raise ValueError("return_aux and dn (training) are not yet ported")
        return self.decode(*self.select_queries(self.features(images)))

    def decode(self, memory: torch.Tensor,
               level_hw: Sequence[Tuple[int, int]], query: torch.Tensor,
               boxes: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """The decoder layers with iterative box refinement, from the
        selected queries -> (logits, boxes)."""
        for layer, bbox_head in self.decoders():
            query_pos = self.query_pos_head(boxes)
            query = layer(query, query_pos, boxes, memory, level_hw)
            boxes = torch.sigmoid(bbox_head(query) + _inverse_sigmoid(boxes))
        return self.class_head(query), boxes

    def predict(self, images: torch.Tensor) -> torch.Tensor:
        """NMS-free rows: top-Q of the flattened sigmoid scores (JAX tie
        order) -> (B, Q, 7) [x1, y1, x2, y2, obj=1, score, class] in
        model-input pixels."""
        logits, boxes = self(images)
        b, q, c = logits.shape
        h, w = images.shape[1:3]
        top_scores, top_idx = _stable_topk(
            torch.sigmoid(logits).reshape(b, q * c), q)
        sel = torch.gather(boxes, 1, (top_idx // c)[..., None].expand(-1, -1, 4))
        cx, cy, bw, bh = (sel[..., 0] * w, sel[..., 1] * h,
                          sel[..., 2] * w, sel[..., 3] * h)
        return torch.stack([
            cx - bw / 2, cy - bh / 2, cx + bw / 2, cy + bh / 2,
            torch.ones_like(top_scores), top_scores,
            (top_idx % c).to(top_scores.dtype)], dim=-1)


def build_rtdetr(name: str = "rtdetrv2-r18vd", num_classes: int = 80,
                 remat: bool = False) -> RTDETR:
    if name not in RTDETR_VARIANTS:
        raise ValueError(f"unknown RT-DETR variant {name!r}; valid: "
                         f"{sorted(RTDETR_VARIANTS)}")
    if remat:
        raise ValueError("remat (training) is not yet ported")
    depths, dec_layers = RTDETR_VARIANTS[name]
    return RTDETR(num_classes=num_classes, depths=depths,
                  bottleneck=name.endswith(("r50vd", "r101vd")),
                  decoder_layers=dec_layers)


def init_rtdetr(name: str = "rtdetrv2-r18vd", num_classes: int = 80,
                seed: int = 0) -> RTDETR:
    """A model with random weights drawn from ``seed`` (torch's generator:
    not the numbers the JAX package draws from the same seed)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build_rtdetr(name, num_classes)
