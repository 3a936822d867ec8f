"""EVA02 vision transformer (Stage-2 species classifier backbone).

Counterpart of ``telescope_cam_detection_tpu/models/eva02.py``: patch-14 ViT
with 2D rotary position embeddings, SwiGLU MLP and sub-LayerNorm, the
architecture of ``timm/eva02_large_patch14_clip_336.merged2b_ft_inat21``
(10,000 iNat-2021 species at 336x336). Input is NHWC like the JAX model and
is permuted inside. Attention goes through ``ops/cuda_attention.attention``:
the hand-written CUDA kernel for a CUDA tensor, its plain version for a CPU
tensor; the projections around it stay ``nn.Linear``.

Module and parameter names follow the Flax tree (``block0.q_proj.weight``
for ``params/block0/q_proj/kernel``); ``models/convert.py
eva02_state_dict_from_flax`` carries the weights across.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from telescope_cam_detection_tpu_torch.ops.cuda_attention import attention

EVA02_VARIANTS = {
    # name -> (depth, dim, heads, mlp_hidden, patch)
    "eva02-tiny": (12, 192, 3, 512, 14),
    "eva02-small": (12, 384, 6, 1024, 14),
    "eva02-base": (12, 768, 12, 2048, 14),
    "eva02-large": (24, 1024, 16, 2730, 14),
}

_LN_EPS = 1e-6  # the Flax LayerNorm default (torch's is 1e-5)


def _rope_freqs(dim: int, n_side: int, theta: float = 100.0) -> np.ndarray:
    """2D axial rotary embedding tables: (n_side*n_side, dim/2) angles.

    Half the head dim rotates with the y-position of the patch, half with
    its x-position; rows scan the patch grid row-major."""
    quarter = dim // 4
    freqs = 1.0 / (theta ** (np.arange(quarter, dtype=np.float64) / quarter))
    pos = np.arange(n_side, dtype=np.float64)
    ang = np.outer(pos, freqs)                      # (n_side, quarter)
    ang_y = np.repeat(ang[:, None, :], n_side, 1)   # (y, x, quarter)
    ang_x = np.repeat(ang[None, :, :], n_side, 0)   # (y, x, quarter)
    angles = np.concatenate([ang_y, ang_x], -1)     # (y, x, dim/2)
    return angles.reshape(n_side * n_side, dim // 2).astype(np.float32)


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor,
                n_prefix: int = 1) -> torch.Tensor:
    """Rotate token features (B, T, H, D) by per-position angles given as
    cos/sin tables ((T - n_prefix), D/2); prefix tokens (cls) pass through
    unrotated."""
    prefix, tokens = x[:, :n_prefix], x[:, n_prefix:]
    c = cos[None, :, None, :].to(x.dtype)
    s = sin[None, :, None, :].to(x.dtype)
    t1, t2 = tokens.chunk(2, dim=-1)
    rotated = torch.cat([t1 * c - t2 * s, t1 * s + t2 * c], dim=-1)
    return torch.cat([prefix, rotated], dim=1)


def _layer_norm(dim: int) -> nn.LayerNorm:
    return nn.LayerNorm(dim, eps=_LN_EPS)


class SwiGLU(nn.Module):
    def __init__(self, dim: int, hidden: int, out: int):
        super().__init__()
        self.w1 = nn.Linear(dim, hidden)
        self.w2 = nn.Linear(dim, hidden)
        self.ffn_ln = _layer_norm(hidden)      # sub-LN
        self.w3 = nn.Linear(hidden, out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.silu(self.w1(x)) * self.w2(x)
        return self.w3(self.ffn_ln(x))


class EVA02Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_hidden: int):
        super().__init__()
        self.dim, self.heads = dim, heads
        self.norm1 = _layer_norm(dim)
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim, bias=False)
        self.v_proj = nn.Linear(dim, dim)
        self.attn_ln = _layer_norm(dim)        # sub-LN
        self.proj = nn.Linear(dim, dim)
        self.norm2 = _layer_norm(dim)
        self.mlp = SwiGLU(dim, mlp_hidden, dim)

    def qkv(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
        """The block's attention inputs, (B, T, H, D) each, q and k rotated."""
        b, t, _ = x.shape
        head_dim = self.dim // self.heads
        h = self.norm1(x)
        q = self.q_proj(h).reshape(b, t, self.heads, head_dim)
        k = self.k_proj(h).reshape(b, t, self.heads, head_dim)
        v = self.v_proj(h).reshape(b, t, self.heads, head_dim)
        return _apply_rope(q, cos, sin), _apply_rope(k, cos, sin), v

    def finish(self, x: torch.Tensor, attn: torch.Tensor) -> torch.Tensor:
        """The block after attention: sub-LN, projection, residual, MLP."""
        b, t, _ = x.shape
        x = x + self.proj(self.attn_ln(attn.reshape(b, t, self.dim)))
        return x + self.mlp(self.norm2(x))

    def forward(self, x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
        return self.finish(x, attention(*self.qkv(x, cos, sin)))


class EVA02(nn.Module):
    def __init__(self, num_classes: int = 10000, depth: int = 24,
                 dim: int = 1024, heads: int = 16, mlp_hidden: int = 2730,
                 patch: int = 14, image_size: int = 336):
        super().__init__()
        self.depth, self.dim, self.heads = depth, dim, heads
        self.patch, self.image_size = patch, image_size
        n_side = image_size // patch
        self.patch_embed = nn.Conv2d(3, dim, patch, stride=patch)
        self.cls_token = nn.Parameter(torch.empty(1, 1, dim))
        self.pos_embed = nn.Parameter(torch.empty(1, n_side * n_side + 1, dim))
        nn.init.trunc_normal_(self.cls_token, std=0.02, a=-0.04, b=0.04)
        nn.init.trunc_normal_(self.pos_embed, std=0.02, a=-0.04, b=0.04)
        for i in range(depth):
            self.add_module(f"block{i}", EVA02Block(dim, heads, mlp_hidden))
        self.norm = _layer_norm(dim)
        self.head = nn.Linear(dim, num_classes)
        angles = torch.from_numpy(_rope_freqs(dim // heads, n_side))
        self.register_buffer("rope_cos", torch.cos(angles), persistent=False)
        self.register_buffer("rope_sin", torch.sin(angles), persistent=False)

    def blocks(self):
        return [getattr(self, f"block{i}") for i in range(self.depth)]

    def embed(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) normalized RGB -> (B, 1 + patches, dim) tokens: patch
        embedding in row-major patch order, cls token first, positions
        added."""
        b = images.shape[0]
        x = self.patch_embed(images.permute(0, 3, 1, 2))        # (B, C, n, n)
        x = x.permute(0, 2, 3, 1).reshape(b, -1, self.dim)
        x = torch.cat([self.cls_token.expand(b, 1, self.dim), x], dim=1)
        return x + self.pos_embed

    def classify_tokens(self, x: torch.Tensor) -> torch.Tensor:
        return self.head(self.norm(x)[:, 0])

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images: (B, H, W, 3) normalized RGB floats -> (B, num_classes)."""
        x = self.embed(images)
        for block in self.blocks():
            x = block(x, self.rope_cos, self.rope_sin)
        return self.classify_tokens(x)


def build_eva02(name: str = "eva02-large", num_classes: int = 10000,
                image_size: int = 336, quant: str = "none") -> EVA02:
    if name not in EVA02_VARIANTS:
        raise ValueError(f"unknown EVA02 variant {name!r}; valid: "
                         f"{sorted(EVA02_VARIANTS)}")
    if quant == "int8":
        raise ValueError("quant='int8' is not yet ported")
    if quant != "none":
        raise ValueError(f"unknown quant {quant!r} (valid: none, int8)")
    depth, dim, heads, mlp_hidden, patch = EVA02_VARIANTS[name]
    return EVA02(num_classes=num_classes, depth=depth, dim=dim, heads=heads,
                 mlp_hidden=mlp_hidden, patch=patch, image_size=image_size)


def init_eva02(name: str = "eva02-large", num_classes: int = 10000,
               image_size: int = 336, seed: int = 0,
               quant: str = "none") -> EVA02:
    """A model with random weights drawn from ``seed`` (torch's generator:
    not the numbers the JAX package draws from the same seed)."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build_eva02(name, num_classes, image_size, quant)
