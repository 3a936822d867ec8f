"""Flax weights -> PyTorch state dicts for the port's YOLOX, EVA02, RT-DETR.

Counterpart of ``telescope_cam_detection_tpu/models/convert.py``: the same
Flax-path -> Megvii-name map (``flax_path_to_torch_name``), the same
HWIO -> OIHW kernel transpose, read with numpy only. The port's EVA02 and
RT-DETR keep the Flax tree's names, so their maps
(``eva02_state_dict_from_flax``, ``rtdetr_state_dict_from_flax``) only
rename leaves and transpose kernels. The committed
``weights/*.npz`` archives store fp16 leaves under '/'-joined Flax paths;
they are cast to fp32, the port's serving precision (the role
``cast_tree_like`` plays in the JAX package).
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, Mapping, Tuple, Union

import numpy as np
import torch
import torch.nn as nn


def _module_prefix(parts: Tuple[str, ...]) -> Tuple[str, Tuple[str, ...]]:
    """Translate the leading module components of a flax path into the
    Megvii dotted prefix; returns (prefix, remaining_parts)."""
    out = []
    i = 0
    top = parts[0]
    if top == "backbone":
        out.append("backbone.backbone")
        i = 1
        stage = parts[1]
        if stage == "stem":
            out.append("stem")
            i = 2
        else:
            m = re.fullmatch(r"dark(\d)_(conv|csp|spp)", stage)
            if not m:
                raise KeyError(f"unknown backbone stage {stage}")
            n, kind = int(m.group(1)), m.group(2)
            idx = {"conv": 0, "csp": 1, "spp": 1}[kind]
            if n == 5:
                idx = {"conv": 0, "spp": 1, "csp": 2}[kind]
            out.append(f"dark{n}.{idx}")
            i = 2
    elif top == "neck":
        out.append("backbone")  # Megvii YOLOPAFPN is the top-level 'backbone'
        out.append(parts[1])
        i = 2
    elif top == "head":
        out.append("head")
        leaf = parts[1]
        m = re.fullmatch(r"(stem|cls_conv|reg_conv|cls_pred|reg_pred|obj_pred)"
                         r"(\d)(?:_(\d))?", leaf)
        if not m:
            raise KeyError(f"unknown head module {leaf}")
        kind, lvl, j = m.group(1), m.group(2), m.group(3)
        name = {"stem": "stems", "cls_conv": "cls_convs",
                "reg_conv": "reg_convs", "cls_pred": "cls_preds",
                "reg_pred": "reg_preds", "obj_pred": "obj_preds"}[kind]
        out.append(f"{name}.{lvl}" + (f".{j}" if j is not None else ""))
        i = 2
    else:
        raise KeyError(f"unknown top module {top}")
    return ".".join(out), parts[i:]


def _inner_name(parts: Tuple[str, ...]) -> str:
    """Translate intra-block path components (CSP m{i}, conv/bn leaves)."""
    out = []
    for p in parts:
        m = re.fullmatch(r"m(\d+)", p)
        if m:
            out.append(f"m.{m.group(1)}")
        else:
            out.append(p)
    return ".".join(out)


_LEAF_MAP = {
    ("params", "kernel"): "weight",
    ("params", "bias"): "bias",
    ("params", "scale"): "weight",        # BatchNorm gamma
    ("batch_stats", "mean"): "running_mean",
    ("batch_stats", "var"): "running_var",
}


def flax_path_to_torch_name(collection: str, path: Tuple[str, ...]) -> str:
    """('params', ('backbone','dark3_csp','m0','conv1','conv','kernel'))
    -> 'backbone.backbone.dark3.1.m.0.conv1.conv.weight'"""
    prefix, rest = _module_prefix(path)
    *mods, leaf = rest
    torch_leaf = _LEAF_MAP[(collection, leaf)]
    inner = _inner_name(tuple(mods))
    pieces = [prefix] + ([inner] if inner else []) + [torch_leaf]
    return ".".join(pieces)


def _to_torch_value(leaf_name: str, value: np.ndarray) -> np.ndarray:
    if leaf_name == "kernel" and value.ndim == 4:
        return np.transpose(value, (3, 2, 0, 1))  # HWIO -> OIHW
    return value


def _flatten(tree: Mapping[Any, Any],
             prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    """Nested dicts with str keys, '/'-joined keys, or tuple keys -> one
    flat dict keyed by path tuples."""
    out: Dict[Tuple[str, ...], Any] = {}
    for k, v in tree.items():
        path = prefix + (tuple(k) if isinstance(k, tuple)
                         else tuple(str(k).split("/")))
        if isinstance(v, Mapping):
            out.update(_flatten(v, path))
        else:
            out[path] = v
    return out


def yolox_state_dict_from_flax(flat: Mapping[Any, Any]
                               ) -> Dict[str, torch.Tensor]:
    """Flax YOLOX variables -> Megvii-named fp32 torch state dict.

    ``flat`` is the dict of a ``weights/*.npz`` archive ('/'-joined paths
    such as ``params/backbone/stem/conv/conv/kernel``) or a Flax variable
    tree ({"params": ..., "batch_stats": ...}), nested or flattened."""
    out: Dict[str, torch.Tensor] = {}
    for (collection, *path), leaf in _flatten(flat).items():
        name = flax_path_to_torch_name(collection, tuple(path))
        value = _to_torch_value(path[-1], np.asarray(leaf))
        if np.issubdtype(value.dtype, np.floating):
            value = value.astype(np.float32)
        out[name] = torch.from_numpy(np.ascontiguousarray(value))
    return out


def eva02_state_dict_from_flax(flat: Mapping[Any, Any]
                               ) -> Dict[str, torch.Tensor]:
    """Flax EVA02 variables -> fp32 state dict of ``models/eva02.EVA02``.

    ``flat`` is the dict of ``weights/eva02_species.npz`` ('/'-joined paths
    such as ``params/block0/q_proj/kernel``) or a Flax variable tree
    ({"params": ...}), nested or flattened. Dense kernels (in, out) become
    ``nn.Linear`` weights (out, in); the patch embedding goes HWIO -> OIHW;
    LayerNorm ``scale`` becomes ``weight``."""
    out: Dict[str, torch.Tensor] = {}
    for (collection, *path), leaf in _flatten(flat).items():
        if collection != "params":
            raise KeyError(f"unknown EVA02 collection {collection}")
        value = np.asarray(leaf)
        leaf_name = path[-1]
        if leaf_name == "kernel":
            value = (np.transpose(value, (3, 2, 0, 1)) if value.ndim == 4
                     else value.T)
        name = ".".join(path[:-1] + [
            {"kernel": "weight", "scale": "weight"}.get(leaf_name, leaf_name)])
        out[name] = torch.from_numpy(
            np.ascontiguousarray(value.astype(np.float32)))
    return out


def rtdetr_state_dict_from_flax(flat: Mapping[Any, Any]
                                ) -> Dict[str, torch.Tensor]:
    """Flax RT-DETR variables -> fp32 state dict of ``models/rtdetr.RTDETR``.

    ``flat`` is the dict of ``weights/rtdetrv2_*.npz`` ('/'-joined paths
    such as ``params/decoder0/cross_attn/value_proj/kernel``) or a Flax
    variable tree ({"params": ..., "batch_stats": ...}), nested or
    flattened. Conv kernels go HWIO -> OIHW; Dense kernels (in, out) become
    ``nn.Linear`` weights (out, in); the ``DenseGeneral`` value projection
    (in, heads, hd) is flattened to (in, heads * hd) first, its bias
    (heads, hd) to (heads * hd,); BatchNorm and LayerNorm ``scale`` become
    ``weight``, BatchNorm ``mean``/``var`` the running statistics."""
    out: Dict[str, torch.Tensor] = {}
    for (collection, *path), leaf in _flatten(flat).items():
        value = np.asarray(leaf)
        leaf_name = path[-1]
        if path[-2] == "value_proj":
            value = value.reshape(value.shape[0], -1) if leaf_name == "kernel" \
                else value.reshape(-1)
        if collection == "params":
            if leaf_name == "kernel":
                value = (np.transpose(value, (3, 2, 0, 1)) if value.ndim == 4
                         else value.T)
            torch_leaf = {"kernel": "weight", "scale": "weight"}.get(
                leaf_name, leaf_name)
        elif collection == "batch_stats":
            torch_leaf = {"mean": "running_mean", "var": "running_var"}[leaf_name]
        else:
            raise KeyError(f"unknown RT-DETR collection {collection}")
        out[".".join(path[:-1] + [torch_leaf])] = torch.from_numpy(
            np.ascontiguousarray(value.astype(np.float32)))
    return out


def load_npz(path: Union[str, Path]) -> Dict[str, np.ndarray]:
    """Read a committed ``weights/*.npz`` archive (numpy only)."""
    with np.load(Path(path), allow_pickle=False) as data:
        return dict(data)


def load_strict(model: nn.Module, state: Mapping[str, torch.Tensor]) -> None:
    """``load_state_dict`` that raises on any missing or unexpected name.
    Only ``num_batches_tracked`` may be missing: the BatchNorm step counter
    exists on the torch side alone and inference never reads it."""
    missing, unexpected = model.load_state_dict(state, strict=False)
    missing = [m for m in missing if not m.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise ValueError(f"state dict does not match the model: missing "
                         f"{missing[:5]}, unexpected {unexpected[:5]}")
