"""Shared inputs of the port's parity tests (tests/test_torch_*.py)."""
import shutil
from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp

from telescope_cam_detection_tpu.models.convert import sharpen_random_variables
from telescope_cam_detection_tpu.models.yolox import build_yolox

# The suite runs in several pytest-xdist workers at once, and every worker
# imports this module while collecting. Torch's default of one intra-op
# thread per core in each worker would oversubscribe the host, which slows
# the timing-sensitive sampler tests (tests/test_profiling.py).
torch.set_num_threads(2)


def flax_yolox_variables(variant: str, size: int, seed: int = 3):
    """A Flax YOLOX variable tree filled from a numpy seed, then sharpened
    (models/convert.py sharpen_random_variables) so scores saturate and
    spread like a trained detector's.

    The tree's structure comes from ``jax.eval_shape`` of ``model.init``;
    the values are numpy draws, which makes the same inputs for both
    frameworks without paying Flax's eager initialisation (tens of seconds
    on the CPU)."""
    model = build_yolox(variant, 80)
    shapes = jax.eval_shape(
        lambda x: model.init(jax.random.PRNGKey(0), x, train=False),
        jnp.zeros((1, size, size, 3)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            value = rng.normal(0.0, 1.0 / np.sqrt(fan_in), leaf.shape)
        elif name == "var":
            value = rng.uniform(0.5, 1.5, leaf.shape)
        elif name == "scale":
            value = rng.uniform(0.8, 1.2, leaf.shape)
        else:                                   # bias, BN mean
            value = rng.normal(0.0, 0.05, leaf.shape)
        return jnp.asarray(value.astype(np.float32))

    variables = jax.tree_util.tree_map_with_path(fill, shapes)
    return model, sharpen_random_variables(variables, seed)


def flax_tree_from_flat(flat):
    """A flat dict with '/'-joined Flax paths (a ``weights/*.npz`` archive)
    -> the nested fp32 variable tree the Flax model applies."""
    tree = {}
    for key, value in flat.items():
        *mods, leaf = key.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = jnp.asarray(np.asarray(value, np.float32))
    return tree


def flat_from_flax_tree(tree, prefix=""):
    """The inverse: nested variable tree -> flat dict of numpy arrays."""
    flat = {}
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(value, dict):
            flat.update(flat_from_flax_tree(value, path))
        else:
            flat[path] = np.asarray(value)
    return flat


def flax_eva02_variables(model, image_size: int, seed: int = 5):
    """A Flax EVA02 variable tree filled from a numpy seed (structure from
    ``jax.eval_shape`` of ``model.init``): kernels ~ N(0, 1/fan_in), norm
    scales near 1, biases and tokens small, so logits spread enough for a
    top-5 to be well defined."""
    shapes = jax.eval_shape(
        lambda x: model.init(jax.random.PRNGKey(0), x, train=False),
        jnp.zeros((1, image_size, image_size, 3)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            value = rng.normal(0.0, 1.0 / np.sqrt(fan_in), leaf.shape)
        elif name == "scale":
            value = rng.uniform(0.8, 1.2, leaf.shape)
        else:                                   # bias, cls_token, pos_embed
            value = rng.normal(0.0, 0.05, leaf.shape)
        return jnp.asarray(value.astype(np.float32))

    return jax.tree_util.tree_map_with_path(fill, shapes)


def flax_rtdetr_variables(model, size: int, seed: int = 7):
    """A Flax RT-DETR variable tree filled from a numpy seed (structure from
    ``jax.eval_shape`` of ``model.init``): kernels ~ N(0, 1/fan_in) (the
    ``DenseGeneral`` value projection's fan-in is its first axis), BatchNorm
    variances and scales near 1, biases and means small."""
    shapes = jax.eval_shape(
        lambda x: model.init(jax.random.PRNGKey(0), x, train=False),
        jnp.zeros((1, size, size, 3)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1])) if leaf.ndim != 3 \
                else leaf.shape[0]
            value = rng.normal(0.0, 1.0 / np.sqrt(fan_in), leaf.shape)
        elif name == "var":
            value = rng.uniform(0.5, 1.5, leaf.shape)
        elif name == "scale":
            value = rng.uniform(0.8, 1.2, leaf.shape)
        else:                                   # bias, BN mean
            value = rng.normal(0.0, 0.05, leaf.shape)
        return jnp.asarray(value.astype(np.float32))

    return jax.tree_util.tree_map_with_path(fill, shapes)


def redirect_jax_native(monkeypatch, tmp_dir):
    """Point the JAX package's native frameio wrapper
    (``telescope_cam_detection_tpu/utils/native.py``) at a copy of
    ``native/`` under ``tmp_dir``, unloaded: a library it builds goes there,
    never into the repository's ``native/``, where another test process may
    be building or loading its own at the same time."""
    from telescope_cam_detection_tpu.utils import native
    copy = Path(tmp_dir) / "native"
    copy.mkdir()
    for name in ("frameio.cpp", "Makefile"):
        shutil.copy(Path(__file__).resolve().parent.parent / "native" / name,
                    copy / name)
    monkeypatch.setattr(native, "_NATIVE_DIR", copy)
    monkeypatch.setattr(native, "_LIB_PATH", copy / "libframeio.so")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_tried", False)
    return native
