"""Shared inputs of the port's parity tests (tests/test_torch_*.py)."""
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
