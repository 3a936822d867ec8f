"""Port EVA02 (telescope_cam_detection_tpu_torch/models/eva02.py) against the
Flax EVA02 on the CPU, with the same numpy parameters carried across by
``models/convert.eva02_state_dict_from_flax``.

Tolerance: rtol = atol = 2e-4 on the logits with equal top-5, the gate of
tests/test_torch_parity.py::test_eva02_stage2_parity_vs_torch_mirror (fp32
matmuls summed in another order through 2 to 12 blocks). The Flax model runs
with ``attn_impl="xla"`` and with ``"pallas"`` (the TPU kernel in interpret
mode, as tests/test_pallas_attention.py runs it)."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from telescope_cam_detection_tpu.models import eva02 as jax_eva02
from telescope_cam_detection_tpu_torch.models import eva02 as port_eva02
from telescope_cam_detection_tpu_torch.models.convert import (
    eva02_state_dict_from_flax,
    load_npz,
    load_strict,
)
from telescope_cam_detection_tpu_torch.ops import cuda_attention
from torch_port_utils import (
    flat_from_flax_tree,
    flax_eva02_variables,
    flax_tree_from_flat,
)

REPO = Path(__file__).resolve().parent.parent
TOL = 2e-4
SMALL = dict(num_classes=17, depth=2, dim=64, heads=2, mlp_hidden=96,
             patch=14, image_size=56)


def _assert_logits_match(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(np.argsort(-got, -1)[:, :5],
                                  np.argsort(-want, -1)[:, :5])


@pytest.fixture(scope="module")
def small_pair():
    variables = flax_eva02_variables(jax_eva02.EVA02(**SMALL), 56)
    model = port_eva02.EVA02(**SMALL).eval()
    load_strict(model, eva02_state_dict_from_flax(
        flat_from_flax_tree(variables)))
    return variables, model


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_small_eva02_matches_flax(small_pair, attn_impl):
    variables, model = small_pair
    rng = np.random.default_rng(0)
    images = rng.normal(0, 1, (2, 56, 56, 3)).astype(np.float32)
    want = np.asarray(jax_eva02.EVA02(**SMALL, attn_impl=attn_impl).apply(
        variables, jnp.asarray(images), train=False))
    before = cuda_attention.LAUNCHES
    with torch.inference_mode():
        got = model(torch.from_numpy(images)).numpy()
    assert cuda_attention.LAUNCHES == before     # CPU: the plain version
    assert got.shape == (2, 17)
    _assert_logits_match(got, want)


@pytest.fixture(scope="module")
def shipped():
    cfg = json.loads((REPO / "weights" / "eva02_species.json").read_text())
    flat = load_npz(REPO / "weights" / "eva02_species.npz")
    return cfg, flat


def test_converter_is_strict_and_leaves_no_orphans(shipped):
    cfg, flat = shipped
    state = eva02_state_dict_from_flax(flat)
    model = port_eva02.build_eva02(cfg["variant"], cfg["num_classes"],
                                   cfg["input_size"])
    assert set(state) == set(model.state_dict())        # no orphan either way
    assert len(state) == len(flat)
    assert all(v.dtype == torch.float32 for v in state.values())
    load_strict(model, state)
    # layouts: Dense (in, out) -> Linear (out, in); patch embed HWIO -> OIHW
    np.testing.assert_array_equal(
        state["block0.mlp.w1.weight"].numpy(),
        flat["params/block0/mlp/w1/kernel"].astype(np.float32).T)
    np.testing.assert_array_equal(
        state["patch_embed.weight"].numpy(),
        flat["params/patch_embed/kernel"].astype(np.float32)
        .transpose(3, 2, 0, 1))
    assert "block0.k_proj.bias" not in state            # k_proj has no bias
    with pytest.raises(ValueError, match="does not match"):
        load_strict(model, {k: v for k, v in state.items() if k != "norm.bias"})
    # a nested Flax tree converts to the same dict as the flat archive
    nested = eva02_state_dict_from_flax(flax_tree_from_flat(flat))
    assert set(nested) == set(state)
    assert all(torch.equal(nested[k], state[k]) for k in state)


@pytest.mark.parametrize("attn_impl", ["xla", "pallas"])
def test_shipped_eva02_tiny_matches_flax(shipped, attn_impl):
    cfg, flat = shipped
    size = cfg["input_size"]
    model = port_eva02.build_eva02(cfg["variant"], cfg["num_classes"], size)
    load_strict(model.eval(), eva02_state_dict_from_flax(flat))
    rng = np.random.default_rng(1)
    images = rng.normal(0, 1, (3, size, size, 3)).astype(np.float32)
    flax_model = jax_eva02.build_eva02(cfg["variant"], cfg["num_classes"],
                                       size, attn_impl=attn_impl)
    want = np.asarray(jax.jit(
        lambda v, x: flax_model.apply(v, x, train=False))(
            flax_tree_from_flat(flat), jnp.asarray(images)))
    with torch.inference_mode():
        got = model(torch.from_numpy(images)).numpy()
    assert got.shape == (3, cfg["num_classes"])
    _assert_logits_match(got, want)


def test_rope_tables_and_rotation_match_jax():
    for dim, n_side in ((64, 8), (32, 4)):
        np.testing.assert_array_equal(port_eva02._rope_freqs(dim, n_side),
                                      jax_eva02._rope_freqs(dim, n_side))
    rng = np.random.default_rng(2)
    x = rng.normal(0, 1, (2, 17, 3, 32)).astype(np.float32)
    angles = jax_eva02._rope_freqs(32, 4)
    want = np.asarray(jax_eva02._apply_rope(jnp.asarray(x), jnp.asarray(angles)))
    ang = torch.from_numpy(angles)
    got = port_eva02._apply_rope(torch.from_numpy(x), torch.cos(ang),
                                 torch.sin(ang)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)  # cos/sin ulps
    np.testing.assert_array_equal(got[:, 0], x[:, 0])   # cls is not rotated


def test_variants_and_refusals():
    assert port_eva02.EVA02_VARIANTS == jax_eva02.EVA02_VARIANTS
    with pytest.raises(ValueError, match="unknown EVA02 variant"):
        port_eva02.build_eva02("eva02-huge")
    with pytest.raises(ValueError, match="not yet ported"):
        port_eva02.build_eva02("eva02-tiny", quant="int8")
    with pytest.raises(ValueError, match="unknown quant"):
        port_eva02.build_eva02("eva02-tiny", quant="fp4")
    a = port_eva02.init_eva02("eva02-tiny", 8, 56, seed=3)
    b = port_eva02.init_eva02("eva02-tiny", 8, 56, seed=3)
    c = port_eva02.init_eva02("eva02-tiny", 8, 56, seed=4)
    assert torch.equal(a.head.weight, b.head.weight)
    assert not torch.equal(a.head.weight, c.head.weight)
    assert all(m.eps == 1e-6 for m in a.modules()
               if isinstance(m, torch.nn.LayerNorm))


@pytest.mark.slow
def test_eva02_large_block_matches_flax():
    """One block of eva02-large width (dim 1024, 16 heads of 64, T = 577)."""
    kw = dict(num_classes=32, depth=1, dim=1024, heads=16, mlp_hidden=2730,
              patch=14, image_size=336)
    variables = flax_eva02_variables(jax_eva02.EVA02(**kw), 336)
    model = port_eva02.EVA02(**kw).eval()
    load_strict(model, eva02_state_dict_from_flax(
        flat_from_flax_tree(variables)))
    images = np.random.default_rng(0).normal(
        0, 1, (1, 336, 336, 3)).astype(np.float32)
    want = np.asarray(jax_eva02.EVA02(**kw).apply(
        variables, jnp.asarray(images), train=False))
    with torch.inference_mode():
        got = model(torch.from_numpy(images)).numpy()
    _assert_logits_match(got, want)
