"""Port YOLOX (telescope_cam_detection_tpu_torch/models/*) against the Flax
model, on the CPU.

Flax variables filled from a numpy seed, sharpened so scores spread like a
trained detector's, are carried across by the port's own converter and loaded strictly. The
decoded (boxes, obj, cls) must agree within the tolerances of
tests/test_torch_parity.py's decode test: the conv stacks sum in another
order in the two frameworks."""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from telescope_cam_detection_tpu.models.convert import export_yolox_to_torch_names
from telescope_cam_detection_tpu.models.yolox import decode_outputs as jax_decode
from telescope_cam_detection_tpu_torch.models import convert
from telescope_cam_detection_tpu_torch.models.yolox import (
    build_yolox,
    decode_outputs,
)
from torch_port_utils import flax_yolox_variables

WEIGHTS = Path(__file__).resolve().parent.parent / "weights" / "yolox_s_scene640.npz"


@pytest.fixture(scope="module", params=[("yolox-nano", 128), ("yolox-s", 64)])
def both(request):
    variant, size = request.param
    model, variables = flax_yolox_variables(variant, size)
    tm = build_yolox(variant, 80).eval()
    convert.load_strict(tm, convert.yolox_state_dict_from_flax(variables))
    return variant, size, model, variables, tm


def test_converter_matches_jax_export(both):
    """The port's converter gives the JAX exporter's names and values."""
    _, _, _, variables, tm = both
    ours = convert.yolox_state_dict_from_flax(variables)
    theirs = export_yolox_to_torch_names(variables)
    assert set(ours) == set(theirs)
    for name, value in theirs.items():
        np.testing.assert_array_equal(ours[name].numpy(), value)
    names = {k for k in tm.state_dict() if "num_batches_tracked" not in k}
    assert names == set(ours)


def test_decode_matches_flax(both):
    variant, size, model, variables, tm = both
    frames = np.random.default_rng(0).uniform(
        0, 255, (2, size, size, 3)).astype(np.float32)
    fb, fo, fc = jax.jit(lambda v, x: jax_decode(
        model.apply(v, x, train=False)))(variables, jnp.asarray(frames))
    with torch.no_grad():
        tb, to, tc = decode_outputs(tm(torch.from_numpy(frames)))
    anchors = sum((size // s) ** 2 for s in (8, 16, 32))
    assert tb.shape == (2, anchors, 4) and tc.shape == (2, anchors, 80)
    np.testing.assert_allclose(tb.numpy(), np.asarray(fb), atol=0.35, rtol=1e-3)
    np.testing.assert_allclose(to.numpy(), np.asarray(fo), atol=5e-3)
    np.testing.assert_allclose(tc.numpy(), np.asarray(fc), atol=5e-3)
    # sharpening worked: the comparison covers saturated, spread scores
    assert (to.numpy() > 0.5).any() and (to.numpy() < 0.1).any()


def test_shipped_weights_load_strict():
    """weights/yolox_s_scene640.npz (fp16, '/'-joined Flax paths) loads
    strictly into the port's yolox-s as fp32."""
    flat = convert.load_npz(WEIGHTS)
    assert len(flat) == 388
    state = convert.yolox_state_dict_from_flax(flat)
    assert all(v.dtype == torch.float32 for v in state.values())
    model = build_yolox("yolox-s", 80)
    convert.load_strict(model, state)
    w = model.backbone.backbone.stem.conv.conv.weight
    np.testing.assert_array_equal(
        w.detach().numpy(),
        np.transpose(flat["params/backbone/stem/conv/conv/kernel"],
                     (3, 2, 0, 1)).astype(np.float32))


def test_load_strict_refuses_a_mismatch():
    model = build_yolox("yolox-nano", 80)
    state = {k: v for k, v in model.state_dict().items()
             if "num_batches_tracked" not in k}
    convert.load_strict(model, state)
    state.pop(next(iter(state)))
    with pytest.raises(ValueError, match="missing"):
        convert.load_strict(model, state)
    with pytest.raises(ValueError, match="unexpected"):
        convert.load_strict(model, {**model.state_dict(), "extra.weight":
                                    torch.zeros(1)})
