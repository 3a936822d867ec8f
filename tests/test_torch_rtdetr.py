"""Port RT-DETR (telescope_cam_detection_tpu_torch/models/rtdetr.py, its
converter, preprocess and detector program) against the JAX package, on the
CPU.

Inputs and Flax variables are numpy draws handed to both frameworks. The
model comparisons use the tolerances of tests/test_torch_parity.py's
RT-DETR mirror (boxes rtol 1e-3 atol 2e-3, logits rtol 1e-3 atol 5e-3);
rows match at IoU >= 0.99 with equal classes and scores within 1e-3."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from telescope_cam_detection_tpu.models import rtdetr as jax_rtdetr
from telescope_cam_detection_tpu.ops import preprocess as jax_preprocess
from telescope_cam_detection_tpu.runtime import program as jax_program
from telescope_cam_detection_tpu_torch.models import rtdetr as port_rtdetr
from telescope_cam_detection_tpu_torch.models.convert import (
    load_npz,
    load_strict,
    rtdetr_state_dict_from_flax,
)
from telescope_cam_detection_tpu_torch.ops import cuda_deform
from telescope_cam_detection_tpu_torch.ops.preprocess import preprocess_rtdetr
from telescope_cam_detection_tpu_torch.runtime import program as port_program
from telescope_cam_detection_tpu_torch.utils.frames import SyntheticFrameSource
from torch_port_utils import flax_rtdetr_variables, flax_tree_from_flat

REPO = Path(__file__).resolve().parent.parent
WEIGHTS = REPO / "weights" / "rtdetrv2_r18vd_scene640.npz"
SMALL = dict(num_classes=8, depths=(1, 1, 1, 1), decoder_layers=2,
             num_queries=30)
SIZE = 128


def _port_model(variables, **kw):
    model = port_rtdetr.RTDETR(**kw)
    load_strict(model, rtdetr_state_dict_from_flax(variables))
    return model.eval()


@pytest.fixture(scope="module")
def small():
    model = jax_rtdetr.RTDETR(**SMALL, sampling_impl="xla")
    variables = flax_rtdetr_variables(model, SIZE, seed=9)
    return model, variables, _port_model(variables, **SMALL)


def _iou(a, b):
    lt = np.maximum(a[:2], b[:2])
    rb = np.minimum(a[2:4], b[2:4])
    inter = np.prod(np.clip(rb - lt, 0, None))
    union = np.prod(a[2:4] - a[:2]) + np.prod(b[2:4] - b[:2]) - inter
    return inter / max(union, 1e-9)


def test_small_rtdetr_matches_flax(small):
    """depths (1, 1, 1, 1), 2 decoder layers, 30 queries, 8 classes at 128²:
    logits, boxes and predict rows against Flax."""
    model, variables, port = small
    images = np.random.default_rng(2).uniform(0, 1, (2, SIZE, SIZE, 3)) \
        .astype(np.float32)
    x = jnp.asarray(images)
    # one forward: predict's rows, and the (logits, boxes) of the model's
    # own call inside it
    want_rows, state = jax.jit(lambda v, x: model.apply(
        v, x, train=False, method=model.predict,
        capture_intermediates=lambda mdl, name: (
            name == "__call__" and mdl.path == ())))(variables, x)
    (want_logits, want_boxes), = state["intermediates"]["__call__"]
    want_rows = np.asarray(want_rows)
    before = cuda_deform.LAUNCHES
    with torch.inference_mode():
        xt = torch.from_numpy(images)
        memory, _, _, _ = port.select_queries(port.features(xt))
        enc_max = port.enc_score_head(port.enc_norm(port.enc_output(
            memory))).amax(-1)
        logits, boxes = port(xt)
        rows = port.predict(xt).numpy()
    assert cuda_deform.LAUNCHES == before           # CPU: the plain version
    # the comparison is by query index, so the selection must be well
    # defined: no two of the top 31 encoder scores within 1e-4
    top = torch.sort(enc_max, dim=1, descending=True).values[:, :31]
    assert float((top[:, :-1] - top[:, 1:]).min()) > 1e-4
    assert logits.shape == (2, 30, 8) and boxes.shape == (2, 30, 4)
    np.testing.assert_allclose(boxes.numpy(), np.asarray(want_boxes),
                               rtol=1e-3, atol=2e-3)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               rtol=1e-3, atol=5e-3)
    assert rows.shape == want_rows.shape == (2, 30, 7)
    for i in range(2):
        for j in range(10):
            got, want = rows[i, j], want_rows[i, j]
            assert int(got[6]) == int(want[6]), (i, j, got, want)
            assert _iou(got, want) >= 0.99, (i, j, got, want)
            assert abs(got[5] - want[5]) < 1e-3


def test_preprocess_rtdetr_matches_jax():
    frames = np.random.default_rng(2).integers(0, 256, (2, 96, 160, 3),
                                                np.uint8)
    for out_hw in ((64, 96), (96, 160)):
        want = np.asarray(jax_preprocess.preprocess_rtdetr(
            jnp.asarray(frames), out_hw))
        got = preprocess_rtdetr(torch.from_numpy(frames), out_hw).numpy()
        assert got.shape == want.shape == (2, *out_hw, 3)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_sincos_positions_and_variants_match_jax():
    np.testing.assert_array_equal(port_rtdetr.sincos_pos_embed_2d(5, 7, 64),
                                  jax_rtdetr.sincos_pos_embed_2d(5, 7, 64))
    assert port_rtdetr.RTDETR_VARIANTS == jax_rtdetr.RTDETR_VARIANTS
    for name in ("HIDDEN", "NUM_QUERIES", "N_HEADS", "N_POINTS", "N_LEVELS"):
        assert getattr(port_rtdetr, name) == getattr(jax_rtdetr, name)
    # a seed fixes the random weights
    a, b = (port_rtdetr.init_rtdetr("rtdetrv2-r18vd", 8, seed=1) for _ in "ab")
    assert a.decoder_layers == 3 and a.backbone.out_channels == (128, 256, 512)
    assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    # bottleneck blocks (r50vd): 4x wider stages, a 1x1 shortcut from stage 0
    wide = port_rtdetr.RTDETR(num_classes=8, depths=(1, 1, 1, 1),
                              bottleneck=True, decoder_layers=1)
    assert wide.backbone.out_channels == (512, 1024, 2048)
    assert hasattr(wide.backbone.stage0_block0, "down")


def test_training_constructs_and_bad_inputs_raise(small):
    port = small[2]
    with pytest.raises(ValueError, match="unknown RT-DETR variant"):
        port_rtdetr.build_rtdetr("rtdetr-nope")
    with pytest.raises(ValueError, match="not yet ported"):
        port_rtdetr.build_rtdetr(remat=True)
    x = torch.zeros(1, SIZE, SIZE, 3)
    with pytest.raises(ValueError, match="not yet ported"):
        port(x, return_aux=True)
    with pytest.raises(ValueError, match="not yet ported"):
        port(x, dn={})
    with pytest.raises(ValueError, match="divisible by 32"):
        port(torch.zeros(1, 96, 100, 3))


def test_converter_is_strict_and_leaves_no_orphans():
    flat = load_npz(WEIGHTS)
    cfg = json.loads(WEIGHTS.with_suffix(".json").read_text())
    state = rtdetr_state_dict_from_flax(flat)
    model = port_rtdetr.build_rtdetr(cfg["variant"], cfg["num_classes"])
    names = {k for k in model.state_dict() if not k.endswith("num_batches_tracked")}
    assert set(state) == names                      # no orphan either way
    assert len(state) == len(flat)
    assert all(v.dtype == torch.float32 for v in state.values())
    load_strict(model, state)
    # layouts: DenseGeneral (in, heads, hd) -> Linear (out, in); Dense
    # (in, out) -> (out, in); conv HWIO -> OIHW; BN statistics
    vp = "params/decoder0/cross_attn/value_proj/"
    np.testing.assert_array_equal(
        state["decoder0.cross_attn.value_proj.weight"].numpy(),
        flat[vp + "kernel"].astype(np.float32).reshape(256, 256).T)
    np.testing.assert_array_equal(
        state["decoder0.cross_attn.value_proj.bias"].numpy(),
        flat[vp + "bias"].astype(np.float32).reshape(256))
    np.testing.assert_array_equal(
        state["encoder.aifi.ffn1.weight"].numpy(),
        flat["params/encoder/aifi/ffn1/kernel"].astype(np.float32).T)
    np.testing.assert_array_equal(
        state["backbone.stage1_block0.down.conv.weight"].numpy(),
        flat["params/backbone/stage1_block0/down/conv/kernel"]
        .astype(np.float32).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        state["encoder.lateral1.bn.running_var"].numpy(),
        flat["batch_stats/encoder/lateral1/bn/var"].astype(np.float32))
    with pytest.raises(ValueError, match="does not match"):
        load_strict(model, {k: v for k, v in state.items()
                            if k != "class_head.bias"})
    # a nested Flax tree converts to the same dict as the flat archive
    nested = rtdetr_state_dict_from_flax(flax_tree_from_flat(flat))
    assert set(nested) == set(state)
    assert all(torch.equal(nested[k], state[k]) for k in state)


def assert_rows_match(rows_a, rows_b, class_conf, margin=1e-3):
    """Every row above its class threshold + margin in one set has a
    partner of the same class in the other at IoU >= 0.99 with its score
    within 1e-3. RT-DETR rows are per (query, class), so one box can stand
    in several rows with different classes: partners are sought within the
    class. Returns the number of matched rows."""
    matched = 0
    for ra, rb in zip(rows_a, rows_b):
        ra, rb = ra[ra[:, 5] >= 0], rb[rb[:, 5] >= 0]
        for src, dst in ((ra, rb), (rb, ra)):
            for row in src:
                if row[4] * row[5] < class_conf[int(row[6])] + margin:
                    continue
                same = dst[dst[:, 6] == row[6]]
                assert len(same), f"no partner of class {int(row[6])}"
                iou = np.array([_iou(row, d) for d in same])
                j = int(np.argmax(iou))
                assert iou[j] >= 0.99, f"IoU {iou[j]:.4f} below parity gate"
                assert abs(row[5] - same[j, 5]) < 1e-3
                matched += 1
    return matched


FILTERS = dict(conf_threshold=0.2, wildlife_only=False, min_box_area=30.0,
               class_confidence_overrides={"bird": 0.35})


@pytest.fixture(scope="module")
def programs():
    """The JAX and the port program at 128² input on the small model
    (tests/test_rtdetr.py's way of shrinking the JAX program: the spec names
    r18vd, the model is replaced before the first dispatch)."""
    kw = dict(num_classes=80, depths=(1, 1, 1, 1), decoder_layers=2,
              num_queries=30)
    model = jax_rtdetr.RTDETR(**kw, sampling_impl="xla")
    variables = flax_rtdetr_variables(model, SIZE, seed=11)
    spec_kw = dict(detector_type="rtdetr", variant="rtdetrv2-r18vd",
                   input_hw=(SIZE, SIZE), max_det=40, transfer="device")
    jprog = jax_program.DetectorProgram(jax_program.ProgramSpec(**spec_kw),
                                        variables=variables)
    jprog.model = model
    pprog = port_program.DetectorProgram(port_program.ProgramSpec(**spec_kw),
                                         device="cpu")
    pprog.model = _port_model(variables, **kw)
    jprog.update_filters(jax_program.FilterSettings(**FILTERS))
    pprog.update_filters(port_program.FilterSettings(**FILTERS))
    src = SyntheticFrameSource(width=512, height=256, seed=3, object_size=60)
    frames = np.stack([src.frame_at(i * 9) for i in range(2)])
    return jprog, pprog, frames


def test_rtdetr_program_rows_match_jax(programs):
    """256x512 capture frames resized on the device, 30 queries padded to
    max_det 40 with -1 rows, boxes scaled back to capture coordinates."""
    jprog, pprog, frames = programs
    want = jprog.detect_batch_rows(frames)
    got = pprog.detect_batch_rows(frames)
    assert got.shape == want.shape == (2, 40, 7)
    assert (got[:, 30:] == -1).all()
    conf = port_program.FilterSettings(**FILTERS).to_arrays(80)[
        "class_conf"].numpy()
    assert assert_rows_match(got, want, conf) > 0
    valid = got[got[..., 5] >= 0]
    assert valid[:, [0, 2]].max() > SIZE       # capture coordinates
    for r in want:
        assert port_program.rows_to_detections(r) == \
            jax_program.rows_to_detections(r)


def test_rtdetr_program_dispatch_and_materialize_match_jax(programs):
    jprog, pprog, frames = programs
    want, _ = jprog.materialize(jprog.dispatch_batch(frames), 2)
    handle = pprog.dispatch_batch(frames)
    assert isinstance(handle, torch.Tensor)
    got, aux = pprog.materialize(handle, 2)
    assert aux is None and got.shape == want.shape == (2, 40, 7)
    conf = port_program.FilterSettings(**FILTERS).to_arrays(80)[
        "class_conf"].numpy()
    assert assert_rows_match(got, want, conf) > 0
    assert pprog.stats["compilations"] == 1


@pytest.mark.slow
def test_shipped_r18vd_matches_flax():
    """The shipped r18vd at 640², on synthetic scene frames, against Flax."""
    flat = load_npz(WEIGHTS)
    variables = flax_tree_from_flat(flat)
    model = jax_rtdetr.build_rtdetr("rtdetrv2-r18vd", 80, sampling_impl="xla")
    port = _port_model(flat)
    src = SyntheticFrameSource(width=640, height=640, seed=0)
    frames = np.stack([src.frame_at(i * 40) for i in range(2)])
    x = np.asarray(jax_preprocess.preprocess_rtdetr(jnp.asarray(frames),
                                                    (640, 640)))
    want = np.asarray(jax.jit(lambda v, x: model.apply(
        v, x, train=False, method=model.predict))(variables, jnp.asarray(x)))
    with torch.inference_mode():
        got = port.predict(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 300, 7)
    assert assert_rows_match(got, want, np.full(80, 0.25, np.float32)) > 0
