"""Port detector program (telescope_cam_detection_tpu_torch/runtime/program.py)
against the JAX DetectorProgram, on the CPU.

Both programs serve the same weights and frames. Confident rows must match
one to one at IoU >= 0.99 with equal classes, in both directions, as in
tests/test_torch_parity.py: rows within a margin of their class threshold
may legitimately flip between frameworks, which sum the conv stacks in
another order."""
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from telescope_cam_detection_tpu.runtime import program as jax_program
from telescope_cam_detection_tpu_torch.models.convert import (
    load_npz,
    yolox_state_dict_from_flax,
)
from telescope_cam_detection_tpu_torch.runtime import program as port_program
from telescope_cam_detection_tpu_torch.utils.frames import SyntheticFrameSource
from torch_port_utils import flax_yolox_variables

WEIGHTS = Path(__file__).resolve().parent.parent / "weights" / "yolox_s_scene640.npz"
MARGIN = 0.01

FILTERS = dict(conf_threshold=0.2, wildlife_only=False, min_box_area=30.0,
               class_confidence_overrides={"bird": 0.35, "person": 0.3},
               class_size_limits={"dog": (100.0, 1e6)})


def _iou(a, b):
    lt = np.maximum(a[None, :2], b[:, :2])
    rb = np.minimum(a[None, 2:4], b[:, 2:4])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=-1)
    union = (np.prod(a[2:4] - a[:2]) + np.prod(b[:, 2:4] - b[:, :2], axis=-1)
             - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


def assert_rows_match(rows_a, rows_b, class_conf, margin=MARGIN):
    """Every row confidently above its class threshold in one set has a
    partner at IoU >= 0.99 with the same class and score in the other.
    Returns the number of matched rows."""
    matched = 0
    for ra, rb in zip(rows_a, rows_b):
        ra, rb = ra[ra[:, 5] >= 0], rb[rb[:, 5] >= 0]
        for src, dst in ((ra, rb), (rb, ra)):
            for row in src:
                score = row[4] * row[5]
                if score < class_conf[int(row[6])] + margin:
                    continue
                assert len(dst), "row has no partner"
                iou = _iou(row, dst)
                j = int(np.argmax(iou))
                assert iou[j] >= 0.99, f"IoU {iou[j]:.4f} below parity gate"
                assert int(row[6]) == int(dst[j, 6]), "class mismatch"
                assert abs(score - dst[j, 4] * dst[j, 5]) < 5e-3
                matched += 1
    return matched


@pytest.fixture(scope="module")
def nano():
    _, variables = flax_yolox_variables("yolox-nano", 128)
    return variables, yolox_state_dict_from_flax(variables)


def _frames(n, h, w, seed=0):
    src = SyntheticFrameSource(width=w, height=h, seed=seed, object_size=40)
    return np.stack([src.frame_at(i * 9) for i in range(n)])


def _pair(spec_kw, variables, state):
    jspec = jax_program.ProgramSpec(variant="yolox-nano", **spec_kw)
    pspec = port_program.ProgramSpec(variant="yolox-nano", **spec_kw)
    jprog = jax_program.DetectorProgram(jspec, variables=variables)
    pprog = port_program.DetectorProgram(pspec, state_dict=state, device="cpu")
    jprog.update_filters(jax_program.FilterSettings(**FILTERS))
    pprog.update_filters(port_program.FilterSettings(**FILTERS))
    return jprog, pprog


@pytest.mark.parametrize("transfer,readback_topk", [
    ("host", None), ("device", 50), ("yuv420", None)])
def test_program_rows_match_jax(nano, transfer, readback_topk):
    variables, state = nano
    jprog, pprog = _pair(dict(input_hw=(128, 128), max_det=100,
                              pre_nms_topk=200, transfer=transfer,
                              readback_topk=readback_topk),
                         variables, state)
    frames = _frames(2, 192, 256)
    want = jprog.detect_batch_rows(frames)
    got = pprog.detect_batch_rows(frames)
    assert got.shape == want.shape == (2, readback_topk or 100, 7)
    conf = port_program.FilterSettings(**FILTERS).to_arrays(80)[
        "class_conf"].numpy()
    assert assert_rows_match(got, want, conf) > 0, "no confident rows"
    # the detection dicts are the JAX package's, field for field
    for r in want:
        assert port_program.rows_to_detections(r) == \
            jax_program.rows_to_detections(r)


def test_filters_and_compaction_match_jax(nano):
    """_filter_rows and _compact_rows on the same rows are bit-equal."""
    rng = np.random.default_rng(4)
    rows = np.concatenate([
        rng.uniform(0, 300, (2, 40, 4)), rng.uniform(0, 1, (2, 40, 2)),
        rng.integers(0, 80, (2, 40, 1))], axis=-1).astype(np.float32)
    rows[..., 2:4] = rows[..., :2] + rng.uniform(2, 80, (2, 40, 2))
    rows[:, 30:] = -1.0
    for settings in ({}, FILTERS, dict(wildlife_only=True, max_box_area=900.0)):
        want = np.asarray(jax_program._filter_rows(
            jnp.asarray(rows),
            jax_program.FilterSettings(**settings).to_arrays(80)))
        got = port_program._filter_rows(
            torch.from_numpy(rows),
            port_program.FilterSettings(**settings).to_arrays(80)).numpy()
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            port_program._compact_rows(torch.from_numpy(got), 12).numpy(),
            np.asarray(jax_program._compact_rows(jnp.asarray(want), 12)))


def test_update_filters_and_capture_hw(nano):
    """Filters change the result without building a program; frames that
    were resized upstream report boxes in the given capture coordinates."""
    _, state = nano
    prog = port_program.DetectorProgram(
        port_program.ProgramSpec(variant="yolox-nano", input_hw=(128, 128),
                                 max_det=100, pre_nms_topk=200),
        state_dict=state, device="cpu")
    frames = _frames(2, 128, 128)
    strict = prog.detect_batch_rows(frames)
    built = prog.stats["compilations"]
    prog.update_filters(port_program.FilterSettings(conf_threshold=0.0,
                                                    wildlife_only=False))
    loose = prog.detect_batch_rows(frames)
    assert prog.stats["compilations"] == built
    assert (loose[..., 5] >= 0).sum() > (strict[..., 5] >= 0).sum()
    rows, aux = prog.materialize(
        prog.dispatch_batch(frames, capture_hw=(256, 512)), 2)
    assert aux is None
    valid = loose[..., 5] >= 0
    np.testing.assert_allclose(rows[valid][:, :4],
                               loose[valid][:, :4] * [4, 2, 4, 2], rtol=1e-6)
    dets = prog.detect_batch(frames)
    assert len(dets) == 2 and all(isinstance(d, list) for d in dets)
    assert prog.stats["batches"] == 4 and prog.stats["frames"] == 8


@pytest.mark.parametrize("spec_kw,kw,match", [
    (dict(transfer="delta"), {}, "not yet ported"),
    (dict(gates="device"), {}, "not yet ported"),
    # RT-DETR is ported (test_rtdetr_spec_builds_and_serves_rows); its
    # delta transfer is not
    (dict(detector_type="rtdetr", variant="rtdetrv2-r18vd", transfer="delta"),
     {}, "not yet ported"),
    ({}, dict(mesh=object()), "not yet ported"),
    (dict(transfer="bogus"), {}, "unknown transfer"),
])
def test_unported_options_refused(spec_kw, kw, match):
    spec = port_program.ProgramSpec(
        **{"variant": "yolox-nano", "input_hw": (64, 64), **spec_kw})
    with pytest.raises(ValueError, match=match):
        port_program.DetectorProgram(spec, device="cpu", **kw)


def test_rtdetr_spec_builds_and_serves_rows():
    """detector_type="rtdetr" builds r18vd from the seed on the CPU and
    returns (B, max_det, 7) rows: 300 queries cut to max_det."""
    spec = port_program.ProgramSpec(detector_type="rtdetr",
                                    variant="rtdetrv2-r18vd",
                                    input_hw=(64, 64), max_det=100)
    prog = port_program.DetectorProgram(spec, device="cpu")
    assert prog.model.decoder_layers == 3
    rows = prog.detect_batch_rows(np.zeros((2, 64, 64, 3), np.uint8))
    assert rows.shape == (2, 100, 7)


def test_attach_classifier_refused():
    prog = port_program.DetectorProgram(
        port_program.ProgramSpec(variant="yolox-nano", input_hw=(64, 64)),
        device="cpu")
    with pytest.raises(ValueError, match="not yet ported"):
        prog.attach_classifier(None, None, 112)


@pytest.mark.slow
def test_shipped_yolox_s_program_matches_jax():
    """The shipped detector at full width, 640² input, 1440p capture frames
    resized on the device, against the JAX program."""
    flat = load_npz(WEIGHTS)
    from telescope_cam_detection_tpu.models.convert import _unflatten
    variables = jax.tree.map(
        lambda x: np.asarray(x, np.float32),
        _unflatten({tuple(k.split("/")): v for k, v in flat.items()}))
    spec_kw = dict(variant="yolox-s", input_hw=(640, 640), transfer="device")
    jprog = jax_program.DetectorProgram(jax_program.ProgramSpec(**spec_kw),
                                        variables=variables)
    pprog = port_program.DetectorProgram(port_program.ProgramSpec(**spec_kw),
                                         state_dict=yolox_state_dict_from_flax(flat),
                                         device="cpu")
    settings = dict(conf_threshold=0.05, wildlife_only=False)
    jprog.update_filters(jax_program.FilterSettings(**settings))
    pprog.update_filters(port_program.FilterSettings(**settings))
    src = SyntheticFrameSource(width=2560, height=1440, seed=0)
    frames = np.stack([src.frame_at(i * 40) for i in range(2)])
    want = jprog.detect_batch_rows(frames)
    got = pprog.detect_batch_rows(frames)
    assert got.shape == want.shape == (2, 300, 7)
    conf = np.full(80, 0.05, np.float32)
    assert assert_rows_match(got, want, conf) > 0
