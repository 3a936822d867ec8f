"""Port TwoStageDetectionPipeline
(telescope_cam_detection_tpu_torch/pipeline/two_stage.py) against the JAX
pipeline on the CPU: the same frame and the same detection dicts through all
three branches of ``process_detections`` (device crops, host crops, fused
``species_raw`` transport), with the shipped eva02-tiny weights in both
classifiers (the JAX one built with ``param_dtype=jnp.float32``).

Tolerance: identical annotated dicts, keys and strings equal, confidences
within 1e-3 (the classifier's tolerance, tests/test_torch_species.py). The
host re-rankers (time of day, activity patterns) are the port's own copies
and are held equal."""
import copy
import json
from datetime import datetime
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from telescope_cam_detection_tpu.pipeline import activity as jax_activity
from telescope_cam_detection_tpu.pipeline import species as jax_species
from telescope_cam_detection_tpu.pipeline import time_of_day as jax_tod
from telescope_cam_detection_tpu.pipeline import two_stage as jax_two_stage
from telescope_cam_detection_tpu_torch.models.convert import (
    eva02_state_dict_from_flax,
    load_npz,
)
from telescope_cam_detection_tpu_torch.pipeline import activity as port_activity
from telescope_cam_detection_tpu_torch.pipeline import species as port_species
from telescope_cam_detection_tpu_torch.pipeline import time_of_day as port_tod
from telescope_cam_detection_tpu_torch.pipeline import two_stage as port_two_stage
from torch_port_utils import flax_tree_from_flat

REPO = Path(__file__).resolve().parent.parent
CONF_TOL = 1e-3
# names the activity table knows, so the time-of-day re-rank has work to do
NAMES = ["great horned owl", "red-tailed hawk", "coyote", "desert iguana",
         "bobcat", "gambel's quail", "kit fox", "barn owl", "mule deer",
         "common raven", "pallid bat", "rock squirrel", "sidewinder",
         "desert tortoise", "ringtail", "verdin"]


@pytest.fixture(scope="module")
def classifiers(tmp_path_factory):
    cfg = json.loads((REPO / "weights" / "eva02_species.json").read_text())
    flat = load_npz(REPO / "weights" / "eva02_species.npz")
    tax = {str(i): {"common_name": n, "genus": f"Genus{i % 4}",
                    "family": f"Family{i % 2}", "order": "Synthetica",
                    "class": "Mammalia"} for i, n in enumerate(NAMES)}
    # two entries with no genus or family: a mid confidence falls to "order"
    tax["3"] = {"common_name": NAMES[3], "order": "Squamata"}
    tax["9"] = {"common_name": NAMES[9], "order": "Passeriformes"}
    path = tmp_path_factory.mktemp("tax") / "taxonomy.json"
    path.write_text(json.dumps(tax))
    args = (cfg["variant"], cfg["num_classes"], cfg["input_size"])
    port = port_species.SpeciesClassifier(
        *args, taxonomy_file=str(path),
        state_dict=eva02_state_dict_from_flax(flat), device="cpu")
    ref = jax_species.SpeciesClassifier(
        *args, taxonomy_file=str(path), variables=flax_tree_from_flat(flat),
        param_dtype=jnp.float32, attn_impl="xla")
    return port, ref


def _frame(seed=0, hw=(360, 480)):
    """A smooth scene with a few textured blobs (the animals)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:hw[0], 0:hw[1]].astype(np.float32)
    img = np.stack([60 + 0.2 * x, 90 + 0.1 * y, 120 - 0.1 * x], -1)
    for cy, cx, r in ((90, 110, 45), (230, 300, 70), (120, 380, 35)):
        blob = np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / (2 * r * r))[..., None]
        tex = 0.5 + 0.5 * np.sin(x * rng.uniform(0.2, 0.8) + y * rng.uniform(0, 0.5))
        img = img * (1 - blob) + blob * tex[..., None] * rng.uniform(80, 255, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def _det(cid, name, box, conf=0.9, **extra):
    x1, y1, x2, y2 = box
    return {"class_id": cid, "class_name": name, "confidence": conf,
            "bbox": {"x1": x1, "y1": y1, "x2": x2, "y2": y2,
                     "width": x2 - x1, "height": y2 - y1,
                     "area": (x2 - x1) * (y2 - y1)}, **extra}


def _detections():
    return [
        _det(15, "cat", (60.5, 40.0, 165.2, 140.7), time_of_day="day"),
        _det(14, "bird", (220.0, 150.0, 390.0, 310.0), time_of_day="night"),
        _det(2, "car", (0, 0, 200, 200)),                       # not routed
        _det(14, "bird", (10, 10, 40, 30)),                     # too small
        _det(16, "dog", (340.0, 80.0, 430.0, 165.0), time_of_day="dusk"),
        _det(21, "bear", (400.0, 300.0, 480.0, 360.0)),         # at the edge
    ]


def _assert_same(got, want):
    """Identical annotated detections: equal keys and values, floats within
    CONF_TOL, nested prediction lists compared the same way."""
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for key in want:
            _assert_same(got[key], want[key])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, float):
        assert abs(got - want) <= CONF_TOL
    else:
        assert got == want


def _pipes(classifiers, **kw):
    port, ref = classifiers
    kw = dict(min_crop_size=24, confidence_threshold=0.05,
              crop_batch_size_hw=port.input_size, **kw)
    return (port_two_stage.TwoStageDetectionPipeline(port, **kw),
            jax_two_stage.TwoStageDetectionPipeline(ref, **kw))


def _stats_match(port_pipe, ref_pipe):
    got, want = port_pipe.get_stats(), ref_pipe.get_stats()
    for key in ("total_detections", "total_classified", "total_skipped_small"):
        assert got[key] == want[key], key
    assert set(got) == set(want)


@pytest.mark.parametrize("seed", [0, 1])
def test_device_crops_branch_matches_jax(classifiers, seed):
    port_pipe, ref_pipe = _pipes(classifiers, device_crops=True)
    frame = _frame(seed)
    got = port_pipe.process_detections(frame, _detections())
    want = ref_pipe.process_detections(frame, _detections())
    assert sum("species" in d for d in got) >= 2
    assert "species" not in got[2] and "species" not in got[3]
    _assert_same(got, want)
    _stats_match(port_pipe, ref_pipe)
    # a frame that is already a tensor on the device gives the same result
    again = port_pipe.process_detections(frame, _detections(),
                                         frame_dev=torch.from_numpy(frame))
    _assert_same(again, want)


def test_device_crops_branch_truncates_to_largest_bucket(classifiers):
    port_pipe, ref_pipe = _pipes(classifiers, device_crops=True)
    frame = _frame(2)
    rng = np.random.default_rng(0)
    dets = []
    for _ in range(19):                                  # more than bucket 16
        x1, y1 = rng.uniform(0, 300), rng.uniform(0, 200)
        dets.append(_det(14, "bird", (x1, y1, x1 + rng.uniform(40, 150),
                                      y1 + rng.uniform(40, 150))))
    got = port_pipe.process_detections(frame, copy.deepcopy(dets))
    want = ref_pipe.process_detections(frame, copy.deepcopy(dets))
    assert all("species" not in d for d in got[16:])
    _assert_same(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_host_crops_branch_matches_jax(classifiers, seed):
    pytest.importorskip("cv2")
    port_pipe, ref_pipe = _pipes(classifiers, device_crops=False)
    frame = _frame(seed)
    got = port_pipe.process_detections(frame, _detections())
    want = ref_pipe.process_detections(frame, _detections())
    assert sum("species" in d for d in got) >= 2
    _assert_same(got, want)
    _stats_match(port_pipe, ref_pipe)


class _Enhancer:
    def __init__(self):
        self.calls = 0

    def enhance(self, crop):
        self.calls += 1
        return np.ascontiguousarray(crop[:, ::-1])


def test_enhancer_forces_the_host_branch_and_caches(classifiers):
    pytest.importorskip("cv2")
    enh_port, enh_ref = _Enhancer(), _Enhancer()
    port_pipe, _ = _pipes(classifiers, device_crops=True, enhancer=enh_port)
    _, ref_pipe = _pipes(classifiers, device_crops=True, enhancer=enh_ref)
    frame = _frame(0)
    for _ in range(2):                                   # second pass hits
        got = port_pipe.process_detections(frame, _detections())
        want = ref_pipe.process_detections(frame, _detections())
        _assert_same(got, want)
    assert enh_port.calls == enh_ref.calls > 0
    assert port_pipe.cache.stats() == ref_pipe.cache.stats()
    assert port_pipe.cache.stats()["hits"] == enh_port.calls


def test_species_raw_branch_matches_jax(classifiers):
    """Fused-transport host logic: raw (ids, probs) attached to detections
    are formatted, re-ranked and filtered; an eligible detection without raw
    results is classified from a host crop."""
    pytest.importorskip("cv2")
    port_pipe, ref_pipe = _pipes(classifiers, device_crops=True)
    frame = _frame(1)

    def dets():
        out = _detections()
        out[0]["species_raw"] = (np.asarray([0, 1, 4, 2, 5]),
                                 np.asarray([0.55, 0.52, 0.2, 0.1, 0.01],
                                            np.float32))
        out[1]["species_raw"] = (np.asarray([3, 9, 7, 1, 0]),      # vague top
                                 np.asarray([0.45, 0.35, 0.33, 0.05, 0.01],
                                            np.float32))
        out[2]["species_raw"] = (np.asarray([1, 2, 3, 4, 5]),      # a car
                                 np.asarray([0.9, 0.01, 0.01, 0.01, 0.01],
                                            np.float32))
        out[3]["species_raw"] = (np.asarray([1, 2, 3, 4, 5]),      # too small
                                 np.asarray([0.9, 0.01, 0.01, 0.01, 0.01],
                                            np.float32))
        return out                                       # [4], [5]: leftovers

    got = port_pipe.process_detections(frame, dets())
    want = ref_pipe.process_detections(frame, dets())
    _assert_same(got, want)
    _stats_match(port_pipe, ref_pipe)
    assert all("species_raw" not in d for d in got)
    # det 0 at "day": the owl (0.55, nocturnal) is penalised below the hawk
    assert got[0]["species"] == "red-tailed hawk"
    assert got[0]["species_top_k"][1]["time_of_day_penalized"] is True
    # det 1: "order"-level labels are dropped, the barn owl (family band at
    # 0.33, "night") is what remains
    assert all(p["taxonomic_level"] not in port_two_stage.VAGUE_LEVELS
               for p in got[1]["species_top_k"])
    assert got[1]["taxonomic_level"] == "family"
    assert "species" not in got[2] and "species" not in got[3]
    assert "species" in got[4]                           # leftover, host crop

    # use_fused_raw=False: raw results are popped and ignored
    port_off, ref_off = _pipes(classifiers, device_crops=True,
                               use_fused_raw=False)
    got_off = port_off.process_detections(frame, dets())
    _assert_same(got_off, ref_off.process_detections(frame, dets()))
    assert all("species_raw" not in d for d in got_off)


class _FixedClassifier:
    """Duck-typed classifier with scripted predictions."""
    device = torch.device("cpu")

    def __init__(self, preds):
        self.preds = preds

    def classify_boxes_device(self, frames, boxes, n_valid, top_k=5):
        assert frames.ndim == 4 and boxes.shape[1] == 5
        return [copy.deepcopy(self.preds) for _ in range(n_valid)]

    def get_stats(self):
        return {}


def test_rerank_and_vague_levels_with_scripted_predictions():
    preds = [
        {"species_id": 1, "species_name": "Strigiformes",
         "taxonomic_level": "order", "confidence": 0.9},
        {"species_id": 2, "species_name": "great horned owl",
         "taxonomic_level": "species", "confidence": 0.6},
        {"species_id": 3, "species_name": "red-tailed hawk",
         "taxonomic_level": "species", "confidence": 0.5},
    ]
    results = []
    for mod in (port_two_stage, jax_two_stage):
        pipe = mod.TwoStageDetectionPipeline(
            _FixedClassifier(preds), device_crops=True, min_crop_size=10,
            time_of_day_penalty=0.5)
        frame = np.zeros((100, 100, 3), np.uint8)
        frame_dev = torch.from_numpy(frame) if mod is port_two_stage \
            else jnp.asarray(frame)
        results.append(pipe.process_detections(frame, [
            _det(14, "bird", (10, 10, 60, 60), time_of_day="day"),
            _det(14, "bird", (10, 10, 60, 60), time_of_day="night"),
            _det(14, "bird", (10, 10, 60, 60)),
        ], frame_dev=frame_dev))
    got, want = results
    _assert_same(got, want)
    assert got[0]["species"] == "red-tailed hawk"        # owl x 0.5 by day
    assert got[0]["species_top_k"][1]["confidence"] == pytest.approx(0.3)
    assert got[1]["species"] == "great horned owl"       # hawk x 0.5 by night
    assert got[2]["species"] == "great horned owl"       # no time of day
    assert all(p["taxonomic_level"] != "order"
               for d in got for p in d["species_top_k"])


def test_below_threshold_and_empty_inputs():
    low = [{"species_id": 1, "species_name": "verdin",
            "taxonomic_level": "species", "confidence": 0.2}]
    pipe = port_two_stage.TwoStageDetectionPipeline(
        _FixedClassifier(low), device_crops=True, min_crop_size=10)
    frame = np.zeros((64, 64, 3), np.uint8)
    out = pipe.process_detections(frame, [_det(14, "bird", (0, 0, 40, 40))])
    assert "species" not in out[0]                       # 0.2 < 0.3
    assert pipe.process_detections(frame, []) == []
    bare = port_two_stage.TwoStageDetectionPipeline(None)
    dets = [_det(14, "bird", (0, 0, 40, 40))]
    assert bare.process_detections(frame, dets) is dets
    bare.add_species_classifier(_FixedClassifier(low))
    assert bare.species_classifier is not None


@pytest.mark.parametrize("shape", [(40, 60, 3), (8, 8, 3), (123, 77, 3)])
def test_enhancement_cache_and_crop_key_equal(shape):
    crop = np.random.default_rng(sum(shape)).integers(0, 256, shape, np.uint8)
    assert port_two_stage.EnhancementCache.crop_key(crop) == \
        jax_two_stage.EnhancementCache.crop_key(crop)
    other = crop.copy()
    other[0, 0] ^= 0xFF
    assert port_two_stage.EnhancementCache.crop_key(other) != \
        port_two_stage.EnhancementCache.crop_key(crop)
    cache = port_two_stage.EnhancementCache(max_entries=2)
    for i in range(3):
        cache.put(str(i), crop)
    assert cache.get("0") is None and cache.get("2") is crop
    assert cache.stats() == {"entries": 2, "hits": 1, "misses": 1,
                             "hit_rate": 0.5}


def test_extract_crop_equal():
    frame = np.arange(100 * 120 * 3, dtype=np.uint32).reshape(100, 120, 3) \
        .astype(np.uint8)
    port_pipe = port_two_stage.TwoStageDetectionPipeline(crop_padding_percent=40)
    ref_pipe = jax_two_stage.TwoStageDetectionPipeline(crop_padding_percent=40)
    for box in ((40, 40, 60, 60), (0, 0, 30, 20), (100, 80, 120, 100),
                (60, 60, 40, 40), (50, 50, 50, 50)):
        bb = dict(zip(("x1", "y1", "x2", "y2"), box))
        got, want = port_pipe.extract_crop(frame, bb), ref_pipe.extract_crop(frame, bb)
        assert (got is None) == (want is None)
        if want is not None:
            np.testing.assert_array_equal(got, want)
    assert port_two_stage.VAGUE_LEVELS == jax_two_stage.VAGUE_LEVELS


def test_host_rerankers_equal():
    """pipeline/time_of_day.py and pipeline/activity.py are the port's own
    copies of host code; they stay equal to the JAX package's."""
    assert port_activity.SPECIES_ACTIVITY_PATTERNS.keys() == \
        jax_activity.SPECIES_ACTIVITY_PATTERNS.keys()
    names = list(jax_activity.SPECIES_ACTIVITY_PATTERNS) + [
        "Spotted Owl", "unknown beast", "", "Desert Kangaroo Rat", "night snake"]
    for name in names:
        got = port_activity.get_activity_pattern(name)
        want = jax_activity.get_activity_pattern(name)
        assert (got.value if got else None) == (want.value if want else None)
        for tod in ("dawn", "day", "dusk", "night", "noon"):
            assert port_activity.is_species_likely_active(name, tod) == \
                jax_activity.is_species_likely_active(name, tod)
    for hour in range(24):
        now = datetime(2024, 6, 1, hour, 30)
        assert port_tod.classify_time_of_day(now).value == \
            jax_tod.classify_time_of_day(now).value
    dets = [{"class_name": n, "confidence": 0.8}
            for n in ("bird", "owl", "coyote", "lizard", "person", "toaster")]
    for hard in (False, True):
        for hour in (3, 12, 19):
            now = datetime(2024, 6, 1, hour, 0)
            got = port_tod.TimeOfDayFilter(hard_filter=hard).filter_detections(
                copy.deepcopy(dets), now)
            want = jax_tod.TimeOfDayFilter(hard_filter=hard).filter_detections(
                copy.deepcopy(dets), now)
            assert got == want
