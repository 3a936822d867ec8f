"""Port SpeciesClassifier (telescope_cam_detection_tpu_torch/pipeline/species.py)
against the JAX classifier on the CPU: the shipped eva02-tiny weights
(weights/eva02_species.npz) and taxonomy in both, the same uint8 crops and
boxes.

The JAX classifier is built with ``param_dtype=jnp.float32`` (the port
serves fp32). Tolerance: the same species ids and names in the same order,
confidences within 1e-3 (softmax of logits that agree to 2e-4,
tests/test_torch_eva02.py; crop pixels that agree to 5e-3 of 255,
tests/test_torch_crops.py)."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from telescope_cam_detection_tpu.pipeline import species as jax_species
from telescope_cam_detection_tpu_torch.models.convert import (
    eva02_state_dict_from_flax,
    load_npz,
)
from telescope_cam_detection_tpu_torch.ops import cuda_attention
from telescope_cam_detection_tpu_torch.pipeline import species as port_species
from torch_port_utils import flax_tree_from_flat

REPO = Path(__file__).resolve().parent.parent
TAXONOMY = str(REPO / "weights" / "species_taxonomy.json")
CONF_TOL = 1e-3


@pytest.fixture(scope="module")
def classifiers():
    cfg = json.loads((REPO / "weights" / "eva02_species.json").read_text())
    flat = load_npz(REPO / "weights" / "eva02_species.npz")
    args = (cfg["variant"], cfg["num_classes"], cfg["input_size"])
    port = port_species.SpeciesClassifier(
        *args, taxonomy_file=TAXONOMY,
        state_dict=eva02_state_dict_from_flax(flat), device="cpu")
    ref = jax_species.SpeciesClassifier(
        *args, taxonomy_file=TAXONOMY, variables=flax_tree_from_flat(flat),
        param_dtype=jnp.float32, attn_impl="xla")
    return port, ref


def _crops(n, hw=(90, 76), seed=0):
    """Smooth coloured blobs over a gradient, one pattern per crop."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:hw[0], 0:hw[1]].astype(np.float32)
    out = []
    for _ in range(n):
        cy, cx = rng.uniform(20, 60, 2)
        blob = np.exp(-((y - cy) ** 2 + (x - cx) ** 2) / rng.uniform(100, 900))
        stripes = 0.5 + 0.5 * np.sin(x * rng.uniform(0.1, 0.9)
                                     + y * rng.uniform(0.0, 0.6))
        colour = rng.uniform(40, 255, 3)
        img = blob[..., None] * stripes[..., None] * colour \
            + (1 - blob[..., None]) * rng.uniform(20, 120, 3)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(out)


def _assert_predictions_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert [(p["species_id"], p["species_name"], p["taxonomic_level"])
                for p in g] == \
               [(p["species_id"], p["species_name"], p["taxonomic_level"])
                for p in w]
        np.testing.assert_allclose([p["confidence"] for p in g],
                                   [p["confidence"] for p in w],
                                   rtol=0, atol=CONF_TOL)


@pytest.mark.parametrize("n", [1, 3, 17])
def test_classify_batch_uniform_matches_jax(classifiers, n):
    """1 crop (bucket 1), 3 (padded to 4), 17 (two chunks of bucket 16)."""
    port, ref = classifiers
    crops = _crops(n, seed=n)
    before = (port.total_batches, port.total_classified, cuda_attention.LAUNCHES)
    got = port.classify_batch_uniform(crops, top_k=5)
    assert (port.total_batches, port.total_classified) == \
        (before[0] + 1, before[1] + n)
    assert cuda_attention.LAUNCHES == before[2]          # CPU: plain version
    want = ref.classify_batch_uniform(crops, top_k=5)
    assert any(g for g in got)                           # something survives
    _assert_predictions_match(got, want)


def test_classify_single_crop_matches_jax(classifiers):
    port, ref = classifiers
    crop = _crops(1, seed=9)[0]
    _assert_predictions_match([port.classify(crop, top_k=3)],
                              [ref.classify(crop, top_k=3)])


@pytest.mark.parametrize("n,k", [(1, 1), (3, 4), (16, 16)])
def test_classify_boxes_device_matches_jax(classifiers, n, k):
    port, ref = classifiers
    frames = np.stack([np.pad(c, ((30, 40), (50, 34), (0, 0)), mode="edge")
                       for c in _crops(2, seed=20 + n)])       # (2, 160, 160, 3)
    rng = np.random.default_rng(n)
    boxes = np.full((k, 5), -1.0, np.float32)
    x1, y1 = rng.uniform(0, 80, n), rng.uniform(0, 80, n)
    boxes[:n] = np.stack([rng.integers(0, 2, n), x1, y1,
                          x1 + rng.uniform(40, 80, n),
                          y1 + rng.uniform(40, 80, n)], -1)
    got = port.classify_boxes_device(torch.from_numpy(frames), boxes, n_valid=n)
    want = ref.classify_boxes_device(jnp.asarray(frames), boxes, n_valid=n)
    assert len(got) == n
    _assert_predictions_match(got, want)


def test_load_taxonomy_equal(tmp_path):
    as_dict = tmp_path / "t.json"
    as_dict.write_text(json.dumps({"0": {"common_name": "a"}, "7": "b"}))
    as_list = tmp_path / "l.json"
    as_list.write_text(json.dumps([{"name": "x"}, "y"]))
    as_text = tmp_path / "names.txt"
    as_text.write_text("coyote\n\n  bobcat \n")
    broken = tmp_path / "broken.json"
    broken.write_text("{not json")
    for path in (as_dict, as_list, as_text, broken, tmp_path / "missing.json",
                 Path(TAXONOMY)):
        assert port_species.load_taxonomy(str(path)) == \
            jax_species.load_taxonomy(str(path))
    assert port_species.load_taxonomy(str(as_text)) == \
        {"0": "coyote", "1": "bobcat"}
    assert len(port_species.load_taxonomy(TAXONOMY)) == 16


def test_hierarchical_label_equal(classifiers):
    port, ref = classifiers
    assert port_species.HIERARCHY_THRESHOLDS == jax_species.HIERARCHY_THRESHOLDS
    assert port_species.CROP_BATCH_BUCKETS == jax_species.CROP_BATCH_BUCKETS
    for cid in (0, 5, 15, 99):                           # 99: not in taxonomy
        for conf in (0.0, 0.19, 0.2, 0.29, 0.3, 0.39, 0.4, 0.49, 0.5, 0.97):
            assert port.get_hierarchical_label(cid, conf) == \
                ref.get_hierarchical_label(cid, conf)
    assert port.get_hierarchical_label(0, 0.45)[1] == "genus"
    assert port.get_hierarchical_label(0, 0.1) == (None, None)
    port.use_hierarchical = ref.use_hierarchical = False
    try:
        assert port.get_hierarchical_label(3, 0.01) == \
            ref.get_hierarchical_label(3, 0.01)
    finally:
        port.use_hierarchical = ref.use_hierarchical = True


def test_format_topk_and_geographic_filter_equal(classifiers):
    port, ref = classifiers
    probs = np.asarray([0.62, 0.41, 0.31, 0.25, 0.05, 0.01], np.float32)
    ids = np.asarray([3, 7, 1, 12, 0, 99])
    assert port.format_topk(probs, ids) == ref.format_topk(probs, ids)
    allowed = [ref.get_hierarchical_label(3, 0.62)[0]]
    for clf in (port, ref):
        clf.enable_geographic_filter = True
        clf.allowed_species = set(allowed)
    try:
        got, want = port.format_topk(probs, ids), ref.format_topk(probs, ids)
        assert got == want and [p["species_id"] for p in got] == [3]
    finally:
        for clf in (port, ref):
            clf.enable_geographic_filter = False
            clf.allowed_species = set()


def test_stats_and_buckets(classifiers):
    port, ref = classifiers
    assert set(port.get_stats()) == set(ref.get_stats())
    assert port.get_stats()["taxonomy_entries"] == 16
    assert [port_species.crop_bucket(n) for n in (0, 1, 2, 3, 5, 9, 16, 40)] \
        == [1, 1, 2, 4, 8, 16, 16, 16]


def test_small_head_clamps_topk_window():
    """Fewer classes than the device-side top-k window of 10."""
    clf = port_species.SpeciesClassifier("eva02-tiny", 4, 56, seed=1,
                                         device="cpu")
    clf.hierarchy_thresholds = dict.fromkeys(clf.hierarchy_thresholds, 0.0)
    preds = clf.classify(_crops(1)[0], top_k=5)
    assert len(preds) == 4
    assert abs(sum(p["confidence"] for p in preds) - 1.0) < 1e-5
    with pytest.raises(ValueError, match="frames on"):
        clf.classify_boxes_device(torch.zeros(1, 8, 8, 3, device="meta"),
                                  np.zeros((1, 5), np.float32), n_valid=1)
    with pytest.raises(ValueError, match="not yet ported"):
        port_species.SpeciesClassifier("eva02-tiny", 4, 56, quant="int8",
                                       device="cpu")
