"""Port NMS (telescope_cam_detection_tpu_torch/ops/nms.py, ops/cuda_nms.py)
against the JAX package's NMS, on the CPU.

The same numpy inputs go through both. Keep masks and rows must be equal,
not close: the port's plain suppression repeats the JAX arithmetic op for op
in fp32, and the CUDA kernel is held bit-identical to that plain version on
the card (chip_smoke.py, tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from telescope_cam_detection_tpu.ops import nms as jax_nms
from telescope_cam_detection_tpu_torch.ops import cuda_nms
from telescope_cam_detection_tpu_torch.ops import nms as port_nms


def _problem(rng, k=64, img=256):
    """The case generator of tests/test_pallas_nms.py."""
    centers = rng.uniform(30, img - 30, size=(k, 2))
    wh = rng.uniform(10, 60, size=(k, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2],
                           axis=-1).astype(np.float32)
    scores = np.sort(rng.uniform(0, 1, k).astype(np.float32))[::-1]
    return boxes, scores


def _jax_keep(boxes, valid, thr=0.45):
    return np.asarray(jax_nms._greedy_suppress(
        jax_nms.iou_matrix(jnp.asarray(boxes), jnp.asarray(boxes)),
        jnp.asarray(valid), thr))


def _port_keep(boxes, valid, thr=0.45):
    return cuda_nms.suppress(torch.from_numpy(boxes), torch.from_numpy(valid),
                             thr).numpy()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plain_suppress_matches_jax_fixpoint(seed):
    rng = np.random.default_rng(seed)
    boxes, scores = _problem(rng)
    valid = scores > 0.2
    got = _port_keep(boxes[None], valid[None])[0]
    np.testing.assert_array_equal(got, _jax_keep(boxes, valid))


def test_plain_suppress_batched_and_padded():
    rng = np.random.default_rng(5)
    problems = [_problem(rng, k=50) for _ in range(3)]
    boxes = np.stack([p[0] for p in problems])
    valid = np.stack([p[1] > 0.1 for p in problems])
    got = _port_keep(boxes, valid)
    assert got.shape == (3, 50)
    for i in range(3):
        np.testing.assert_array_equal(got[i], _jax_keep(boxes[i], valid[i]))


def test_plain_suppress_identical_boxes():
    boxes = np.tile(np.array([[10, 10, 50, 50]], np.float32), (8, 1))[None]
    valid = np.ones((1, 8), bool)
    keep = _port_keep(boxes, valid)[0]
    assert keep[0] and not keep[1:].any()  # highest-ranked survives
    np.testing.assert_array_equal(keep, _jax_keep(boxes[0], valid[0]))


def test_plain_suppress_matches_pallas_interpret():
    """The Pallas kernel itself (interpret mode), one small case."""
    from telescope_cam_detection_tpu.ops.pallas_nms import pallas_suppress
    rng = np.random.default_rng(7)
    boxes, scores = _problem(rng, k=40)
    valid = scores > 0.15
    want = np.asarray(pallas_suppress(boxes[None], valid[None],
                                      iou_threshold=0.45, interpret=True))
    np.testing.assert_array_equal(_port_keep(boxes[None], valid[None]), want)


def test_plain_suppress_threshold_edge():
    """IoU exactly at the threshold does not suppress (strict >), in both."""
    boxes = np.array([[[0, 0, 2, 1], [0, 0, 1, 1], [0, 0, 2, 1]]], np.float32)
    valid = np.ones((1, 3), bool)
    got = _port_keep(boxes, valid, thr=0.5)[0]
    np.testing.assert_array_equal(got, [True, True, False])
    np.testing.assert_array_equal(got, _jax_keep(boxes[0], valid[0], 0.5))


def test_suppress_validates_inputs():
    boxes = torch.zeros((2, 5, 4))
    with pytest.raises(ValueError):
        cuda_nms.suppress(boxes, torch.zeros((2, 4), dtype=torch.bool))
    with pytest.raises(ValueError):
        cuda_nms.suppress(boxes.to("meta"),
                          torch.zeros((2, 5), dtype=torch.bool, device="meta"))


def _nms_inputs(seed, b=2, a=200, c=10, dup=False):
    rng = np.random.default_rng(seed)
    boxes = rng.uniform(0, 100, (b, a, 4)).astype(np.float32)
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(5, 40, (b, a, 2)).astype(
        np.float32)
    obj = rng.uniform(0, 1, (b, a)).astype(np.float32)
    cls = rng.dirichlet(np.ones(c), (b, a)).astype(np.float32)
    if dup:
        # saturated sigmoids: many scores exactly equal, so the top-k tie
        # order decides which anchors enter the pool and in what order
        obj[:, ::3] = 1.0
        cls[:, ::3] = 0.0
        cls[:, ::3, 2] = 1.0
    return boxes, obj, cls


@pytest.mark.parametrize("case", [
    dict(seed=5, conf=0.0, topk=128, max_det=32),
    dict(seed=6, conf=0.05, topk=1000, max_det=300),     # k = A = 200 < max_det
    dict(seed=7, conf=0.0, topk=64, max_det=100),        # max_det > k padding
    dict(seed=8, conf=0.0, topk=50, max_det=40, dup=True),
    dict(seed=9, conf=0.1, topk=128, max_det=32, agnostic=True),
])
def test_batched_nms_rows_match_jax(case):
    boxes, obj, cls = _nms_inputs(case["seed"], dup=case.get("dup", False))
    kw = dict(conf_threshold=case["conf"], iou_threshold=0.45,
              max_det=case["max_det"], pre_nms_topk=case["topk"],
              class_agnostic=case.get("agnostic", False))
    want = np.asarray(jax_nms.batched_nms(
        jnp.asarray(boxes), jnp.asarray(obj), jnp.asarray(cls), **kw))
    got = port_nms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(obj),
                               torch.from_numpy(cls), **kw).numpy()
    assert got.shape == want.shape == (2, case["max_det"], 7)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dup", [False, True])
def test_batched_nms_matches_numpy_reference(dup):
    """Rows equal the torchvision-ordered numpy oracle (all anchors enter
    the pool: pre_nms_topk >= A)."""
    boxes, obj, cls = _nms_inputs(11, a=150, dup=dup)
    got = port_nms.batched_nms(torch.from_numpy(boxes), torch.from_numpy(obj),
                               torch.from_numpy(cls), conf_threshold=0.1,
                               iou_threshold=0.45, max_det=60,
                               pre_nms_topk=150).numpy()
    for i in range(2):
        want = port_nms.nms_reference_numpy(boxes[i], obj[i], cls[i], 0.1,
                                            0.45, 60)
        np.testing.assert_array_equal(
            want, jax_nms.nms_reference_numpy(boxes[i], obj[i], cls[i], 0.1,
                                              0.45, 60))
        n = len(want)
        np.testing.assert_array_equal(got[i, :n], want)
        assert (got[i, n:] == -1.0).all()
