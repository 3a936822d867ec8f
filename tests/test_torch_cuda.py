"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and the CUDA toolkit, carries the
``cuda`` marker, and skips elsewhere. This file imports no JAX, so it runs
on a GPU host without it (tests/conftest.py imports JAX, hence
``--noconftest``):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -m cuda
"""
import numpy as np
import pytest
import torch

from telescope_cam_detection_tpu_torch.ops import (
    cuda_attention,
    cuda_deform,
    cuda_nms,
)
from telescope_cam_detection_tpu_torch.ops.attention import attention_reference
from telescope_cam_detection_tpu_torch.ops.deform import (
    ms_deformable_attention_reference,
    split_levels,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _boxes(seed, b, k, img=640.0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, img, (b, k, 2))
    wh = rng.uniform(8, 120, (b, k, 2))
    return (torch.from_numpy(np.concatenate([c - wh / 2, c + wh / 2], -1)
                             .astype(np.float32)),
            torch.from_numpy(rng.uniform(size=(b, k)) < 0.8))


@pytest.mark.parametrize("b,k", [(8, 1000), (3, 777), (1, 64), (2, 65), (4, 1),
                                 (2, 63), (2, 2048), (1, 2300),
                                 (1, cuda_nms.MAX_K)])
def test_suppress_kernel_matches_plain(device, b, k):
    """K around the scan's 64-row chunks, past its 32-word window (2300) and
    at the largest K the wrapper takes. Past 2048 the boxes spread wider
    (chains stay short) and the plain version runs on the card (it is K^2
    on the host)."""
    boxes, valid = _boxes(k, b, k, img=640.0 * max(1.0, (k / 4000) ** 0.5))
    before = cuda_nms.LAUNCHES
    got = cuda_nms.suppress(boxes.to(device), valid.to(device), 0.45)
    assert cuda_nms.LAUNCHES == before + 1
    torch.cuda.synchronize()
    if k > 2048:
        want = cuda_nms.suppress_reference(boxes.to(device), valid.to(device),
                                           0.45)
        assert torch.equal(got, want)
    else:
        want = cuda_nms.suppress(boxes, valid, 0.45)    # CPU: plain version
        assert torch.equal(got.cpu(), want)


def test_suppress_kernel_refuses_bad_inputs(device):
    boxes, valid = _boxes(0, 2, 10)
    with pytest.raises(TypeError):
        cuda_nms.suppress(boxes.to(device).double(), valid.to(device))
    with pytest.raises(ValueError):
        cuda_nms.suppress(boxes.to(device).transpose(0, 1).contiguous()
                          .transpose(0, 1), valid.to(device))
    with pytest.raises(ValueError):
        cuda_nms.suppress(boxes.to(device), valid)
    k = cuda_nms.MAX_K + 1
    before = cuda_nms.LAUNCHES
    with pytest.raises(ValueError, match="largest"):
        cuda_nms.suppress(torch.zeros((1, k, 4), device=device),
                          torch.ones((1, k), dtype=torch.bool, device=device))
    assert cuda_nms.LAUNCHES == before


def _qkv(shape, dtype, device, seed=0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
            .to(device).to(dtype) for _ in range(3)]


@pytest.mark.parametrize("shape,dtype,tol", [
    ((16, 577, 16, 64), torch.float32, 2e-5),   # eva02-large@336, bucket 16
    ((16, 65, 3, 64), torch.float32, 2e-5),     # shipped eva02-tiny@112
    ((1, 128, 2, 64), torch.float32, 2e-5),
    ((1, 130, 1, 48), torch.float32, 2e-5),     # ragged T, D = 48
    ((2, 33, 2, 128), torch.float32, 2e-5),
    ((1, 1, 1, 16), torch.float32, 2e-5),
    ((3, 40, 2, 32), torch.float32, 2e-5),
    ((2, 577, 4, 64), torch.bfloat16, 2e-2),
    ((2, 33, 2, 128), torch.bfloat16, 2e-2),
] + [((2, t, 3, d), dtype, tol)
     for dtype, tol in ((torch.float32, 2e-5), (torch.bfloat16, 2e-2))
     for t in (1, 15, 16, 17, 63, 64, 65, 127, 129, 577)
     for d in (16, 32, 48, 64, 80, 96, 112, 128)])
def test_attention_kernel_matches_plain(device, shape, dtype, tol):
    """fp32 within 2e-5 (another order of summation), bf16 within 2e-2 (the
    output's rounding), the tolerances of tests/test_pallas_attention.py.
    The generated cases take every head dim in both types, with T around
    the 16-row mma fragments and the 64-row and 64-key tiles."""
    q, k, v = _qkv(shape, dtype, device, seed=shape[1])
    before = cuda_attention.LAUNCHES
    got = cuda_attention.attention(q, k, v)
    assert cuda_attention.LAUNCHES == before + 1
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == dtype and got.is_contiguous()
    torch.testing.assert_close(got, attention_reference(q, k, v),
                               rtol=tol, atol=tol)
    want_cpu = cuda_attention.attention(q.cpu(), k.cpu(), v.cpu())   # plain
    torch.testing.assert_close(got.cpu(), want_cpu, rtol=tol, atol=tol)


def test_attention_kernel_keeps_large_scores_finite(device):
    """Scores past 88 overflow exp() unless the running maximum is taken
    off. q and k are rounded to quarters so q.k is exact in any order."""
    q, k, v = _qkv((2, 577, 4, 64), torch.float32, device, seed=3)
    q, k = torch.round(q * 4) / 4 * 30.0, torch.round(k * 4) / 4
    got = cuda_attention.attention(q, k, v)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got, attention_reference(q, k, v),
                               rtol=2e-5, atol=2e-5)


def test_attention_kernel_refuses_bad_inputs(device):
    q, k, v = _qkv((2, 10, 2, 32), torch.float32, device)
    before = cuda_attention.LAUNCHES
    for d in (8, 24, 144):                       # unsupported head dims
        x = torch.zeros(1, 4, 1, d, device=device)
        with pytest.raises(ValueError, match="head dim"):
            cuda_attention.attention(x, x, x)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_attention.attention(q.transpose(1, 2).contiguous().transpose(1, 2),
                                 k, v)
    with pytest.raises(ValueError, match="CUDA device or on the CPU"):
        cuda_attention.attention(q, k.cpu(), v)
    with pytest.raises(TypeError):
        cuda_attention.attention(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(q.numel() + 1, device=device)
        off = flat[1:].view(q.shape)
        cuda_attention.attention(off, off, off)
    assert cuda_attention.LAUNCHES == before      # nothing fell through


def test_eva02_on_the_card_runs_the_kernel_in_every_block(device):
    from telescope_cam_detection_tpu_torch.models.eva02 import EVA02
    kw = dict(num_classes=17, depth=3, dim=64, heads=2, mlp_hidden=96,
              patch=14, image_size=56)
    torch.manual_seed(0)
    model = EVA02(**kw).eval()
    x = torch.randn(2, 56, 56, 3)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        want = model(x)                          # CPU: the plain version
        before = cuda_attention.LAUNCHES
        got = model.to(device)(x.to(device))
    assert cuda_attention.LAUNCHES == before + 3
    # fp32 end to end; sums in another order on the card
    torch.testing.assert_close(got.cpu(), want, rtol=2e-4, atol=2e-4)


def _deform_inputs(seed, b, q, heads, hd, level_hw, lo=0.0, hi=1.0, p=4):
    rng = np.random.default_rng(seed)
    s = sum(h * w for h, w in level_hw)
    values = torch.from_numpy(rng.normal(size=(b, s, heads, hd))
                              .astype(np.float32))
    locs = torch.from_numpy(rng.uniform(lo, hi, (b, q, heads, len(level_hw),
                                                  p, 2)).astype(np.float32))
    w = torch.softmax(torch.from_numpy(rng.normal(
        size=(b, q, heads, len(level_hw) * p)).astype(np.float32)), -1)
    return values, locs, w.reshape(b, q, heads, len(level_hw), p).contiguous()


RT_640 = [(80, 80), (40, 40), (20, 20)]


@pytest.mark.parametrize("b,q,heads,hd,level_hw,lo,hi", [
    (4, 300, 8, 32, RT_640, 0.0, 1.0),              # the decoder at 640²
    (2, 300, 8, 32, RT_640, -0.5, 1.5),             # outside [0, 1]
    (2, 30, 8, 32, [(24, 40), (12, 20), (6, 10)], 0.0, 1.0),   # H != W
    (2, 30, 4, 32, [(12, 16), (6, 8), (3, 4)], 0.05, 0.95),    # 4 heads
    (1, 7, 2, 32, [(5, 9), (3, 5), (2, 3)], -0.2, 1.2),        # odd levels
    (1, 5, 1, 32, [(4, 4), (1, 1), (1, 3)], -1.0, 2.0),        # 1-pixel rows
])
def test_deform_kernel_matches_plain(device, b, q, heads, hd, level_hw, lo, hi):
    """Within rtol 1e-4, atol 1e-5 of the plain version (the tolerance of
    tests/test_pallas_deform.py): the sum over levels and points runs in
    the same order, but the plain version's sum over points may not."""
    values, locs, w = _deform_inputs(q + hd, b, q, heads, hd, level_hw, lo, hi)
    want = cuda_deform.deform_sample(values, level_hw, locs, w)   # CPU: plain
    before = cuda_deform.LAUNCHES
    got = cuda_deform.deform_sample(values.to(device), level_hw,
                                    locs.to(device), w.to(device))
    assert cuda_deform.LAUNCHES == before + 1
    torch.cuda.synchronize()
    assert got.shape == (b, q, heads, hd) and got.dtype == torch.float32
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
    on_card = ms_deformable_attention_reference(
        split_levels(values.to(device), level_hw), locs.to(device),
        w.to(device))
    torch.testing.assert_close(got, on_card, rtol=1e-4, atol=1e-5)
    # the kernel keeps the plain version's order of arithmetic: bit-equal
    assert torch.equal(got.cpu(), want) and torch.equal(got, on_card)


@pytest.mark.parametrize("b,q,heads,level_hw", [
    (8, 300, 8, RT_640),        # the decoder at the auto path's B=8
    (1, 301, 8, RT_640),        # 2,408 items: a ragged last block of 16
    (3, 7, 2, [(5, 9), (3, 5), (2, 3)]),    # 42 items, ragged
])
def test_deform_kernel_bit_equal_at_decoder_shapes(device, b, q, heads,
                                                   level_hw):
    values, locs, w = _deform_inputs(b * q + heads, b, q, heads, 32, level_hw,
                                     -0.1, 1.1)
    want = cuda_deform.deform_sample(values, level_hw, locs, w)   # CPU: plain
    before = cuda_deform.LAUNCHES
    got = cuda_deform.deform_sample(values.to(device), level_hw,
                                    locs.to(device), w.to(device))
    torch.cuda.synchronize()
    assert cuda_deform.LAUNCHES == before + 1
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
    assert torch.equal(got.cpu(), want)


def test_deform_kernel_batch_zero(device):
    """B = 0 (and Q = 0) return an empty output and launch nothing."""
    before = cuda_deform.LAUNCHES
    for b, q in ((0, 300), (2, 0)):
        values, locs, w = (x.to(device) for x in _deform_inputs(
            0, b, q, 8, 32, RT_640))
        got = cuda_deform.deform_sample(values, RT_640, locs, w)
        assert got.shape == (b, q, 8, 32) and got.device.type == "cuda"
    assert cuda_deform.LAUNCHES == before


def test_deform_kernel_on_pixel_centres_and_edges(device):
    """Locations on multiples of half a pixel: loc * w - 0.5 must round as
    the plain version's does, or a corner index moves by one pixel."""
    level_hw = [(8, 10), (4, 5), (2, 3)]
    rng = np.random.default_rng(3)
    values, _, w = _deform_inputs(3, 2, 64, 4, 32, level_hw)
    locs = np.empty((2, 64, 4, 3, 4, 2), np.float32)
    for lvl, (h, wd) in enumerate(level_hw):
        for axis, n in ((0, wd), (1, h)):
            k = rng.integers(-2, 2 * n + 3, locs[:, :, :, lvl, :, axis].shape)
            locs[:, :, :, lvl, :, axis] = (k / (2.0 * n)).astype(np.float32)
    locs = torch.from_numpy(locs)
    want = cuda_deform.deform_sample(values, level_hw, locs, w)
    got = cuda_deform.deform_sample(values.to(device), level_hw,
                                    locs.to(device), w.to(device))
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
    assert torch.equal(got.cpu(), want)


def test_deform_kernel_refuses_bad_inputs(device):
    level_hw = [(4, 4), (2, 2), (1, 1)]
    values, locs, w = (x.to(device) for x in _deform_inputs(
        0, 1, 6, 2, 32, level_hw))
    before = cuda_deform.LAUNCHES
    with pytest.raises(TypeError):
        cuda_deform.deform_sample(values.double(), level_hw, locs, w)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_deform.deform_sample(values.transpose(1, 2).contiguous()
                                  .transpose(1, 2), level_hw, locs, w)
    with pytest.raises(ValueError, match="CUDA device or on the CPU"):
        cuda_deform.deform_sample(values, level_hw, locs.cpu(), w)
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(locs.numel() + 1, device=device)
        cuda_deform.deform_sample(values, level_hw,
                                  flat[1:].view(locs.shape), w)
    with pytest.raises(ValueError, match="16-byte aligned"):
        flat = torch.zeros(values.numel() + 2, device=device)
        cuda_deform.deform_sample(flat[2:].view(values.shape), level_hw,
                                  locs, w)
    # shapes the plain version takes but RT-DETR's kernel does not
    for hd, hw, p in ((16, level_hw, 4), (32, level_hw[:2], 4),
                      (32, level_hw, 2)):
        v, lo, wt = (x.to(device) for x in _deform_inputs(
            0, 1, 6, 2, hd, hw, p=p))
        with pytest.raises(ValueError, match="the kernel takes"):
            cuda_deform.deform_sample(v, hw, lo, wt)
    assert cuda_deform.LAUNCHES == before      # nothing fell through


def test_rtdetr_on_the_card_runs_the_kernel_in_every_decoder_layer(device):
    """The decoder from the same selected queries on the CPU (plain version)
    and on the card (K3, once per layer). Random torch weights leave the
    encoder scores nearly tied, so the selection itself is not compared."""
    from telescope_cam_detection_tpu_torch.models.rtdetr import RTDETR
    torch.manual_seed(0)
    model = RTDETR(num_classes=8, depths=(1, 1, 1, 1), decoder_layers=2,
                   num_queries=30).eval()
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        0, 1, (2, 128, 160, 3)).astype(np.float32))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with torch.inference_mode():
        levels = model.features(x)
        memory, level_hw, query, boxes = model.select_queries(levels)
        want = model.decode(memory, level_hw, query, boxes)
        model.to(device)
        for got, ref in zip(model.features(x.to(device)), levels):
            torch.testing.assert_close(got.cpu(), ref, rtol=2e-4, atol=2e-4)
        before = cuda_deform.LAUNCHES
        got = model.decode(memory.to(device), level_hw, query.to(device),
                           boxes.to(device))
    assert cuda_deform.LAUNCHES == before + 2
    # fp32 end to end; sums in another order on the card
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=2e-4, atol=2e-4)


def _rows_iou(a, b):
    lt = np.maximum(a[None, :2], b[:, :2])
    rb = np.minimum(a[None, 2:4], b[:, 2:4])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=-1)
    union = (np.prod(a[2:4] - a[:2]) + np.prod(b[:, 2:4] - b[:, :2], axis=-1)
             - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


def test_native_resize_feeds_the_cuda_program(device, monkeypatch):
    """transfer="auto" with 1440x2560 frames and no cv2: the port's native
    library resizes on the host, and the card's rows match the CPU
    program's (the shipped YOLOX-S, confident rows at IoU >= 0.99 with equal
    classes)."""
    import sys
    from pathlib import Path
    from telescope_cam_detection_tpu_torch.models.convert import (
        load_npz, yolox_state_dict_from_flax)
    from telescope_cam_detection_tpu_torch.runtime import program
    from telescope_cam_detection_tpu_torch.utils.frames import (
        SyntheticFrameSource)
    monkeypatch.setitem(sys.modules, "cv2", None)
    state = yolox_state_dict_from_flax(load_npz(
        Path(__file__).resolve().parent.parent / "weights"
        / "yolox_s_scene640.npz"))
    src = SyntheticFrameSource(width=2560, height=1440, seed=0, object_size=240)
    frames = np.stack([src.frame_at(40 * i) for i in range(2)])
    loose = program.FilterSettings(conf_threshold=0.0, wildlife_only=False)
    rows = {}
    for dev in ("cuda", "cpu"):
        prog = program.DetectorProgram(program.ProgramSpec(transfer="auto"),
                                       state_dict=state, device=dev)
        prog.update_filters(loose)
        rows[dev] = prog.detect_batch_rows(frames)
        assert prog.stats["host_resize"] == "native"
    matched = 0
    for got, want in zip(rows["cuda"], rows["cpu"]):
        got, want = got[got[:, 5] >= 0], want[want[:, 5] >= 0]
        for src_rows, dst in ((got, want), (want, got)):
            for row in src_rows[src_rows[:, 4] * src_rows[:, 5] >= 0.26]:
                same = dst[dst[:, 6] == row[6]]
                assert len(same), f"no partner for {row}"
                assert _rows_iou(row, same).max() >= 0.99
                matched += 1
    assert matched > 0
