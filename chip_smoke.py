#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero at once:

1. The card's name and power limit; build every CUDA kernel of the main path
   from the sources in this checkout (``nvcc``, sm_90a).
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes, with CUDA-event timings.
3. The main path: ``DetectorProgram`` serving weights/yolox_s_scene640.npz
   (YOLOX-S, full width and depth, 640x640 input, fp32, TF32 off) answers
   requests through ``detect_batch_rows`` (the rows behind ``detect_batch``);
   launch counts are read around it, and its rows are held against the same
   program run on the CPU.
4. Where a request's time goes: CUDA events between the program's stages,
   and the device's busy time from ``torch.profiler``.

The last two lines of standard output are the ``kernels`` JSON object and
``{"ok": true, "device": {...}}``. With no CUDA device, or without the port
package beside this file, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
WEIGHTS = REPO / "weights" / "yolox_s_scene640.npz"
INPUT_HW = (640, 640)
CAPTURE_HW = (1440, 2560)
REQUESTS = 5
# H100 SXM published peaks (NVIDIA data sheet): fp32 on the CUDA cores and
# HBM3 bandwidth, the roofline of bound_ms.
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES_PER_S = 3.35e12
IOU_PAIR_OPS = 15   # 2 max, 2 min, 2 sub, 2 clamp, mul, add, sub, div, cmp, 2 area


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(msg: str) -> None:
    print(msg, flush=True)


def cuda_time_ms(fn, iters: int, warmup: int = 5) -> float:
    """Mean device time of one call, CUDA events around ``iters`` calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def rows_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    lt = np.maximum(a[None, :2], b[:, :2])
    rb = np.minimum(a[None, 2:4], b[:, 2:4])
    inter = np.prod(np.clip(rb - lt, 0, None), axis=-1)
    union = (np.prod(a[2:4] - a[:2]) + np.prod(b[:, 2:4] - b[:, :2], axis=-1)
             - inter)
    return np.where(union > 0, inter / np.maximum(union, 1e-9), 0.0)


def match_rows(rows_a: np.ndarray, rows_b: np.ndarray, conf: float,
               margin: float = 0.01) -> int:
    """Rows above conf + margin in either set have a partner in the other at
    IoU >= 0.99 with the same class. Returns the number matched."""
    matched = 0
    for ra, rb in zip(rows_a, rows_b):
        ra, rb = ra[ra[:, 5] >= 0], rb[rb[:, 5] >= 0]
        for src, dst in ((ra, rb), (rb, ra)):
            for row in src:
                if row[4] * row[5] < conf + margin:
                    continue
                check(len(dst) > 0, "confident row without a partner")
                iou = rows_iou(row, dst)
                j = int(np.argmax(iou))
                check(iou[j] >= 0.99,
                      f"CUDA vs CPU rows: IoU {iou[j]:.4f} < 0.99 ({row})")
                check(int(row[6]) == int(dst[j, 6]),
                      f"CUDA vs CPU rows: class {int(row[6])} vs {int(dst[j, 6])}")
                matched += 1
    return matched


def phase_build(cuda_nms) -> float:
    t0 = time.perf_counter()
    path = cuda_nms.build()
    seconds = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in cuda_nms.BUILD_LOG.splitlines()
             if "registers" in ln or "smem" in ln]
    say(f"phase 1 build: {path.name} in {seconds:.2f} s")
    for ln in ptxas:
        say(f"  ptxas: {ln}")
    return seconds


def random_boxes(rng, b, k, img=640.0, lo=8.0, hi=120.0):
    import torch
    centers = rng.uniform(0, img, (b, k, 2))
    wh = rng.uniform(lo, hi, (b, k, 2))
    boxes = np.concatenate([centers - wh / 2, centers + wh / 2], -1)
    return torch.from_numpy(boxes.astype(np.float32))


def phase_kernel(cuda_nms, nms, model, frames_640, device):
    """K1 against its plain version on the card; keep masks must be equal."""
    import torch
    from telescope_cam_detection_tpu_torch.models.yolox import decode_outputs
    from telescope_cam_detection_tpu_torch.ops.preprocess import preprocess_yolox

    rng = np.random.default_rng(0)
    with torch.inference_mode():
        x = preprocess_yolox(torch.from_numpy(frames_640).to(device), INPUT_HW)
        boxes, obj, cls = decode_outputs(model(x))
        real = {}
        for conf in (0.0, 0.25):
            ob, valid, *_ = nms._prep_single(boxes, obj, cls, conf, 1000, False)
            real[conf] = (ob, valid)

    edge = random_boxes(rng, 1, 256).to(device)
    edge_iou = nms.iou_matrix(edge, edge)[0]
    mid = edge_iou[0][(edge_iou[0] > 0.2) & (edge_iou[0] < 0.8)]
    edge_thr = float(mid[0]) if len(mid) else 0.5
    exact = torch.tensor([[[0, 0, 2, 1], [0, 0, 1, 1], [0, 0, 2, 1]]],
                         dtype=torch.float32, device=device)
    cases = {
        "real decode B=8 K=1000 conf 0": (*real[0.0], 0.45),
        "real decode B=8 K=1000 conf 0.25": (*real[0.25], 0.45),
        "random B=8 K=1000": (random_boxes(rng, 8, 1000).to(device),
                              torch.from_numpy(rng.uniform(size=(8, 1000)) < 0.8
                                               ).to(device), 0.45),
        "random B=3 K=777": (random_boxes(rng, 3, 777).to(device),
                             torch.ones((3, 777), dtype=torch.bool,
                                        device=device), 0.45),
        "identical B=2 K=64": (torch.tensor([10.0, 10.0, 50.0, 50.0],
                                            device=device).repeat(2, 64, 1),
                               torch.ones((2, 64), dtype=torch.bool,
                                          device=device), 0.45),
        "all invalid B=2 K=1000": (random_boxes(rng, 2, 1000).to(device),
                                   torch.zeros((2, 1000), dtype=torch.bool,
                                               device=device), 0.45),
        "threshold edge, exact IoU 0.5": (exact, torch.ones(
            (1, 3), dtype=torch.bool, device=device), 0.5),
        f"threshold edge, thr = a pair's IoU {edge_thr!r}": (
            edge, torch.ones((1, 256), dtype=torch.bool, device=device),
            edge_thr),
    }
    max_err = 0
    for name, (b, v, thr) in cases.items():
        got = cuda_nms.suppress(b, v, thr)
        torch.cuda.synchronize()
        want = cuda_nms.suppress_reference(b, v, thr)
        want_cpu = cuda_nms.suppress(b.cpu(), v.cpu(), thr)
        err = int((got.int() - want.int()).abs().max())
        max_err = max(max_err, err)
        check(torch.equal(got, want), f"K1 keep mask differs from plain: {name}")
        check(torch.equal(got.cpu(), want_cpu),
              f"K1 keep mask differs from the CPU plain version: {name}")
        if name == "identical B=2 K=64":
            check(bool(got[:, 0].all()) and not bool(got[:, 1:].any()),
                  "identical boxes: only the first survives")
        if name.startswith("all invalid"):
            check(not bool(got.any()), "all-invalid: nothing kept")
        if name == "threshold edge, exact IoU 0.5":
            check(got.tolist() == [[True, True, False]], "IoU == thr is kept")
        say(f"phase 2 K1 {name}: equal, kept {int(got.sum())} of {v.numel()}")

    b, v = real[0.0]
    bsz, k = v.shape
    kernel_ms = cuda_time_ms(lambda: cuda_nms.suppress(b, v, 0.45), iters=200)
    plain_ms = cuda_time_ms(lambda: cuda_nms.suppress_reference(b, v, 0.45),
                            iters=20, warmup=2)
    pairs = bsz * k * (k - 1) / 2
    ops = pairs * IOU_PAIR_OPS
    nbytes = b.numel() * 4 + v.numel() + v.numel()
    ops_ms = ops / PEAK_FP32_FLOPS * 1e3
    bytes_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_ms = max(ops_ms, bytes_ms)
    say(f"phase 2 K1 timing B={bsz} K={k}: kernel_ms {kernel_ms:.5f} "
        f"plain_ms {plain_ms:.5f} bound_us {bound_ms * 1e3:.4f} "
        f"({'operations' if ops_ms >= bytes_ms else 'bytes'}: {ops:.3e} ops, "
        f"{nbytes} bytes) library_ms null")
    return {"name": "nms_suppress", "route": "cuda",
            "source": "telescope_cam_detection_tpu_torch/csrc/nms_suppress.cu",
            "replaces": "telescope_cam_detection_tpu/ops/pallas_nms.py:27",
            "launches": 0, "max_abs_err": float(max_err),
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "library_ms": None}


def synthetic(frames_src, n: int, first: int):
    return np.stack([frames_src.frame_at(first + 9 * i) for i in range(n)])


def check_rows(rows: np.ndarray, batch: int, hw) -> None:
    check(rows.shape == (batch, 300, 7), f"rows shape {rows.shape}")
    check(bool(np.isfinite(rows).all()), "non-finite rows")
    valid = rows[..., 5] >= 0
    v = rows[valid]
    check(bool((v[:, 2] >= v[:, 0]).all() and (v[:, 3] >= v[:, 1]).all()),
          "inverted boxes")
    v = v[v[:, 4] * v[:, 5] >= 0.25]    # low scores may regress off-frame
    cx, cy = (v[:, 0] + v[:, 2]) / 2, (v[:, 1] + v[:, 3]) / 2
    check(bool(((cx >= 0) & (cx <= hw[1]) & (cy >= 0) & (cy <= hw[0])).all()),
          f"confident box centres outside the {hw} capture frame")
    check(bool((rows[~valid] == -1).all()), "invalid rows are not all -1")


def phase_main_path(cuda_nms, program, state, frames_1440, frames_640, card):
    """Drive the port's main path; return (launches, programs)."""
    import torch
    spec_dev = program.ProgramSpec(transfer="device", input_hw=INPUT_HW)
    spec_auto = program.ProgramSpec(transfer="auto", input_hw=INPUT_HW)
    prog_dev = program.DetectorProgram(spec_dev, state_dict=state, device="cuda")
    prog_auto = program.DetectorProgram(spec_auto, state_dict=state,
                                        device="cuda")
    loose = program.FilterSettings(conf_threshold=0.0, wildlife_only=False)
    prog_auto.update_filters(loose)
    prog_dev.warm(len(frames_1440[0]), CAPTURE_HW)
    prog_auto.warm(len(frames_640[0]), INPUT_HW)
    torch.cuda.synchronize()

    results = {"device": [], "auto": []}
    dispatches = 0
    cuda_nms.LAUNCHES = 0
    for name, prog, sets in (("device", prog_dev, frames_1440),
                             ("auto", prog_auto, frames_640)):
        built = prog.stats["compilations"]
        for i in range(REQUESTS):
            frames = sets[max(i - 1, 0)] if name == "device" else sets[i]
            if name == "device" and i == 1:
                prog.update_filters(loose)   # between requests, no rebuild
            before = cuda_nms.LAUNCHES
            t0 = time.perf_counter()
            rows = prog.detect_batch_rows(frames)
            seconds = time.perf_counter() - t0
            dispatches += 1
            check(cuda_nms.LAUNCHES == before + 1,
                  f"K1 launches grew by {cuda_nms.LAUNCHES - before}, not 1")
            results[name].append((frames, rows, seconds))
        check(prog.stats["compilations"] == built,
              "update_filters or a request rebuilt a program")
    launches = cuda_nms.LAUNCHES

    check(launches == dispatches, f"{launches} K1 launches, {dispatches} dispatches")
    strict_rows, loose_rows = results["device"][0][1], results["device"][1][1]
    check(int((loose_rows[..., 5] >= 0).sum()) > int((strict_rows[..., 5] >= 0).sum()),
          "update_filters did not change the result")
    for name, hw in (("device", CAPTURE_HW), ("auto", INPUT_HW)):
        steady = results[name][1:]
        n_frames = sum(len(f) for f, _, _ in steady)
        fps = n_frames / sum(s for _, _, s in steady)
        for frames, rows, _ in results[name]:
            check_rows(rows, len(frames), hw)
        last = results[name][-1][1]
        per_frame = [len(program.rows_to_detections(r)) for r in last]
        confident = [int(n) for n in (last[..., 4] * last[..., 5] >= 0.25).sum(1)]
        say(f"phase 3 transfer={name} B={len(results[name][0][0])} capture "
            f"{hw[0]}x{hw[1]}: {REQUESTS} requests, detections per frame "
            f"{per_frame} ({confident} at score >= 0.25), {fps:.2f} frames/s "
            f"host clock incl. transfer and readback ({card})")
    say(f"phase 3 K1 launches in the main path: {launches} for {dispatches} "
        f"dispatches; update_filters changed rows "
        f"{int((strict_rows[..., 5] >= 0).sum())} -> "
        f"{int((loose_rows[..., 5] >= 0).sum())} valid without a rebuild")

    # the same frames through the same program on the CPU
    for name, spec, (frames, rows, _) in (
            ("device", spec_dev, results["device"][1]),
            ("auto", spec_auto, results["auto"][0])):
        cpu = program.DetectorProgram(spec, state_dict=state, device="cpu")
        cpu.update_filters(loose)
        want = cpu.detect_batch_rows(frames)
        matched = match_rows(rows, want, loose.conf_threshold)
        check(matched > 0, f"transfer={name}: no confident rows to compare")
        say(f"phase 3 transfer={name}: CUDA rows match the CPU program, "
            f"{matched} confident rows at IoU >= 0.99 with equal classes")
    return launches, prog_dev, prog_auto


def phase_breakdown(name, prog, frames, capture_hw, iters=20):
    """Device time of each stage of one request, CUDA events between the
    stages of ``DetectorProgram``'s core, run as the program runs them; the
    host clock around the same request gives the device's idle share."""
    import torch
    from telescope_cam_detection_tpu_torch.models.yolox import decode_outputs
    from telescope_cam_detection_tpu_torch.ops import cuda_nms, nms
    from telescope_cam_detection_tpu_torch.ops.preprocess import preprocess_yolox
    from telescope_cam_detection_tpu_torch.runtime.program import _filter_rows
    spec = prog.spec
    sy, sx = capture_hw[0] / INPUT_HW[0], capture_hw[1] / INPUT_HW[1]
    back = torch.tensor([sx, sy, sx, sy], device=prog.device)
    names = ("h2d", "preprocess", "forward", "decode", "nms_prep",
             "nms_suppress_K1", "nms_compact", "scale_filter", "readback")
    totals = dict.fromkeys(names, 0.0)
    wall = 0.0
    for it in range(iters + 2):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(len(names) + 1)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.inference_mode():
            ev[0].record()
            x = torch.from_numpy(frames).to(prog.device)
            ev[1].record()
            x = preprocess_yolox(x, spec.input_hw)
            ev[2].record()
            outs = prog.model(x)
            ev[3].record()
            boxes, obj, cls = decode_outputs(outs)
            ev[4].record()
            ob, valid, scores, idx, cconf, cid = nms._prep_single(
                boxes, obj, cls, 0.0, spec.pre_nms_topk, False)
            ev[5].record()
            keep = cuda_nms.suppress(ob, valid, spec.nms_threshold)
            ev[6].record()
            rows = nms._compact_single(keep, scores, idx, boxes, obj, cconf,
                                       cid, spec.max_det)
            ev[7].record()
            rows[..., :4] *= back
            rows = _filter_rows(rows, prog._filter_arrays)
            ev[8].record()
            rows.cpu()
            ev[9].record()
        torch.cuda.synchronize()
        if it < 2:          # warm-up
            continue
        wall += (time.perf_counter() - t0) * 1e3
        for i, n in enumerate(names):
            totals[n] += ev[i].elapsed_time(ev[i + 1])
    per = {n: t / iters for n, t in totals.items()}
    wall /= iters
    say(f"phase 4 stages transfer={name} B={len(frames)} capture "
        f"{capture_hw[0]}x{capture_hw[1]} (ms per request, CUDA events, each "
        f"span includes the launch gaps inside it): "
        + ", ".join(f"{n} {t:.4f}" for n, t in per.items())
        + f"; spans sum {sum(per.values()):.4f}, host wall {wall:.4f}")

    # device busy time of the program's own requests, from the profiler
    from torch.profiler import ProfilerActivity, profile
    reps = 5
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            prog.materialize(prog.dispatch_batch(frames), len(frames))
        torch.cuda.synchronize()
    # device-side rows only (kernels, copies): a CPU op's row repeats the
    # device time of the kernels it launched
    events = [e for e in prof.key_averages()
              if str(e.device_type).endswith("CUDA")]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    busy = sum(dev_us(e) for e in events) / reps / 1e3
    top = sorted(events, key=lambda e: -dev_us(e))[:8]
    say(f"phase 4 profile transfer={name}: device busy {busy:.4f} ms per "
        f"request, idle share {max(1.0 - busy / wall, 0.0):.3f} of the "
        f"unprofiled host wall; top: "
        + "; ".join(f"{e.key[:70]} {dev_us(e) / reps / 1e3:.4f}" for e in top))


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("CUDA is not available: this smoke run needs the card")
    try:
        from telescope_cam_detection_tpu_torch.models.convert import (
            load_npz, yolox_state_dict_from_flax)
        from telescope_cam_detection_tpu_torch.ops import cuda_nms, nms
        from telescope_cam_detection_tpu_torch.runtime import program
        from telescope_cam_detection_tpu_torch.utils.frames import (
            SyntheticFrameSource)
    except ImportError as e:
        raise SmokeFailure(f"the port package is not beside this script: {e}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    smi = smi.splitlines()[0]
    card = torch.cuda.get_device_name(0)
    say(f"phase 1 card: {smi}; torch {torch.__version__} cuda {torch.version.cuda}")
    phase_build(cuda_nms)

    state = yolox_state_dict_from_flax(load_npz(WEIGHTS))
    src_640 = SyntheticFrameSource(width=INPUT_HW[1], height=INPUT_HW[0], seed=1)
    src_1440 = SyntheticFrameSource(width=CAPTURE_HW[1], height=CAPTURE_HW[0],
                                    seed=0, object_size=240)
    frames_640 = [synthetic(src_640, 8, 40 * i) for i in range(REQUESTS)]
    frames_1440 = [synthetic(src_1440, 4, 40 * i) for i in range(REQUESTS)]

    device = torch.device("cuda")
    model = program.DetectorProgram(program.ProgramSpec(), state_dict=state,
                                    device=device).model
    kernel = phase_kernel(cuda_nms, nms, model, frames_640[0], device)
    del model
    kernel["launches"], prog_dev, prog_auto = phase_main_path(
        cuda_nms, program, state, frames_1440, frames_640, card)
    phase_breakdown("device", prog_dev, frames_1440[0], CAPTURE_HW)
    phase_breakdown("auto", prog_auto, frames_640[0], INPUT_HW)
    say(smi)
    say(json.dumps({"kernels": [kernel]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
