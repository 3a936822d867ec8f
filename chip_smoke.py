#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it ends; any failure exits non-zero at once:

1. The card's name and power limit; build every CUDA kernel of the main path
   from the sources in this checkout (``nvcc``, sm_90a, one process per
   source, started together).
2. Each kernel against its plain PyTorch version on the card, at the main
   path's shapes, with CUDA-event timings: K1 (NMS suppression), K2 (fused
   attention), then K3 (multi-scale deformable sampling, also timed beside
   the ``F.grid_sample`` composition that computes the same function).
3. The detector path: ``DetectorProgram`` serving weights/yolox_s_scene640.npz
   (YOLOX-S, full width and depth, 640x640 input, fp32, TF32 off) answers
   requests through ``detect_batch_rows`` (the rows behind ``detect_batch``);
   launch counts are read around it, and its rows are held against the same
   program run on the CPU.
4. Where a request's time goes: CUDA events between the program's stages,
   and the device's busy time from ``torch.profiler``.
5. The two-stage path with the shipped weights: the detector's rows ->
   ``rows_to_detections`` -> ``TwoStageDetectionPipeline(device_crops=True)``
   over a ``SpeciesClassifier`` serving weights/eva02_species.npz
   (eva02-tiny, 112x112, 16 classes); launch counts are read around it, and
   its species are held against the same pipeline run on the CPU.
6. The classifier at its full published width: eva02-large, 336x336, 10,000
   classes, depth 24, fp32, random weights from a fixed seed, through
   ``SpeciesClassifier.classify_boxes_device``; launch counts, logits with
   the kernel against logits with its plain version, a per-stage split and
   the device's idle share.
7. The RT-DETR path: ``DetectorProgram(detector_type="rtdetr")`` serving
   weights/rtdetrv2_r18vd_scene640.npz (RT-DETRv2-r18vd, full width and
   depth, 640x640, fp32, TF32 off) answers requests; K3 launches are counted
   per dispatch (one per decoder layer) and its rows are held against the
   same program run on the CPU.
8. Where an RT-DETR request's time goes: CUDA events between its stages
   (K3 apart from the rest of the decoder) and the device's idle share.

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
EVA_WEIGHTS = REPO / "weights" / "eva02_species.npz"
RT_WEIGHTS = REPO / "weights" / "rtdetrv2_r18vd_scene640.npz"
RT_CONFIG = REPO / "weights" / "rtdetrv2_r18vd_scene640.json"
RT_CONF = 0.25      # rows compared across devices: the served threshold
EVA_CONFIG = REPO / "weights" / "eva02_species.json"
TAXONOMY = REPO / "weights" / "species_taxonomy.json"
INPUT_HW = (640, 640)
CAPTURE_HW = (1440, 2560)
REQUESTS = 5
# H100 SXM published peaks (NVIDIA data sheet): fp32 on the CUDA cores, bf16
# on the tensor cores (dense) and HBM3 bandwidth, the roofline of bound_ms.
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_FLOPS = 989e12
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
    """Rows above conf + margin in either set have a partner of the same
    class in the other at IoU >= 0.99. Partners are sought within the class:
    an RT-DETR box stands in one row per class it scores. Returns the number
    matched."""
    matched = 0
    for ra, rb in zip(rows_a, rows_b):
        ra, rb = ra[ra[:, 5] >= 0], rb[rb[:, 5] >= 0]
        for src, dst in ((ra, rb), (rb, ra)):
            for row in src:
                if row[4] * row[5] < conf + margin:
                    continue
                same = dst[dst[:, 6] == row[6]]
                check(len(same) > 0, f"CUDA vs CPU rows: no partner of class "
                      f"{int(row[6])} ({row})")
                iou = rows_iou(row, same)
                j = int(np.argmax(iou))
                check(iou[j] >= 0.99,
                      f"CUDA vs CPU rows: IoU {iou[j]:.4f} < 0.99 ({row})")
                matched += 1
    return matched


def phase_build(modules) -> None:
    """Build every kernel library, one nvcc per source, all started together.
    ``modules``: (label, binding module, substring that picks the ptxas
    lines to print, or None for all)."""
    import threading
    t0 = time.perf_counter()
    paths, errors = {}, []

    def build(label, mod):
        try:
            paths[label] = mod.LIBRARY.build()
        except Exception as e:        # reported below, fails the run
            errors.append(f"{label}: {e}")

    threads = [threading.Thread(target=build, args=(label, mod))
               for label, mod, _ in modules]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    check(not errors, "kernel build failed: " + "; ".join(errors))
    seconds = time.perf_counter() - t0
    for label, mod, pick in modules:
        say(f"phase 1 build {label}: {paths[label].name} "
            f"(all builds {seconds:.2f} s, in parallel)")
        wanted, entry = True, ""
        for ln in mod.LIBRARY.log.splitlines():
            if "Compiling entry function" in ln:
                wanted = pick is None or pick in ln
                entry = ln.split("'")[1] if "'" in ln else ln
            elif wanted and ("registers" in ln or "spill" in ln):
                say(f"  ptxas {label}: {ln.strip().replace('ptxas info    : ', '')}")
            elif "spill" in ln and " 0 bytes spill stores, 0 bytes spill loads" not in ln:
                say(f"  ptxas {label}: SPILLS in {entry}: {ln.strip()}")


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
    kernel_ms = cuda_time_ms(lambda: cuda_nms.suppress(b, v, 0.45), iters=100)
    plain_ms = cuda_time_ms(lambda: cuda_nms.suppress_reference(b, v, 0.45),
                            iters=10, warmup=2)
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


def phase_breakdown(name, prog, frames, capture_hw, iters=10):
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

    busy, top = profile_busy(
        lambda: prog.materialize(prog.dispatch_batch(frames), len(frames)), 5)
    say(f"phase 4 profile transfer={name}: device busy {busy:.4f} ms per "
        f"request, idle share {max(1.0 - busy / wall, 0.0):.3f} of the "
        f"unprofiled host wall; top: " + top)


def _profile(fn, reps: int):
    """(device rows of ``torch.profiler``'s key averages over ``reps`` calls
    of ``fn``, the host's ms per call without a sync). Device rows only: a
    CPU op's row repeats the device time of the kernels it launched."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3 / reps
        torch.cuda.synchronize()
    return ([e for e in prof.key_averages()
             if str(e.device_type).endswith("CUDA")], host_ms)


def _device_us(e) -> float:
    return getattr(e, "self_device_time_total",
                   getattr(e, "self_cuda_time_total", 0.0))


def profile_busy(fn, reps: int):
    """Device busy ms per call of ``fn`` from ``torch.profiler``, and the
    eight device rows (kernels, copies) that take most of it."""
    events, _ = _profile(fn, reps)
    busy = sum(_device_us(e) for e in events) / reps / 1e3
    top = sorted(events, key=lambda e: -_device_us(e))[:8]
    return busy, "; ".join(f"{e.key[:70]} {_device_us(e) / reps / 1e3:.4f}"
                           for e in top)


def device_ms(fn, reps: int, kernel: str = "", warmup: int = 5):
    """(device ms per call of ``fn`` in the kernels whose name holds
    ``kernel``, or in every device row; the host's ms per call). Unlike CUDA
    events around a loop, the device time leaves out the gaps in which the
    card waits for the host to launch the next call."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events, host_ms = _profile(fn, reps)
    rows = [e for e in events if kernel in e.key]
    if kernel:
        launched = sum(e.count for e in rows)
        check(launched == reps, f"the profiler saw {launched} {kernel} "
              f"launches in {reps} calls")
    return sum(_device_us(e) for e in rows) / reps / 1e3, host_ms


def attention_inputs(shape, dtype, device, seed=0, q_scale=1.0):
    """Seeded normal q, k, v. With q_scale != 1, q and k are rounded to
    quarters first: every product and partial sum of q.k is then exact in
    fp32, so the scores are the same in any order of summation and the case
    tests the softmax alone."""
    import torch
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(0, 1, shape).astype(np.float32))
               for _ in range(3))
    if q_scale != 1.0:
        q, k = torch.round(q * 4) / 4 * q_scale, torch.round(k * 4) / 4
    return tuple(x.to(device).to(dtype) for x in (q, k, v))


def attention_bound(shape, dtype):
    """(bound_ms, bound_by, operations, bytes): 4 B H T^2 D operations at the
    card's peak for the type, 4 B H T D elements moved at its memory rate."""
    import torch
    b, t, h, d = shape
    ops = 4.0 * b * h * t * t * d
    itemsize = 2 if dtype == torch.bfloat16 else 4
    nbytes = 4.0 * b * h * t * d * itemsize
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_FP32_FLOPS
    ops_ms, bytes_ms = ops / peak * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", ops, nbytes)


def phase_attention(cuda_attention, tiny_clf, device):
    """K2 against its plain version on the card: fp32 within 2e-5, bf16
    within 2e-2 (rtol = atol), then its timings beside the bound."""
    import torch
    import torch.nn.functional as F
    from telescope_cam_detection_tpu_torch.ops.attention import (
        attention_reference)
    from telescope_cam_detection_tpu_torch.ops.preprocess import (
        preprocess_classifier)
    f32, bf16 = torch.float32, torch.bfloat16
    cases = [
        ("eva02-large@336, crop bucket 16", (16, 577, 16, 64), f32, 1.0),
        ("eva02-tiny@112, crop bucket 16", (16, 65, 3, 64), f32, 1.0),
        ("one key tile multiple", (1, 128, 2, 64), f32, 1.0),
        ("ragged T, D=48", (1, 130, 1, 48), f32, 1.0),
        ("D=128", (2, 33, 2, 128), f32, 1.0),
        ("single token, D=16", (1, 1, 1, 16), f32, 1.0),
        ("bf16", (2, 577, 4, 64), bf16, 1.0),
        ("bf16 eva02-large@336, crop bucket 16", (16, 577, 16, 64), bf16, 1.0),
        # q x 30 puts scores past 88, where exp() overflows fp32 unless the
        # running maximum is subtracted. q and k are rounded to quarters so
        # that q.k is exact: at scores of a hundred and more, one fp32
        # rounding of q.k alone moves a softmax weight by more than 2e-5,
        # whatever the order of summation.
        ("scores x 30", (2, 577, 4, 64), f32, 30.0),
    ]
    inputs = [(name, attention_inputs(shape, dtype, device, seed=i, q_scale=qs))
              for i, (name, shape, dtype, qs) in enumerate(cases)]
    # q, k, v of real blocks of the shipped classifier on a noise crop batch
    rng = np.random.default_rng(11)
    crops = torch.from_numpy(rng.integers(0, 256, (16, 96, 80, 3), np.uint8))
    model = tiny_clf.model
    with torch.inference_mode():
        x = model.embed(preprocess_classifier(
            crops.to(device), (tiny_clf.input_size,) * 2))
        for i, block in enumerate(model.blocks()):
            qkv = block.qkv(x, model.rope_cos, model.rope_sin)
            if i in (0, model.depth - 1):
                inputs.append((f"shipped eva02-tiny block {i}", qkv))
            x = block.finish(x, cuda_attention.attention(*qkv))

    max_err = {f32: 0.0, bf16: 0.0}
    for name, (q, k, v) in inputs:
        tol = 2e-5 if q.dtype == f32 else 2e-2
        before = cuda_attention.LAUNCHES
        got = cuda_attention.attention(q, k, v)
        torch.cuda.synchronize()
        check(cuda_attention.LAUNCHES == before + 1, "K2 launch not counted")
        want = attention_reference(q, k, v)
        check(got.shape == q.shape and got.dtype == q.dtype,
              f"K2 output {tuple(got.shape)} {got.dtype}: {name}")
        check(bool(torch.isfinite(got.float()).all()), f"K2 non-finite: {name}")
        if name.startswith("scores"):
            top = float((q.float().permute(0, 2, 1, 3)
                         @ k.float().permute(0, 2, 3, 1)).max()) / 8.0
            check(top > 88.0, f"scores x 30 peak at {top:.1f}, not past 88")
        err = float((got.float() - want.float()).abs().max())
        max_err[q.dtype] = max(max_err[q.dtype], err)
        try:
            torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        except AssertionError as e:
            raise SmokeFailure(f"K2 differs from its plain version: {name}: {e}")
        note = ""
        if name.startswith("eva02-tiny"):
            want_cpu = cuda_attention.attention(q.cpu(), k.cpu(), v.cpu())
            try:
                torch.testing.assert_close(got.cpu(), want_cpu, rtol=tol, atol=tol)
            except AssertionError as e:
                raise SmokeFailure(f"K2 differs from the CPU plain version: {e}")
            note = ", also equal to the CPU plain version"
        say(f"phase 2 K2 {name} {tuple(q.shape)} {str(q.dtype)[6:]}: within "
            f"{tol:g} of plain, max abs err {err:.3e}{note}")

    timings = []
    for shape in ((16, 577, 16, 64), (16, 65, 3, 64)):
        for dtype in (f32, bf16):
            q, k, v = attention_inputs(shape, dtype, device, seed=5)
            qh, kh, vh = (x.permute(0, 2, 1, 3) for x in (q, k, v))
            kernel_ms = cuda_time_ms(
                lambda: cuda_attention.attention(q, k, v), iters=20, warmup=3)
            plain_ms = cuda_time_ms(
                lambda: attention_reference(q, k, v), iters=5, warmup=2)
            library_ms = cuda_time_ms(
                lambda: F.scaled_dot_product_attention(qh, kh, vh),
                iters=20, warmup=3)
            bound_ms, bound_by, ops, nbytes = attention_bound(shape, dtype)
            timings.append({"shape": list(shape), "dtype": str(dtype)[6:],
                            "ms": kernel_ms, "plain_ms": plain_ms,
                            "library_ms": library_ms, "bound_ms": bound_ms,
                            "bound_by": bound_by})
            say(f"phase 2 K2 timing {shape} {str(dtype)[6:]}: kernel_ms "
                f"{kernel_ms:.5f} plain_ms {plain_ms:.5f} library_ms "
                f"{library_ms:.5f} (F.scaled_dot_product_attention) bound_ms "
                f"{bound_ms:.5f} ({bound_by}: {ops:.3e} ops, {nbytes:.3e} "
                f"bytes), {ops / kernel_ms / 1e9:.2f} TFLOP/s")
    main = timings[0]    # eva02-large@336, crop bucket 16, fp32: the widest
    return {"name": "attention", "route": "cuda",
            "source": "telescope_cam_detection_tpu_torch/csrc/attention.cu",
            "replaces": "telescope_cam_detection_tpu/ops/pallas_attention.py:33",
            "launches": 0, "max_abs_err": max_err[f32],
            "max_abs_err_bf16": max_err[bf16],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"], "shape": main["shape"],
            "dtype": main["dtype"], "other_shapes": timings[1:]}


def fixed_boxes(n, k, n_frames, hw, seed=7):
    """n seeded boxes [frame, x1, y1, x2, y2] in (k, 5), padding rows -1."""
    rng = np.random.default_rng(seed)
    boxes = np.full((k, 5), -1.0, np.float32)
    side = rng.uniform(120, 420, (n, 2))
    x1 = rng.uniform(0, hw[1] - side[:, 0])
    y1 = rng.uniform(0, hw[0] - side[:, 1])
    boxes[:n] = np.stack([rng.integers(0, n_frames, n), x1, y1,
                          x1 + side[:, 0], y1 + side[:, 1]], -1)
    return boxes


def check_topk(name, got, want, n):
    """Raw (top_p, top_i) of the card against another run of the same crops:
    probabilities within 1e-3, top-1 ids equal (where the top two are more
    than 2e-3 apart: closer than that, either order is right)."""
    gp, gi = (x[:n].cpu().numpy() for x in got)
    wp, wi = (x[:n].cpu().numpy() for x in want)
    check(bool(np.isfinite(gp).all()) and gp.shape == wp.shape,
          f"{name}: top-k shape {gp.shape} or non-finite")
    err = float(np.abs(gp - wp).max())
    check(err <= 1e-3, f"{name}: probabilities differ by {err:.2e} > 1e-3")
    clear = (wp[:, 0] - wp[:, 1]) > 2e-3
    check(bool((gi[clear, 0] == wi[clear, 0]).all()),
          f"{name}: top-1 ids differ: {gi[:, 0]} vs {wi[:, 0]}")
    return err, int(clear.sum())


_LABEL_EDGES = (0.5, 0.4, 0.3, 0.2)    # hierarchy and pipeline thresholds


def compare_annotations(got, want):
    """Detections annotated on the card against the same ones annotated on
    the CPU. A detection whose CPU confidences sit within 1e-3 of a label
    threshold may fall either way and is skipped. Returns (compared,
    classified)."""
    compared = classified = 0
    for g, w in zip(got, want):
        raw = [p["confidence"] for p in w.get("species_top_k", [])]
        if any(abs(c - e) < 1e-3 for c in raw for e in _LABEL_EDGES):
            continue
        check(("species" in g) == ("species" in w),
              f"annotated on one device only: {g} vs {w}")
        compared += 1
        if "species" not in w:
            continue
        classified += 1
        check(g["species"] == w["species"]
              and g["taxonomic_level"] == w["taxonomic_level"],
              f"species {g['species']} vs {w['species']}")
        check(abs(g["species_confidence"] - w["species_confidence"]) <= 1e-3,
              "species confidence differs by more than 1e-3")
        check([p["species_id"] for p in g["species_top_k"]][:1]
              == [p["species_id"] for p in w["species_top_k"]][:1],
              "top-1 species id differs")
    return compared, classified


def phase_two_stage(tiny_clf, eva_state, eva_cfg, prog_dev, frames_1440, card):
    """The two-stage path with the shipped weights. Returns the launches of
    (K1, K2) on it."""
    import copy
    import torch
    from telescope_cam_detection_tpu_torch.ops import cuda_attention, cuda_nms
    from telescope_cam_detection_tpu_torch.pipeline import species, two_stage
    from telescope_cam_detection_tpu_torch.runtime import program
    depth = tiny_clf.model.depth
    pipe = two_stage.TwoStageDetectionPipeline(
        tiny_clf, device_crops=True, crop_batch_size_hw=tiny_clf.input_size)
    clf_cpu = species.SpeciesClassifier(
        eva_cfg["variant"], eva_cfg["num_classes"], eva_cfg["input_size"],
        taxonomy_file=str(TAXONOMY), state_dict=eva_state, device="cpu")
    pipe_cpu = two_stage.TwoStageDetectionPipeline(
        clf_cpu, device_crops=True, crop_batch_size_hw=clf_cpu.input_size)
    served = program.FilterSettings()
    loose = program.FilterSettings(conf_threshold=0.0, wildlife_only=False)
    # warm every crop bucket once (first-call algorithm selection)
    frames_dev = torch.from_numpy(frames_1440[0]).to(tiny_clf.device)
    for k in species.CROP_BATCH_BUCKETS:
        tiny_clf.classify_boxes_device(
            frames_dev, fixed_boxes(k, k, 4, CAPTURE_HW), n_valid=k)
    torch.cuda.synchronize()

    records, buckets = [], []
    detect_s = stage2_s = 0.0
    cuda_nms.LAUNCHES = cuda_attention.LAUNCHES = 0
    batches0 = tiny_clf.total_batches
    for i, filt in enumerate((served, served, loose)):
        prog_dev.update_filters(filt)
        frames = frames_1440[i]
        t0 = time.perf_counter()
        rows = prog_dev.detect_batch_rows(frames)
        detect_s += time.perf_counter() - t0
        for frame, r in zip(frames, rows):
            dets = program.rows_to_detections(r)
            twin = copy.deepcopy(dets)
            before = (tiny_clf.total_batches, cuda_attention.LAUNCHES)
            t0 = time.perf_counter()
            out = pipe.process_detections(frame, dets)
            stage2_s += time.perf_counter() - t0
            n_disp = tiny_clf.total_batches - before[0]
            check(cuda_attention.LAUNCHES - before[1] == depth * n_disp,
                  f"K2 launches grew by {cuda_attention.LAUNCHES - before[1]}"
                  f", not {depth} x {n_disp} dispatches")
            if n_disp:
                buckets.append(species.crop_bucket(sum(
                    1 for d in twin if d["class_id"] in pipe.classify_classes
                    and min(d["bbox"]["width"], d["bbox"]["height"])
                    >= pipe.min_crop_size)))
            records.append((frame, twin, out))
    k1, k2 = cuda_nms.LAUNCHES, cuda_attention.LAUNCHES
    dispatches = tiny_clf.total_batches - batches0
    prog_dev.update_filters(loose)
    check(k1 == 3, f"{k1} K1 launches for 3 detector dispatches")
    check(dispatches > 0 and k2 == depth * dispatches,
          f"{k2} K2 launches, {dispatches} classify dispatches x {depth} blocks")
    n_class = sum(1 for _, _, out in records for d in out if "species" in d)
    check(n_class > 0, "no crop was classified on the two-stage path")
    n_frames = len(records)
    say(f"phase 5 two-stage, shipped weights ({eva_cfg['variant']}@"
        f"{eva_cfg['input_size']}, {eva_cfg['num_classes']} classes): "
        f"{n_frames} frames at {CAPTURE_HW[0]}x{CAPTURE_HW[1]}, "
        f"{sum(len(o) for _, _, o in records)} detections, {dispatches} "
        f"classify dispatches at crop buckets {sorted(set(buckets))}, "
        f"{n_class} detections given a species; K1 launches {k1}, K2 "
        f"launches {k2} = {depth} x {dispatches}; detector "
        f"{detect_s * 1e3 / 3:.3f} ms per request of 4 frames, Stage-2 "
        f"{stage2_s * 1e3 / max(dispatches, 1):.3f} ms per classify dispatch "
        f"incl. the frame upload, host clock ({card})")

    compared = classified = 0
    for frame, twin, out in records:
        want = pipe_cpu.process_detections(frame, twin)
        c, n = compare_annotations(out, want)
        compared, classified = compared + c, classified + n
    check(classified > 0, "no classified detection to compare with the CPU")
    say(f"phase 5 two-stage: the card's annotations match the CPU pipeline, "
        f"{compared} detections compared, {classified} with equal species, "
        f"level and top-1 id and confidence within 1e-3")

    # a direct call with fixed boxes, whatever Stage-1 found
    boxes = fixed_boxes(13, 16, 4, CAPTURE_HW)
    before = cuda_attention.LAUNCHES
    preds = tiny_clf.classify_boxes_device(frames_dev, boxes, n_valid=13)
    check(cuda_attention.LAUNCHES - before == depth and len(preds) == 13,
          "direct classify_boxes_device: launches or result count")
    got = tiny_clf._device_crop_program(
        frames_dev, torch.from_numpy(boxes).to(tiny_clf.device))
    want = clf_cpu._device_crop_program(
        torch.from_numpy(frames_1440[0]), torch.from_numpy(boxes))
    err, clear = check_topk("direct classify_boxes_device", got, want, 13)
    say(f"phase 5 direct classify_boxes_device, 13 fixed boxes in bucket 16: "
        f"{depth} K2 launches, top-10 probabilities within {err:.2e} of the "
        f"CPU run, top-1 ids equal on {clear} of 13 (the rest tie within 2e-3)")
    # where a dispatch of the shipped classifier goes, frames already on the card
    reps = 10
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        tiny_clf.classify_boxes_device(frames_dev, boxes, n_valid=13)
    wall = (time.perf_counter() - t0) * 1e3 / reps
    stages = classifier_stages(tiny_clf, frames_dev, boxes, iters=5)
    say(f"phase 5 stages crop bucket 16, frames on the card: {wall:.3f} ms per "
        f"dispatch (host clock); CUDA events, each span includes its launch "
        f"gaps: " + ", ".join(f"{n} {t:.4f}" for n, t in stages.items())
        + f"; spans sum {sum(stages.values()):.4f}")
    return k1, k2


def classifier_stages(clf, frames_dev, boxes, iters):
    """Device ms per stage of one ``classify_boxes_device`` dispatch, CUDA
    events between the stages run as ``_device_crop_program`` runs them."""
    import torch
    from telescope_cam_detection_tpu_torch.ops import cuda_attention
    from telescope_cam_detection_tpu_torch.ops.crops import sample_crops
    from telescope_cam_detection_tpu_torch.ops.nms import _stable_topk
    from telescope_cam_detection_tpu_torch.ops.preprocess import normalize_rgb
    model, size = clf.model, clf.input_size
    names = ("crops_normalise", "patch_embed", "blocks_before_K2",
             "attention_K2", "blocks_after_K2", "head_topk", "readback")
    totals = dict.fromkeys(names, 0.0)
    boxes_dev = torch.from_numpy(boxes).to(clf.device)

    def mark(spans, name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        spans.append((name, ev))

    for it in range(iters + 1):
        spans = []
        torch.cuda.synchronize()
        with torch.inference_mode():
            mark(spans, None)
            crops = sample_crops(frames_dev, boxes_dev, (size, size))
            x = normalize_rgb(crops.flip(-1) * (1.0 / 255.0))
            mark(spans, "crops_normalise")
            x = model.embed(x)
            mark(spans, "patch_embed")
            for block in model.blocks():
                qkv = block.qkv(x, model.rope_cos, model.rope_sin)
                mark(spans, "blocks_before_K2")
                attn = cuda_attention.attention(*qkv)
                mark(spans, "attention_K2")
                x = block.finish(x, attn)
                mark(spans, "blocks_after_K2")
            probs = torch.softmax(model.classify_tokens(x).float(), dim=-1)
            top_p, top_i = _stable_topk(probs, min(10, clf.num_classes))
            mark(spans, "head_topk")
            torch.cat([top_p, top_i.to(top_p.dtype)], dim=-1).cpu()
            mark(spans, "readback")
        torch.cuda.synchronize()
        if it == 0:          # warm-up
            continue
        for (_, a), (name, b) in zip(spans, spans[1:]):
            totals[name] += a.elapsed_time(b)
    return {n: t / iters for n, t in totals.items()}


def phase_full_width(frames_1440, card):
    """The classifier at its full published width, random weights. Returns
    K2's launches on it."""
    import torch
    from telescope_cam_detection_tpu_torch.models import eva02
    from telescope_cam_detection_tpu_torch.ops import cuda_attention
    from telescope_cam_detection_tpu_torch.pipeline import species
    from telescope_cam_detection_tpu_torch.ops.attention import (
        attention_reference)
    from telescope_cam_detection_tpu_torch.ops.crops import sample_crops
    from telescope_cam_detection_tpu_torch.ops.preprocess import normalize_rgb
    t0 = time.perf_counter()
    clf = species.SpeciesClassifier(seed=0, device="cuda")   # the defaults
    model = clf.model
    n_params = sum(p.numel() for p in model.parameters())
    check((clf.model_name, clf.input_size, clf.num_classes, model.depth,
           model.dim, model.heads) == ("eva02-large", 336, 10000, 24, 1024, 16),
          "SpeciesClassifier's defaults are not eva02-large@336")
    say(f"phase 6 full width: eva02-large, 336x336, 10000 classes, depth 24, "
        f"dim 1024, 16 heads, fp32, RANDOM WEIGHTS from seed 0, "
        f"{n_params / 1e6:.1f} M parameters ({n_params * 4 / 1e9:.3f} GB) "
        f"built in {time.perf_counter() - t0:.2f} s")
    frames_dev = torch.from_numpy(frames_1440[0]).to(clf.device)
    launches = 0
    for bucket, n_valid in ((4, 3), (16, 13)):
        boxes = fixed_boxes(n_valid, bucket, 4, CAPTURE_HW, seed=bucket)
        clf.classify_boxes_device(frames_dev, boxes, n_valid=n_valid)   # warm
        torch.cuda.synchronize()
        reps = 3
        cuda_attention.LAUNCHES = 0
        t0 = time.perf_counter()
        for _ in range(reps):
            preds = clf.classify_boxes_device(frames_dev, boxes, n_valid=n_valid)
        wall = (time.perf_counter() - t0) * 1e3 / reps
        check(cuda_attention.LAUNCHES == model.depth * reps,
              f"{cuda_attention.LAUNCHES} K2 launches for {reps} dispatches "
              f"of {model.depth} blocks")
        launches += cuda_attention.LAUNCHES
        check(len(preds) == n_valid, f"{len(preds)} results for {n_valid} boxes")

        # logits with the kernel against logits with its plain version
        with torch.inference_mode():
            crops = sample_crops(frames_dev, torch.from_numpy(boxes).to(clf.device),
                                 (clf.input_size,) * 2)
            x = normalize_rgb(crops.flip(-1) * (1.0 / 255.0))
            got = model(x)
            eva02.attention = attention_reference
            try:
                want = model(x)
            finally:
                eva02.attention = cuda_attention.attention
        check(got.shape == (bucket, 10000) and bool(torch.isfinite(got).all()),
              f"logits {tuple(got.shape)} or non-finite")
        err = float((got - want).abs().max())
        check(err <= 1e-3, f"logits with K2 differ from plain by {err:.2e} > 1e-3")
        check(torch.equal(got.topk(5).indices, want.topk(5).indices),
              "top-5 with K2 differ from the plain version's")
        stages = classifier_stages(clf, frames_dev, boxes, iters=3)
        busy, top = profile_busy(
            lambda: clf.classify_boxes_device(frames_dev, boxes, n_valid=n_valid), 2)
        say(f"phase 6 crop bucket {bucket} ({n_valid} real boxes) on "
            f"{CAPTURE_HW[0]}x{CAPTURE_HW[1]} frames: {wall:.3f} ms per "
            f"dispatch (host clock, readback included), {model.depth} K2 "
            f"launches per dispatch; logits with K2 within {err:.2e} of "
            f"logits with attention_reference, same top-5 ({card}, random "
            f"weights)")
        say(f"phase 6 stages crop bucket {bucket} (ms per dispatch, CUDA "
            f"events, each span includes its launch gaps): "
            + ", ".join(f"{n} {t:.4f}" for n, t in stages.items())
            + f"; spans sum {sum(stages.values()):.4f}")
        say(f"phase 6 profile crop bucket {bucket}: device busy {busy:.4f} ms "
            f"per dispatch, idle share {max(1.0 - busy / wall, 0.0):.3f} of "
            f"the unprofiled host wall; top: " + top)
    return launches


def deform_inputs(rng, b, q, heads, hd, level_hw, lo=0.0, hi=1.0, p=4):
    """Seeded values (B, S, heads, hd), locations uniform in [lo, hi) and
    softmaxed weights, as CPU tensors."""
    import torch
    s = sum(h * w for h, w in level_hw)
    values = torch.from_numpy(rng.normal(size=(b, s, heads, hd)).astype(np.float32))
    locs = torch.from_numpy(rng.uniform(
        lo, hi, (b, q, heads, len(level_hw), p, 2)).astype(np.float32))
    w = torch.softmax(torch.from_numpy(rng.normal(
        size=(b, q, heads, len(level_hw) * p)).astype(np.float32)), -1)
    return values, locs, w.reshape(b, q, heads, len(level_hw), p).contiguous()


def half_pixel_locs(rng, b, q, heads, level_hw, p=4):
    """Locations on multiples of half a pixel of each level (pixel centres
    and edges), a little past the border too: loc * w - 0.5 must round as
    the plain version's does, or a corner moves by a pixel."""
    import torch
    locs = np.empty((b, q, heads, len(level_hw), p, 2), np.float32)
    for lvl, (h, w) in enumerate(level_hw):
        for axis, n in ((0, w), (1, h)):
            k = rng.integers(-2, 2 * n + 3, (b, q, heads, p))
            locs[:, :, :, lvl, :, axis] = (k / (2.0 * n)).astype(np.float32)
    return torch.from_numpy(locs)


def deform_bound(values, level_hw, locs):
    """(bound_ms, bound_by, operations, bytes, value rows read): 2 B Q H L P
    4 D operations (a multiply and an add per corner and channel) at the
    fp32 peak; at the memory rate, each distinct (image, head, pixel) row of
    hd values that this run's locations read (the four corners, clamped as
    the kernel clamps them), read once, the locations and weights read once
    and the output written once."""
    import torch
    from telescope_cam_detection_tpu_torch.ops.deform import (
        bilinear_corner_fractions)
    b, s, heads, hd = values.shape
    _, q, _, n_levels, points, _ = locs.shape
    ops = 2.0 * b * q * heads * n_levels * points * 4 * hd
    image_head = (torch.arange(b, device=locs.device)[:, None, None, None]
                  * heads + torch.arange(heads, device=locs.device)[:, None])
    rows = 0
    for lvl, (h, w) in enumerate(level_hw):
        x0, y0, _, _ = bilinear_corner_fractions(locs[:, :, :, lvl], h, w)
        keys = [image_head * (h * w) + (y0 + dy).long().clamp(0, h - 1) * w
                + (x0 + dx).long().clamp(0, w - 1)
                for dy in (0, 1) for dx in (0, 1)]
        rows += int(torch.unique(torch.stack(keys)).numel())
    nbytes = 4.0 * (rows * hd + locs.numel() + locs.numel() // 2
                    + b * q * heads * hd)
    ops_ms, bytes_ms = ops / PEAK_FP32_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", ops, nbytes, rows)


def grid_sample_deform(values, level_hw, locs, weights):
    """The yardstick: the same function as one composition of PyTorch calls,
    ``F.grid_sample`` (bilinear, border padding, align_corners=False) per
    level on (B * heads, hd, H, W) at 2 * loc - 1, then the weighted sum
    over points and levels. Border padding clamps the coordinate, which
    reads what clamping both corner indices reads. Timed only; the port
    never calls it."""
    import torch.nn.functional as F
    from telescope_cam_detection_tpu_torch.ops.deform import split_levels
    b, _, heads, hd = values.shape
    _, q, _, _, points, _ = locs.shape
    out = 0
    for lvl, v in enumerate(split_levels(values, level_hw)):
        h, w = level_hw[lvl]
        v = v.permute(0, 3, 4, 1, 2).reshape(b * heads, hd, h, w)
        grid = (2 * locs[:, :, :, lvl] - 1).permute(0, 2, 1, 3, 4) \
            .reshape(b * heads, q, points, 2)
        sampled = F.grid_sample(v, grid, mode="bilinear", padding_mode="border",
                                align_corners=False)     # (B*heads, hd, Q, P)
        wl = weights[:, :, :, lvl].permute(0, 2, 1, 3).reshape(
            b * heads, 1, q, points)
        out = out + (sampled * wl).sum(-1)
    return out.reshape(b, heads, hd, q).permute(0, 3, 1, 2)


def shipped_deform_inputs(rt_model, frames_640, device):
    """K3's inputs in the shipped RT-DETR's first decoder layer on real
    frames: what a forward hook sees its ``cross_attn.sampling`` called
    with (the model's own value_proj, locations and weights)."""
    import torch
    from telescope_cam_detection_tpu_torch.ops.preprocess import preprocess_rtdetr
    seen = []
    hook = rt_model.decoder0.cross_attn.sampling.register_forward_pre_hook(
        lambda module, args: seen.append(args))
    try:
        with torch.inference_mode():
            rt_model(preprocess_rtdetr(torch.from_numpy(frames_640).to(device),
                                       INPUT_HW))
    finally:
        hook.remove()
    values, level_hw, locs, w = seen[0]
    return level_hw, (values, locs, w)


def phase_deform(cuda_deform, rt_model, frames_640, device):
    """K3 against its plain version on the card, within rtol 1e-4, atol
    1e-5 (tests/test_pallas_deform.py's tolerance), then its timings beside
    the bound and the grid_sample yardstick."""
    import torch
    from telescope_cam_detection_tpu_torch.ops.deform import (
        ms_deformable_attention_reference, split_levels)
    rng = np.random.default_rng(3)
    rt640 = [(INPUT_HW[0] // s, INPUT_HW[1] // s) for s in (8, 16, 32)]
    shipped_hw, shipped = shipped_deform_inputs(rt_model, frames_640, device)
    check(list(shipped_hw) == rt640, f"shipped levels {shipped_hw}")
    cases = [
        ("random small B=2 Q=30", [(12, 16), (6, 8), (3, 4)],
         deform_inputs(rng, 2, 30, 8, 32, [(12, 16), (6, 8), (3, 4)])),
        (f"decoder shapes B=4 Q=300 at {INPUT_HW[0]}x{INPUT_HW[1]}", rt640,
         deform_inputs(rng, 4, 300, 8, 32, rt640)),
        ("locations outside [0, 1]", rt640,
         deform_inputs(rng, 2, 300, 8, 32, rt640, -0.5, 1.5)),
        ("H != W levels, Q=30", [(24, 40), (12, 20), (6, 10)],
         deform_inputs(rng, 2, 30, 8, 32, [(24, 40), (12, 20), (6, 10)])),
    ]
    v, _, w = deform_inputs(rng, 2, 300, 8, 32, rt640)
    cases.append(("pixel centres and edges", rt640,
                  (v, half_pixel_locs(rng, 2, 300, 8, rt640), w)))
    cases.append((f"shipped r18vd value_proj, B={len(frames_640)}, Q=300",
                  rt640, shipped))
    max_err = 0.0
    for name, level_hw, tensors in cases:
        values, locs, w = (x.to(device) for x in tensors)
        before = cuda_deform.LAUNCHES
        got = cuda_deform.deform_sample(values, level_hw, locs, w)
        torch.cuda.synchronize()
        check(cuda_deform.LAUNCHES == before + 1, "K3 launch not counted")
        want = ms_deformable_attention_reference(
            split_levels(values, level_hw), locs, w)
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"K3 output {tuple(got.shape)} or non-finite: {name}")
        err = float((got - want).abs().max())
        max_err = max(max_err, err)
        try:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        except AssertionError as e:
            raise SmokeFailure(f"K3 differs from its plain version: {name}: {e}")
        note = ""
        if name.startswith("decoder shapes"):
            want_cpu = cuda_deform.deform_sample(
                values.cpu(), level_hw, locs.cpu(), w.cpu())
            try:
                torch.testing.assert_close(got.cpu(), want_cpu, rtol=1e-4,
                                           atol=1e-5)
            except AssertionError as e:
                raise SmokeFailure(f"K3 differs from the CPU plain version: {e}")
            note = ", also within it of the CPU plain version"
        say(f"phase 2 K3 {name} values {tuple(values.shape)} locs "
            f"{tuple(locs.shape)}: within rtol 1e-4 atol 1e-5 of plain, max "
            f"abs err {err:.3e}{note}")

    values, locs, w = shipped
    kernel_ms, host_ms = device_ms(
        lambda: cuda_deform.deform_sample(values, rt640, locs, w), reps=100,
        kernel="deform_kernel")
    events_ms = cuda_time_ms(
        lambda: cuda_deform.deform_sample(values, rt640, locs, w), iters=100)
    plain_ms, _ = device_ms(lambda: ms_deformable_attention_reference(
        split_levels(values, rt640), locs, w), reps=5, warmup=2)
    library_ms, _ = device_ms(
        lambda: grid_sample_deform(values, rt640, locs, w), reps=20, warmup=3)
    bound_ms, bound_by, ops, nbytes, rows = deform_bound(values, rt640, locs)
    all_rows = values.shape[0] * values.shape[1] * values.shape[2]
    want = ms_deformable_attention_reference(split_levels(values, rt640), locs, w)
    lib_err = float((grid_sample_deform(values, rt640, locs, w) - want).abs().max())
    try:
        torch.testing.assert_close(grid_sample_deform(values, rt640, locs, w),
                                   want, rtol=1e-4, atol=1e-5)
        lib_note = "within rtol 1e-4 atol 1e-5 of the plain version"
    except AssertionError:
        lib_note = "NOT within rtol 1e-4 atol 1e-5 of the plain version"
    say(f"phase 2 K3 grid_sample yardstick on the shipped inputs: {lib_note}, "
        f"max abs err {lib_err:.3e}")
    say(f"phase 2 K3 timing values {tuple(values.shape)} locs "
        f"{tuple(locs.shape)} (device ms per call from torch.profiler): "
        f"kernel_ms {kernel_ms:.5f} plain_ms {plain_ms:.5f} library_ms "
        f"{library_ms:.5f} (F.grid_sample per level, permutes included) "
        f"bound_ms {bound_ms:.5f} ({bound_by}: {ops:.3e} ops, {nbytes:.3e} "
        f"bytes, {rows} distinct value rows of {all_rows}), "
        f"{nbytes / kernel_ms / 1e9:.2f} TB/s of the bound's bytes; host "
        f"{host_ms:.5f} ms per wrapper call, CUDA events around 100 calls "
        f"{events_ms:.5f} ms per call")
    return {"name": "deform", "route": "cuda",
            "source": "telescope_cam_detection_tpu_torch/csrc/deform.cu",
            "replaces": "telescope_cam_detection_tpu/ops/pallas_deform.py:41",
            "launches": 0, "max_abs_err": max_err,
            "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms,
            "library_within_tolerance": lib_note.startswith("within"),
            "host_ms_per_call": host_ms, "events_ms": events_ms,
            "value_rows_read": rows,
            "shape": {"values": list(values.shape), "locs": list(locs.shape)}}


def phase_rtdetr(program, rt_state, rt_cfg, frames_1440, frames_640, card):
    """Drive the RT-DETR path; return (K3 launches, programs)."""
    import torch
    from telescope_cam_detection_tpu_torch.ops import cuda_deform, cuda_nms
    kw = dict(detector_type="rtdetr", variant=rt_cfg["variant"],
              num_classes=rt_cfg["num_classes"], input_hw=INPUT_HW)
    spec_dev = program.ProgramSpec(transfer="device", **kw)
    spec_auto = program.ProgramSpec(transfer="auto", **kw)
    progs = {"device": program.DetectorProgram(spec_dev, state_dict=rt_state,
                                               device="cuda"),
             "auto": program.DetectorProgram(spec_auto, state_dict=rt_state,
                                             device="cuda")}
    layers = progs["device"].model.decoder_layers
    loose = program.FilterSettings(conf_threshold=0.0, wildlife_only=False)
    progs["auto"].update_filters(loose)
    progs["device"].warm(len(frames_1440[0]), CAPTURE_HW)
    progs["auto"].warm(len(frames_640[0]), INPUT_HW)
    torch.cuda.synchronize()

    results = {"device": [], "auto": []}
    dispatches = 0
    cuda_deform.LAUNCHES = cuda_nms.LAUNCHES = 0
    for name, sets in (("device", frames_1440), ("auto", frames_640)):
        prog = progs[name]
        built = prog.stats["compilations"]
        for i in range(REQUESTS):
            frames = sets[max(i - 1, 0)] if name == "device" else sets[i]
            if name == "device" and i == 1:
                prog.update_filters(loose)   # between requests, no rebuild
            before = cuda_deform.LAUNCHES
            t0 = time.perf_counter()
            rows = prog.detect_batch_rows(frames)
            seconds = time.perf_counter() - t0
            dispatches += 1
            check(cuda_deform.LAUNCHES == before + layers,
                  f"K3 launches grew by {cuda_deform.LAUNCHES - before}, not "
                  f"{layers} (one per decoder layer)")
            results[name].append((frames, rows, seconds))
        check(prog.stats["compilations"] == built,
              "update_filters or a request rebuilt a program")
    launches, k1 = cuda_deform.LAUNCHES, cuda_nms.LAUNCHES
    check(launches == layers * dispatches,
          f"{launches} K3 launches, {dispatches} dispatches x {layers} layers")
    check(k1 == 0, f"{k1} K1 launches on the NMS-free RT-DETR path")
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
        confident = [int(n) for n in (last[..., 4] * last[..., 5] >= RT_CONF).sum(1)]
        say(f"phase 7 RT-DETR transfer={name} B={len(results[name][0][0])} "
            f"capture {hw[0]}x{hw[1]}: {REQUESTS} requests, {confident} rows "
            f"per frame at score >= {RT_CONF}, {fps:.2f} frames/s host clock "
            f"incl. transfer and readback ({card})")
    say(f"phase 7 RT-DETR K3 launches in the path: {launches} for {dispatches} "
        f"dispatches ({layers} per dispatch, one per decoder layer); K1 "
        f"launches {k1} (NMS-free)")

    # the same frames through the same program on the CPU: the request (under
    # the loose filter) with the most confident rows
    def most_confident(res):
        return max(res, key=lambda r: int(
            (r[1][..., 4] * r[1][..., 5] >= RT_CONF + 0.01).sum()))

    for name, spec, (frames, rows, _) in (
            ("device", spec_dev, most_confident(results["device"][1:])),
            ("auto", spec_auto, most_confident(results["auto"]))):
        cpu = program.DetectorProgram(spec, state_dict=rt_state, device="cpu")
        cpu.update_filters(loose)
        want = cpu.detect_batch_rows(frames)
        matched = match_rows(rows, want, RT_CONF)
        check(matched > 0, f"RT-DETR transfer={name}: no confident rows to compare")
        say(f"phase 7 RT-DETR transfer={name}: CUDA rows match the CPU program, "
            f"{matched} rows at score >= {RT_CONF + 0.01} at IoU >= 0.99 with "
            f"equal classes")
    return launches, layers, progs


def phase_rtdetr_breakdown(name, prog, frames, capture_hw, iters=5):
    """Device time of each stage of one RT-DETR request as the program runs
    it (``dispatch_batch``, then ``materialize``): CUDA events recorded
    around the two calls and by forward hooks at the model's module
    boundaries, K3 being each decoder layer's ``cross_attn.sampling``. The
    host clock around the same request gives the idle share."""
    import torch
    model = prog.model
    names = ("h2d_preprocess", "backbone", "encoder", "query_selection",
             "decoder_excl_K3", "deform_K3", "postprocess", "readback")
    totals = dict.fromkeys(names, 0.0)
    wall = 0.0
    spans = []

    def mark(label):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        spans.append((label, ev))

    def before(label):
        return lambda module, args: mark(label)

    def after(label):
        return lambda module, args, out: mark(label)

    hooks = [model.backbone.register_forward_pre_hook(before("h2d_preprocess")),
             model.backbone.register_forward_hook(after("backbone")),
             model.encoder.register_forward_hook(after("encoder")),
             # the first layer's query_pos_head runs before this hook
             model.decoder0.register_forward_pre_hook(before("query_selection")),
             model.class_head.register_forward_hook(after("decoder_excl_K3"))]
    for layer, _ in model.decoders():
        sampling = layer.cross_attn.sampling
        hooks += [sampling.register_forward_pre_hook(before("decoder_excl_K3")),
                  sampling.register_forward_hook(after("deform_K3"))]
    try:
        for it in range(iters + 2):
            spans.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mark(None)
            handle = prog.dispatch_batch(frames)
            mark("postprocess")
            prog.materialize(handle, len(frames))
            mark("readback")
            torch.cuda.synchronize()
            if it < 2:          # warm-up
                continue
            wall += (time.perf_counter() - t0) * 1e3
            for (_, a), (label, b) in zip(spans, spans[1:]):
                totals[label] += a.elapsed_time(b)
    finally:
        for hook in hooks:
            hook.remove()
    per = {n: t / iters for n, t in totals.items()}
    wall /= iters
    say(f"phase 8 RT-DETR stages transfer={name} B={len(frames)} capture "
        f"{capture_hw[0]}x{capture_hw[1]} (ms per request, CUDA events, each "
        f"span includes the launch gaps inside it): "
        + ", ".join(f"{n} {t:.4f}" for n, t in per.items())
        + f"; spans sum {sum(per.values()):.4f}, host wall {wall:.4f}")
    busy, top = profile_busy(
        lambda: prog.materialize(prog.dispatch_batch(frames), len(frames)), 5)
    say(f"phase 8 RT-DETR profile transfer={name}: device busy {busy:.4f} ms "
        f"per request, idle share {max(1.0 - busy / wall, 0.0):.3f} of the "
        f"unprofiled host wall; top: " + top)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SmokeFailure("CUDA is not available: this smoke run needs the card")
    try:
        from telescope_cam_detection_tpu_torch.models.convert import (
            eva02_state_dict_from_flax, load_npz, rtdetr_state_dict_from_flax,
            yolox_state_dict_from_flax)
        from telescope_cam_detection_tpu_torch.ops import (
            cuda_attention, cuda_deform, cuda_nms, nms)
        from telescope_cam_detection_tpu_torch.pipeline import species
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
    # K2 has one instance per head dim and type; print the ones EVA02 runs
    phase_build([("K1 nms_suppress", cuda_nms, None),
                 ("K2 attention", cuda_attention, "Li64E"),
                 ("K3 deform", cuda_deform, None)])

    state = yolox_state_dict_from_flax(load_npz(WEIGHTS))
    src_640 = SyntheticFrameSource(width=INPUT_HW[1], height=INPUT_HW[0], seed=1)
    src_1440 = SyntheticFrameSource(width=CAPTURE_HW[1], height=CAPTURE_HW[0],
                                    seed=0, object_size=240)
    frames_640 = [synthetic(src_640, 8, 40 * i) for i in range(REQUESTS)]
    frames_1440 = [synthetic(src_1440, 4, 40 * i) for i in range(REQUESTS)]

    device = torch.device("cuda")
    model = program.DetectorProgram(program.ProgramSpec(), state_dict=state,
                                    device=device).model
    k1 = phase_kernel(cuda_nms, nms, model, frames_640[0], device)
    del model
    eva_state = eva02_state_dict_from_flax(load_npz(EVA_WEIGHTS))
    eva_cfg = json.loads(EVA_CONFIG.read_text())
    tiny_clf = species.SpeciesClassifier(
        eva_cfg["variant"], eva_cfg["num_classes"], eva_cfg["input_size"],
        taxonomy_file=str(TAXONOMY), state_dict=eva_state, device="cuda")
    k2 = phase_attention(cuda_attention, tiny_clf, device)
    rt_state = rtdetr_state_dict_from_flax(load_npz(RT_WEIGHTS))
    rt_cfg = json.loads(RT_CONFIG.read_text())
    rt_model = program.DetectorProgram(
        program.ProgramSpec(detector_type="rtdetr", variant=rt_cfg["variant"]),
        state_dict=rt_state, device=device).model
    k3 = phase_deform(cuda_deform, rt_model, frames_640[0][:4], device)
    del rt_model

    k1_detector, prog_dev, prog_auto = phase_main_path(
        cuda_nms, program, state, frames_1440, frames_640, card)
    phase_breakdown("device", prog_dev, frames_1440[0], CAPTURE_HW)
    phase_breakdown("auto", prog_auto, frames_640[0], INPUT_HW)
    del prog_auto

    k1_two_stage, k2_two_stage = phase_two_stage(
        tiny_clf, eva_state, eva_cfg, prog_dev, frames_1440, card)
    k2_full = phase_full_width(frames_1440, card)
    k3_launches, rt_layers, rt_progs = phase_rtdetr(
        program, rt_state, rt_cfg, frames_1440, frames_640, card)
    phase_rtdetr_breakdown("device", rt_progs["device"], frames_1440[0], CAPTURE_HW)
    phase_rtdetr_breakdown("auto", rt_progs["auto"], frames_640[0], INPUT_HW)
    # launches on the main paths only: each count was set to 0 just before
    # its path and read just after; the comparisons above are not in it
    k1["launches"] = k1_detector + k1_two_stage
    k1["launches_by_path"] = {"detector": k1_detector, "two_stage": k1_two_stage}
    k1["launches_per_dispatch"] = 1          # checked per request in phase 3
    k2["launches"] = k2_two_stage + k2_full
    k2["launches_by_path"] = {"two_stage": k2_two_stage, "full_width": k2_full}
    # one per transformer block, checked per dispatch in phases 5 and 6
    k2["launches_per_dispatch"] = {"eva02-large": 24,
                                   eva_cfg["variant"]: tiny_clf.model.depth}
    k3["launches"] = k3_launches
    k3["launches_by_path"] = {"rtdetr": k3_launches}
    k3["launches_per_dispatch"] = rt_layers   # checked per request in phase 7
    for kernel in (k1, k2, k3):
        kernel["kernel_ms"] = kernel["ms"]
    check(k1["launches"] > 0 and k2["launches"] > 0 and k3["launches"] > 0,
          "a kernel of the main path was never launched")
    say(smi)
    say(json.dumps({"kernels": [k1, k2, k3]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": card, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr, flush=True)
        sys.exit(1)
