#!/usr/bin/env python3
"""Kernels K1 (NMS suppression), K2 (fused attention) and K3 (multi-scale
deformable sampling) of two checkouts, timed in turns on one NVIDIA GPU.

    python3 chip_kernel_ab.py --other DIR [--reps N] [--kernels K1,K2,K3]

DIR is the root of another checkout of this repository (for example an
earlier commit unpacked with ``git archive``). Both checkouts' sources
(``telescope_cam_detection_tpu_torch/csrc/{nms_suppress,attention,deform}.cu``)
are built with this checkout's flags and bound through this checkout's
wrappers (``ops/cuda_nms.py``, ``ops/cuda_attention.py``,
``ops/cuda_deform.py``: the C interfaces are the same). Each kernel runs on
the main path's shapes, in the order this, other, other, this; each result
is held against the plain version (keep masks equal, attention within 2e-5
fp32 and 2e-2 bf16, deformable sampling within 1e-4/1e-5 and bit-equal), and
each time is device time from ``torch.profiler`` (the sum of the kernel rows
of one call), so the wrappers' host time is left out. K3's wrapper host time
is measured apart, each checkout's wrapper with its own kernel: a host clock
around a loop of calls that does not synchronise. One JSON object per line;
the first line names the card and its power limit.

K1 inputs: B = 8, K = 1000: the decode of the shipped YOLOX-S
(``weights/yolox_s_scene640.npz``) on synthetic 640x640 frames at
confidence 0 and 0.25, and random boxes. K2 inputs: (16, 577, 16, 64)
(eva02-large@336, crop bucket 16) and (16, 65, 3, 64) (eva02-tiny@112), fp32
and bf16, seeded normal q, k, v. K3 inputs: what the shipped RT-DETRv2-r18vd
(``weights/rtdetrv2_r18vd_scene640.npz``) hands its first decoder layer's
sampling on synthetic 640x640 frames, at B = 4 and B = 8.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
SOURCES = {"K1": ("nms_suppress.cu", "cuda_nms"),
           "K2": ("attention.cu", "cuda_attention"),
           "K3": ("deform.cu", "cuda_deform")}


def device_rows(fn, reps):
    """{kernel name: device ms per call} over ``reps`` calls of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        if str(e.device_type).endswith("CUDA"):
            name = e.key.split("::")[-1].split("(")[0].split("<")[0]
            us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
            rows[name] = rows.get(name, 0.0) + us / reps / 1e3
    return rows


def host_us(fn, reps: int = 100, loops: int = 5) -> float:
    """Host microseconds per call of ``fn``: the median over ``loops`` host
    clocks, each around ``reps`` calls that do not synchronise (the launches
    queue on the card meanwhile)."""
    import torch
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(loops):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        per_call.append((time.perf_counter() - t0) * 1e6 / reps)
        torch.cuda.synchronize()
    return float(np.median(per_call))


def libraries(other: Path, kernels):
    """{(kernel, side): CudaLibrary} for both checkouts, built in parallel."""
    from telescope_cam_detection_tpu_torch.ops import (
        cuda_attention, cuda_deform, cuda_nms)
    from telescope_cam_detection_tpu_torch.ops.cuda_build import CudaLibrary
    mods = {"cuda_nms": cuda_nms, "cuda_attention": cuda_attention,
            "cuda_deform": cuda_deform}
    libs = {}
    for kernel, (source, mod) in SOURCES.items():
        if kernel not in kernels:
            continue
        this = mods[mod].LIBRARY
        that = CudaLibrary(source, (), this._declare)
        that.flags = this.flags
        that.source = (other / "telescope_cam_detection_tpu_torch" / "csrc"
                       / source)
        if not that.source.exists():
            raise SystemExit(f"{that.source} does not exist")
        libs[(kernel, "this")] = this
        libs[(kernel, "other")] = that
    errors = []

    def build(lib):
        try:
            lib.build()
        except Exception as e:       # reported below
            errors.append(str(e))

    threads = [threading.Thread(target=build, args=(lib,))
               for lib in libs.values()]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    if errors:
        raise SystemExit("build failed: " + errors[0])
    return libs, mods


def nms_inputs(device):
    import torch
    from telescope_cam_detection_tpu_torch.models.convert import (
        load_npz, yolox_state_dict_from_flax)
    from telescope_cam_detection_tpu_torch.models.yolox import decode_outputs
    from telescope_cam_detection_tpu_torch.ops import nms
    from telescope_cam_detection_tpu_torch.ops.preprocess import (
        preprocess_yolox)
    from telescope_cam_detection_tpu_torch.runtime import program
    from telescope_cam_detection_tpu_torch.utils.frames import (
        SyntheticFrameSource)
    state = yolox_state_dict_from_flax(
        load_npz(REPO / "weights" / "yolox_s_scene640.npz"))
    model = program.DetectorProgram(program.ProgramSpec(), state_dict=state,
                                    device=device).model
    src = SyntheticFrameSource(width=640, height=640, seed=1)
    frames = np.stack([src.frame_at(9 * i) for i in range(8)])
    cases = {}
    with torch.inference_mode():
        x = preprocess_yolox(torch.from_numpy(frames).to(device), (640, 640))
        boxes, obj, cls = decode_outputs(model(x))
        for conf in (0.0, 0.25):
            ob, valid, *_ = nms._prep_single(boxes, obj, cls, conf, 1000,
                                             False)
            cases[f"real decode conf {conf}"] = (ob, valid)
    rng = np.random.default_rng(0)
    c = rng.uniform(0, 640, (8, 1000, 2))
    wh = rng.uniform(8, 120, (8, 1000, 2))
    cases["random"] = (
        torch.from_numpy(np.concatenate([c - wh / 2, c + wh / 2], -1)
                         .astype(np.float32)).to(device),
        torch.ones((8, 1000), dtype=torch.bool, device=device))
    return cases


def attention_inputs(device):
    import torch
    cases = {}
    for shape in ((16, 577, 16, 64), (16, 65, 3, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            rng = np.random.default_rng(5)
            q, k, v = (torch.from_numpy(rng.normal(0, 1, shape)
                                        .astype(np.float32))
                       .to(device).to(dtype) for _ in range(3))
            cases[f"{shape} {str(dtype)[6:]}"] = (q, k, v)
    return cases


def deform_inputs(device):
    """{case: (values, level_hw, locs, weights)}: the shipped RT-DETR's first
    decoder layer's sampling inputs on synthetic 640x640 frames."""
    import torch
    from telescope_cam_detection_tpu_torch.models.convert import (
        load_npz, rtdetr_state_dict_from_flax)
    from telescope_cam_detection_tpu_torch.ops.preprocess import (
        preprocess_rtdetr)
    from telescope_cam_detection_tpu_torch.runtime import program
    from telescope_cam_detection_tpu_torch.utils.frames import (
        SyntheticFrameSource)
    cfg = json.loads((REPO / "weights" / "rtdetrv2_r18vd_scene640.json")
                     .read_text())
    state = rtdetr_state_dict_from_flax(
        load_npz(REPO / "weights" / "rtdetrv2_r18vd_scene640.npz"))
    model = program.DetectorProgram(
        program.ProgramSpec(detector_type="rtdetr", variant=cfg["variant"]),
        state_dict=state, device=device).model
    src = SyntheticFrameSource(width=640, height=640, seed=1)
    cases = {}
    for b in (4, 8):
        frames = np.stack([src.frame_at(9 * i) for i in range(b)])
        seen = []
        hook = model.decoder0.cross_attn.sampling.register_forward_pre_hook(
            lambda module, args: seen.append(args))
        try:
            with torch.inference_mode():
                model(preprocess_rtdetr(torch.from_numpy(frames).to(device),
                                        (640, 640)))
        finally:
            hook.remove()
        values, level_hw, locs, w = seen[0]
        cases[f"shipped r18vd B={b} Q=300"] = (values, list(level_hw), locs, w)
    return cases


def other_wrapper(other: Path, name: str, lib):
    """The other checkout's wrapper module ``ops/<name>.py``, loaded apart
    and bound to the other checkout's library."""
    path = other / "telescope_cam_detection_tpu_torch" / "ops" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"other_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.LIBRARY = lib
    return mod


def main() -> int:
    import torch
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--other", type=Path, required=True)
    parser.add_argument("--reps", type=int, default=20)
    parser.add_argument("--kernels", default="K1,K2,K3")
    args = parser.parse_args()
    kernels = args.kernels.split(",")
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: this script needs the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "other": str(args.other)}), flush=True)
    from telescope_cam_detection_tpu_torch.ops.attention import (
        attention_reference)
    from telescope_cam_detection_tpu_torch.ops.deform import (
        ms_deformable_attention_reference, split_levels)
    other = args.other.resolve()
    libs, mods = libraries(other, kernels)
    device = torch.device("cuda")
    inputs = {"K1": (nms_inputs, "cuda_nms"),
              "K2": (attention_inputs, "cuda_attention"),
              "K3": (deform_inputs, "cuda_deform")}
    failed = False
    for kernel in kernels:
        make, mod_name = inputs[kernel]
        mod = mods[mod_name]
        own = mod.LIBRARY
        print(json.dumps({"kernel": kernel, "ptxas": {
            side: [ln.strip() for ln in libs[(kernel, side)].log.splitlines()
                   if "registers" in ln or "spill" in ln]
            for side in ("this", "other")}}), flush=True)
        for name, args_ in make(device).items():
            if kernel == "K1":
                def call():
                    return mod.suppress(*args_, 0.45)
                want = mod.suppress_reference(*args_, 0.45)
            elif kernel == "K2":
                def call():
                    return mod.attention(*args_)
                want = attention_reference(*args_)
            else:
                def call():
                    return mod.deform_sample(*args_)
                values, level_hw, locs, w = args_
                want = ms_deformable_attention_reference(
                    split_levels(values, level_hw), locs, w)
            times = {"this": [], "other": []}
            agree = {}
            for side in ("this", "other", "other", "this"):
                mod.LIBRARY = libs[(kernel, side)]
                got = call()
                torch.cuda.synchronize()
                if kernel == "K1":
                    agree[side] = bool(torch.equal(got, want))
                elif kernel == "K2":
                    tol = 2e-5 if got.dtype == torch.float32 else 2e-2
                    agree[side] = bool(torch.allclose(
                        got.float(), want.float(), rtol=tol, atol=tol))
                else:
                    agree[side] = bool(
                        torch.allclose(got, want, rtol=1e-4, atol=1e-5)
                        and torch.equal(got, want))
                rows = device_rows(call, args.reps)
                times[side].append(rows)
            mod.LIBRARY = own
            failed |= not all(agree.values())
            line = {"kernel": kernel, "case": name, "agrees_with_plain": agree,
                    "device_ms": {side: [sum(r.values()) for r in rs]
                                  for side, rs in times.items()},
                    "rows_ms": {side: rs[0] for side, rs in times.items()}}
            if kernel == "K3":
                wrappers = {"this": mod, "other": other_wrapper(
                    other, mod_name, libs[(kernel, "other")])}
                line["wrapper_host_us"] = {"this": [], "other": []}
                for side in ("this", "other", "other", "this"):
                    line["wrapper_host_us"][side].append(host_us(
                        lambda: wrappers[side].deform_sample(*args_)))
            print(json.dumps(line), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
