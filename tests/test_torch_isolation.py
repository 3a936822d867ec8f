"""The port stands alone: telescope_cam_detection_tpu_torch and chip_smoke.py
import neither JAX, Flax nor the JAX package, and their entry points refuse
to run on a host without CUDA unless asked for the CPU."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "telescope_cam_detection_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "telescope_cam_detection_tpu")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py",
                                         REPO / "chip_kernel_ab.py"]


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports(path):
    roots = set(_imported_roots(path))
    assert not roots & set(FORBIDDEN), (path, roots & set(FORBIDDEN))


def _clean_env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_port_import_pulls_in_no_jax():
    code = (
        "import sys, pkgutil, importlib\n"
        "import telescope_cam_detection_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]))\n"
        "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         env=_clean_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.split()[-1]) >= 31    # every module was imported


def test_entry_points_refuse_without_cuda():
    """No CUDA here: the default device raises; device='cpu' runs."""
    from telescope_cam_detection_tpu_torch.device import resolve_device
    from telescope_cam_detection_tpu_torch.runtime.program import (
        DetectorProgram, ProgramSpec)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    spec = ProgramSpec(variant="yolox-nano", input_hw=(64, 64))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DetectorProgram(spec)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device()
    prog = DetectorProgram(spec, device="cpu")
    rows = prog.detect_batch_rows(np.zeros((1, 64, 64, 3), np.uint8))
    assert rows.shape == (1, 300, 7)
    rtdetr = ProgramSpec(detector_type="rtdetr", variant="rtdetrv2-r18vd",
                         input_hw=(64, 64))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DetectorProgram(rtdetr)


def test_stage2_entry_points_refuse_without_cuda():
    """The classifier defaults to the card too; the pipeline uploads its
    frame to the classifier's device."""
    from telescope_cam_detection_tpu_torch.pipeline.species import (
        SpeciesClassifier)
    from telescope_cam_detection_tpu_torch.pipeline.two_stage import (
        TwoStageDetectionPipeline)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SpeciesClassifier("eva02-tiny", 8, 56)
    clf = SpeciesClassifier("eva02-tiny", 8, 56, device="cpu")
    assert clf.device.type == "cpu"
    clf.hierarchy_thresholds = dict.fromkeys(clf.hierarchy_thresholds, 0.0)
    pipe = TwoStageDetectionPipeline(clf, device_crops=True, min_crop_size=16,
                                     confidence_threshold=0.0)
    out = pipe.process_detections(
        np.zeros((64, 64, 3), np.uint8),
        [{"class_id": 14, "class_name": "bird", "confidence": 0.9,
          "bbox": {"x1": 4, "y1": 4, "x2": 60, "y2": 60}}])
    assert "species" in out[0]
    with pytest.raises(ValueError, match="CUDA device or on the CPU"):
        from telescope_cam_detection_tpu_torch.ops.cuda_attention import attention
        q = torch.zeros(1, 4, 1, 16)
        attention(q, q.to("meta"), q)


def test_deform_kernel_refuses_other_devices():
    """K3's wrapper runs the plain version on CPU tensors only; any other
    device that is not CUDA raises before a launch."""
    from telescope_cam_detection_tpu_torch.ops import cuda_deform
    values = torch.zeros(1, 5, 2, 32)
    locs, weights = torch.zeros(1, 3, 2, 2, 4, 2), torch.zeros(1, 3, 2, 2, 4)
    level_hw = [(2, 2), (1, 1)]
    assert cuda_deform.deform_sample(values, level_hw, locs, weights).shape \
        == (1, 3, 2, 32)
    before = cuda_deform.LAUNCHES
    with pytest.raises(ValueError, match="CUDA device or on the CPU"):
        cuda_deform.deform_sample(values.to("meta"), level_hw, locs, weights)
    with pytest.raises(ValueError, match="CUDA device or on the CPU"):
        cuda_deform.deform_sample(values, level_hw, locs.to("meta"), weights)
    assert cuda_deform.LAUNCHES == before


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_cuda():
    out = _run_smoke(REPO)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "CUDA is not available" in out.stderr


def test_chip_smoke_fails_alone(tmp_path):
    """Without the port beside it, the script fails and prints no result."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
