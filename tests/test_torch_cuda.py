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

from telescope_cam_detection_tpu_torch.ops import cuda_nms

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _boxes(seed, b, k):
    rng = np.random.default_rng(seed)
    c = rng.uniform(0, 640, (b, k, 2))
    wh = rng.uniform(8, 120, (b, k, 2))
    return (torch.from_numpy(np.concatenate([c - wh / 2, c + wh / 2], -1)
                             .astype(np.float32)),
            torch.from_numpy(rng.uniform(size=(b, k)) < 0.8))


@pytest.mark.parametrize("b,k", [(8, 1000), (3, 777), (1, 64), (2, 65), (4, 1)])
def test_suppress_kernel_matches_plain(device, b, k):
    boxes, valid = _boxes(k, b, k)
    before = cuda_nms.LAUNCHES
    got = cuda_nms.suppress(boxes.to(device), valid.to(device), 0.45)
    assert cuda_nms.LAUNCHES == before + 1
    torch.cuda.synchronize()
    want = cuda_nms.suppress(boxes, valid, 0.45)        # CPU: plain version
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
