"""Host-side YUV 4:2:0 packing for ``transfer="yuv420"``.

Counterpart of the numpy packer of ``telescope_cam_detection_tpu``
(``runtime/delta.py bgr_to_yuv_planes_numpy`` and ``runtime/program.py
_pack_yuv420_numpy``): the plain version of the native packer
(``utils/native.py bgr_to_yuv420``) that ``transfer="yuv420"`` runs, which
is bit-identical to it. Tile deltas come with the delta-transfer slice.
"""
from __future__ import annotations

import numpy as np


def bgr_to_yuv_planes_numpy(frame: np.ndarray):
    """Canonical full-range BT.601 forward transform, Q16 fixed point —
    integer-exact. Returns (Y (H,W), U (H/2,W/2), V (H/2,W/2)) uint8
    (U/V top-left subsampled)."""
    f = frame.astype(np.int64)
    b, g, r = f[..., 0], f[..., 1], f[..., 2]
    y_fp = 19595 * r + 38470 * g + 7471 * b            # Q16
    yq = ((y_fp + 32768) >> 16).astype(np.uint8)
    bs, rs, ys = b[0::2, 0::2], r[0::2, 0::2], y_fp[0::2, 0::2]
    u = ((36963 * ((bs << 16) - ys) + (1 << 31)) >> 32) + 128
    v = ((46727 * ((rs << 16) - ys) + (1 << 31)) >> 32) + 128
    uq = np.clip(u, 0, 255).astype(np.uint8)
    vq = np.clip(v, 0, 255).astype(np.uint8)
    return yq, uq, vq


def pack_yuv420_numpy(frame: np.ndarray) -> np.ndarray:
    """Full-range BT.601 (H, W, 3) BGR -> (H*3//2, W) planar I420, the
    layout ``ops/preprocess.yuv420_to_bgr`` unpacks on the device."""
    h, w, _ = frame.shape
    yq, u_sub, v_sub = bgr_to_yuv_planes_numpy(frame)
    out = np.empty((h * 3 // 2, w), np.uint8)
    out[:h] = yq
    out[h:h + h // 4] = u_sub.reshape(h // 4, w)
    out[h + h // 4:] = v_sub.reshape(h // 4, w)
    return out
