"""Pinhole + stereo camera (counterpart of orb_slam2_2021_tpu/geometry/camera.py).

The intrinsics are host floats rounded to float32, so every product with a
float32 tensor sees the same operands as the reference's float32 scalars.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class PinholeCamera(NamedTuple):
    fx: float
    fy: float
    cx: float
    cy: float
    bf: float  # baseline * fx (stereo); 0 for monocular
    width: int = 0
    height: int = 0

    @staticmethod
    def create(fx, fy, cx, cy, bf=0.0, width=0, height=0):
        f = lambda v: float(np.float32(v))  # noqa: E731
        return PinholeCamera(f(fx), f(fy), f(cx), f(cy), f(bf), int(width), int(height))

    @property
    def baseline(self) -> float:
        """bf / fx, divided in float32 as the reference's scalars are."""
        return float(np.float32(self.bf) / np.float32(self.fx))


def _inv_z(z):
    return 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def project_mono(cam: PinholeCamera, xc):
    """Camera-frame points [..., 3] -> pixel (u, v) [..., 2] and depth [...]."""
    z = xc[..., 2]
    inv_z = _inv_z(z)
    u = cam.fx * xc[..., 0] * inv_z + cam.cx
    v = cam.fy * xc[..., 1] * inv_z + cam.cy
    return torch.stack([u, v], dim=-1), z


def project_stereo(cam: PinholeCamera, xc):
    """Camera-frame points [..., 3] -> (u, v, u_r) [..., 3] and depth [...]."""
    uv, z = project_mono(cam, xc)
    ur = uv[..., 0] - cam.bf * _inv_z(z)
    return torch.cat([uv, ur[..., None]], dim=-1), z


def backproject(cam: PinholeCamera, uv, z):
    """Pixels [..., 2] and depth [...] -> camera-frame points [..., 3]."""
    x = (uv[..., 0] - cam.cx) * z / cam.fx
    y = (uv[..., 1] - cam.cy) * z / cam.fy
    return torch.stack([x, y, z], dim=-1)
