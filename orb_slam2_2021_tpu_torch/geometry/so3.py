"""SO(3) exp map (counterpart of orb_slam2_2021_tpu/geometry/so3.py)."""

from __future__ import annotations

import torch

from ..xmath import mm

_EPS = 1e-8


def so3_hat(w):
    """[..., 3] -> [..., 3, 3] skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def _eye_like(W):
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(w):
    """Rodrigues: [..., 3] axis-angle -> [..., 3, 3] rotation, with the
    reference's small-angle Taylor branch."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    W = so3_hat(w)
    W2 = mm(W, W)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * W2
