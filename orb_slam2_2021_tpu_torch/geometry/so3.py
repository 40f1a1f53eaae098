"""SO(3) exp and log maps (counterpart of orb_slam2_2021_tpu/geometry/so3.py)."""

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


def so3_log(R):
    """[..., 3, 3] rotation -> [..., 3] axis-angle (theta in [0, pi]).

    theta comes from atan2(|vee| / 2, cos), which stays differentiable at the
    identity; near theta = pi the axis is read from the diagonal, as in the
    reference."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    v = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin_t = 0.5 * torch.sqrt(torch.sum(v * v, dim=-1) + 1e-24)
    theta = torch.atan2(sin_t, cos_t)
    small = theta < 1e-4
    scale = torch.where(small, 0.5 + theta * theta / 12.0, theta / (2.0 * sin_t + _EPS))
    w = v * scale[..., None]
    near_pi = theta > 3.0
    # the clip floor stays positive so forward-mode derivatives through the
    # unselected branch stay finite near the identity
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    nn = torch.sqrt(torch.clamp((diag - cos_t[..., None]) / (1.0 - cos_t[..., None] + _EPS), 1e-12, 1.0))
    sx = torch.sign(torch.where(torch.abs(v[..., 0]) > _EPS, v[..., 0], torch.ones_like(v[..., 0])))
    sy = torch.sign(R[..., 0, 1] + R[..., 1, 0]) * sx
    sz = torch.sign(R[..., 0, 2] + R[..., 2, 0]) * sx
    n = nn * torch.stack([sx, sy, sz], dim=-1)
    return torch.where(near_pi[..., None], n * theta[..., None], w)
