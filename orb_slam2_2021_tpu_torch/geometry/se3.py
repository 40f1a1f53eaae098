"""SE(3) as (R, t) pairs (counterpart of orb_slam2_2021_tpu/geometry/se3.py).

Tcw convention: x_c = R x_w + t.
"""

from __future__ import annotations

import torch

from ..xmath import apply_R, mm
from .sim3 import solve3
from .so3 import _eye_like, so3_exp, so3_hat, so3_log

_EPS = 1e-8


def se3_identity(batch_shape=(), dtype=torch.float32, device=None):
    R = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3)
    t = torch.zeros((*batch_shape, 3), dtype=dtype, device=device)
    return R, t


def se3_from_Rt(R, t):
    return torch.as_tensor(R), torch.as_tensor(t)


def _V_matrix(w):
    """Left Jacobian of SO(3): t = V @ upsilon in the se3 exp."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < 1e-8
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0, (theta - torch.sin(theta)) / (theta2 * theta)
    )
    W = so3_hat(w)
    W2 = mm(W, W)
    return _eye_like(W) + b[..., None, None] * W + c[..., None, None] * W2


def se3_exp(xi):
    """[..., 6] twist (upsilon, omega) -> (R, t)."""
    v, w = xi[..., :3], xi[..., 3:]
    return so3_exp(w), apply_R(_V_matrix(w), v)


def se3_log(R, t):
    """(R, t) -> [..., 6] twist (v, w). The batched 3x3 solve is the
    closed-form `sim3.solve3`: elementwise, no batched cuSOLVER call."""
    w = so3_log(R)
    v = solve3(_V_matrix(w), t)
    return torch.cat([v, w], dim=-1)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) o (Rb, tb): apply b first, then a."""
    return mm(Ra, Rb), apply_R(Ra, tb) + ta


def se3_inverse(R, t):
    Rinv = torch.swapaxes(R, -1, -2)
    return Rinv, -apply_R(Rinv, t)


def se3_apply(R, t, x):
    """Apply the transform to points x [..., 3] (broadcasting over leading
    dims)."""
    return apply_R(R, x) + t


def mat44(R, t):
    """(R, t) -> [..., 4, 4] homogeneous matrix."""
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype, device=R.device)
    bottom = bottom.expand(*R.shape[:-2], 1, 4)
    top = torch.cat([R, t[..., :, None]], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def from_mat44(T):
    return T[..., :3, :3], T[..., :3, 3]
