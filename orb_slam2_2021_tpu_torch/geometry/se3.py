"""SE(3) as (R, t) pairs (counterpart of orb_slam2_2021_tpu/geometry/se3.py).

Tcw convention: x_c = R x_w + t.
"""

from __future__ import annotations

import torch

from ..xmath import apply_R, mm
from .so3 import _eye_like, so3_exp, so3_hat

_EPS = 1e-8


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


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) o (Rb, tb): apply b first, then a."""
    return mm(Ra, Rb), apply_R(Ra, tb) + ta
