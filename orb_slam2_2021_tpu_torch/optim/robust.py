"""Robust kernel and reprojection residual/Jacobian blocks (counterpart of
orb_slam2_2021_tpu/optim/robust.py).

Residual convention: e = z - proj(X_c), X_c = R X_w + t (Tcw). Pose updates
are left-multiplicative: T <- exp(delta) * T with delta = (v, w).
"""

from __future__ import annotations

import torch

from ..geometry.camera import PinholeCamera


def huber_weight(chi2, delta2):
    """Huber IRLS weight: 1 inside delta, delta/|e| outside (delta2 = delta^2)."""
    return torch.where(
        chi2 <= delta2,
        torch.ones_like(chi2),
        torch.sqrt(delta2 / torch.clamp_min(chi2, 1e-12)),
    )


def _safe_z(z):
    return torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def stereo_residual(cam: PinholeCamera, Xc, obs_uvr):
    """[..., 3] camera points, [..., 3] (u, v, u_r) observations -> [..., 3]."""
    inv_z = 1.0 / _safe_z(Xc[..., 2])
    u = cam.fx * Xc[..., 0] * inv_z + cam.cx
    v = cam.fy * Xc[..., 1] * inv_z + cam.cy
    ur = u - cam.bf * inv_z
    return obs_uvr - torch.stack([u, v, ur], dim=-1)


def mono_residual(cam: PinholeCamera, Xc, obs_uv):
    inv_z = 1.0 / _safe_z(Xc[..., 2])
    u = cam.fx * Xc[..., 0] * inv_z + cam.cx
    v = cam.fy * Xc[..., 1] * inv_z + cam.cy
    return obs_uv - torch.stack([u, v], dim=-1)


def proj_jacobian_stereo(cam: PinholeCamera, Xc):
    """d (u, v, u_r) / d Xc: [..., 3, 3]."""
    x, y = Xc[..., 0], Xc[..., 1]
    iz = 1.0 / _safe_z(Xc[..., 2])
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    row_u = torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], dim=-1)
    row_v = torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], dim=-1)
    row_r = torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2 + cam.bf * iz2], dim=-1)
    return torch.stack([row_u, row_v, row_r], dim=-2)


def proj_jacobian_mono(cam: PinholeCamera, Xc):
    """d (u, v) / d Xc: [..., 2, 3]."""
    x, y = Xc[..., 0], Xc[..., 1]
    iz = 1.0 / _safe_z(Xc[..., 2])
    iz2 = iz * iz
    zero = torch.zeros_like(x)
    row_u = torch.stack([cam.fx * iz, zero, -cam.fx * x * iz2], dim=-1)
    row_v = torch.stack([zero, cam.fy * iz, -cam.fy * y * iz2], dim=-1)
    return torch.stack([row_u, row_v], dim=-2)


def point_jacobian_pose(Xc):
    """d Xc / d delta for the left-multiplicative update: [..., 3, 6]
    (columns v then w), i.e. [I | -[Xc]x]."""
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    r0 = torch.stack([one, zero, zero, zero, z, -y], dim=-1)
    r1 = torch.stack([zero, one, zero, -z, zero, x], dim=-1)
    r2 = torch.stack([zero, zero, one, y, -x, zero], dim=-1)
    return torch.stack([r0, r1, r2], dim=-2)
