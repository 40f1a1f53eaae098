"""SO(3) exp and log maps and the quaternion maps (counterpart of
orb_slam2_2021_tpu/geometry/so3.py)."""

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


def rot_to_quat(R):
    """[..., 3, 3] rotation -> [..., 4] quaternion (w, x, y, z), w >= 0, by
    Shepperd's method: the construction of the largest of four candidates,
    selected without branches."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.sqrt(torch.clamp_min(1.0 + tr, 0.0)) * 0.5
    qx = torch.sqrt(torch.clamp_min(1.0 + m00 - m11 - m22, 0.0)) * 0.5
    qy = torch.sqrt(torch.clamp_min(1.0 - m00 + m11 - m22, 0.0)) * 0.5
    qz = torch.sqrt(torch.clamp_min(1.0 - m00 - m11 + m22, 0.0)) * 0.5
    c0 = torch.stack([qw, (m21 - m12) / (4 * qw + _EPS), (m02 - m20) / (4 * qw + _EPS),
                      (m10 - m01) / (4 * qw + _EPS)], dim=-1)
    c1 = torch.stack([(m21 - m12) / (4 * qx + _EPS), qx, (m01 + m10) / (4 * qx + _EPS),
                      (m02 + m20) / (4 * qx + _EPS)], dim=-1)
    c2 = torch.stack([(m02 - m20) / (4 * qy + _EPS), (m01 + m10) / (4 * qy + _EPS), qy,
                      (m12 + m21) / (4 * qy + _EPS)], dim=-1)
    c3 = torch.stack([(m10 - m01) / (4 * qz + _EPS), (m02 + m20) / (4 * qz + _EPS),
                      (m12 + m21) / (4 * qz + _EPS), qz], dim=-1)
    cands = torch.stack([c0, c1, c2, c3], dim=-2)                               # [..., 4, 4]
    mags = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], dim=-1)
    idx = torch.argmax(mags, dim=-1)
    q = torch.gather(cands, -2, idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    # the squared norm as a chain of fused multiply-adds (each product and
    # sum rounded once), as the reference's compiled program sums it: the
    # written quaternions then carry the reference's digits
    n2 = q[..., 0] * q[..., 0]
    for i in (1, 2, 3):
        n2 = (q[..., i].double() * q[..., i].double() + n2.double()).to(q.dtype)
    q = q / (torch.sqrt(n2)[..., None] + _EPS)
    return q * torch.sign(q[..., :1] + _EPS)


def quat_to_rot(q):
    """[..., 4] quaternion (w, x, y, z) -> [..., 3, 3] rotation (q is
    normalized first)."""
    q = q / (torch.linalg.norm(q, dim=-1, keepdim=True) + _EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )
