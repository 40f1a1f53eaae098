"""Sim(3): similarity transforms (s, R, t) for loop closure (counterpart of
orb_slam2_2021_tpu/geometry/sim3.py).

A transform is a tuple (s: [...], R: [..., 3, 3], t: [..., 3]) with
x' = s R x + t. exp/log use the closed form t = W(w, sigma) v, with the
reference's small-angle and small-sigma branches as `torch.where`, so the
maps are smooth and every branch is evaluated on the device.
"""

from __future__ import annotations

import torch

from ..xmath import apply_R, mm
from .so3 import _eye_like, so3_exp, so3_hat, so3_log

_EPS = 1e-8


def sim3_identity(batch_shape=(), dtype=torch.float32, device=None):
    s = torch.ones(batch_shape, dtype=dtype, device=device)
    R = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3)
    t = torch.zeros((*batch_shape, 3), dtype=dtype, device=device)
    return s, R, t


def sim3_compose(sa, Ra, ta, sb, Rb, tb):
    """a o b (apply b first)."""
    return sa * sb, mm(Ra, Rb), sa[..., None] * apply_R(Ra, tb) + ta


def sim3_inverse(s, R, t):
    sinv = 1.0 / s
    Rinv = R.transpose(-1, -2)
    return sinv, Rinv, -sinv[..., None] * apply_R(Rinv, t)


def sim3_apply(s, R, t, x):
    return s[..., None] * apply_R(R, x) + t


def _W_matrix(w, sigma):
    """W such that t = W v in the Sim(3) exponential."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    Wh = so3_hat(w)
    Wh2 = mm(Wh, Wh)
    one = torch.ones_like(sigma)

    s = torch.exp(sigma)
    sig2 = sigma * sigma
    small_sig = torch.abs(sigma) < 1e-5
    small_th = theta < 1e-5
    safe_sig = torch.where(small_sig, one, sigma)
    safe_th = torch.where(small_th, one, theta)
    safe_th2 = torch.where(small_th, one, theta2)

    C = torch.where(small_sig, 1.0 + 0.5 * sigma + sig2 / 6.0, (s - 1.0) / safe_sig)

    A_ss = torch.where(small_th, 0.5 * one, (1.0 - torch.cos(theta)) / safe_th2)
    B_ss = torch.where(small_th, one / 6.0, (theta - torch.sin(theta)) / (safe_th2 * safe_th))

    a_ = s * torch.sin(theta)
    b_ = s * torch.cos(theta)
    c_ = theta2 + sig2
    safe_c = torch.where(c_ < _EPS, one, c_)
    A_ls_th = (a_ * sigma + (1.0 - b_) * theta) / (safe_th * safe_c)
    B_ls_th = (C - ((b_ - 1.0) * sigma + a_ * theta) / safe_c) / safe_th2
    A_ls_0 = ((sigma - 1.0) * s + 1.0) / torch.where(small_sig, one, sig2)
    B_ls_0 = (s * 0.5 * sig2 + s - 1.0 - sigma * s) / torch.where(small_sig, one, sig2 * safe_sig)
    A_ls = torch.where(small_th, A_ls_0, A_ls_th)
    B_ls = torch.where(small_th, B_ls_0, B_ls_th)

    A = torch.where(small_sig, A_ss, A_ls)
    B = torch.where(small_sig, B_ss, B_ls)
    return C[..., None, None] * _eye_like(Wh) + A[..., None, None] * Wh + B[..., None, None] * Wh2


def sim3_exp(xi):
    """[..., 7] twist (upsilon, omega, sigma) -> (s, R, t); sigma is the
    log-scale."""
    v, w, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    return torch.exp(sigma), so3_exp(w), apply_R(_W_matrix(w, sigma), v)


def solve3(A, b):
    """Batched 3x3 solve A x = b by the adjugate: elementwise ops only, so it
    never waits for the device and has forward-mode derivatives."""
    a, bb, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    c00, c01, c02 = e * i - f * h, c * h - bb * i, bb * f - c * e
    c10, c11, c12 = f * g - d * i, a * i - c * g, c * d - a * f
    c20, c21, c22 = d * h - e * g, bb * g - a * h, a * e - bb * d
    det = a * c00 + bb * c10 + c * c20
    x0 = c00 * b[..., 0] + c01 * b[..., 1] + c02 * b[..., 2]
    x1 = c10 * b[..., 0] + c11 * b[..., 1] + c12 * b[..., 2]
    x2 = c20 * b[..., 0] + c21 * b[..., 1] + c22 * b[..., 2]
    return torch.stack([x0, x1, x2], dim=-1) / det[..., None]


def sim3_log(s, R, t):
    """(s, R, t) -> [..., 7] twist (v, w, sigma)."""
    sigma = torch.log(s)
    w = so3_log(R)
    v = solve3(_W_matrix(w, sigma), t)
    return torch.cat([v, w, sigma[..., None]], dim=-1)
