"""Small float32 contractions.

Counterpart of orb_slam2_2021_tpu/xmath.py. PyTorch runs float32 products in
full float32 (TF32 is switched off at package import), so the reference's
HIGHEST-precision helpers become plain products here.
"""

from __future__ import annotations

import torch


def mm(a, b):
    """Matmul at full float32 precision."""
    return torch.matmul(a, b)


def apply_R(R, x):
    """[..., 3, 3] @ [..., 3] -> [..., 3]."""
    return torch.einsum("...ij,...j->...i", R, x)


def smm(a, b):
    """[..., m, k] @ [..., k, n] -> [..., m, n] (tiny m/k/n, large batch)."""
    return torch.sum(a[..., :, :, None] * b[..., None, :, :], dim=-2)


def smv(a, v):
    """[..., m, k] @ [..., k] -> [..., m]."""
    return torch.sum(a * v[..., None, :], dim=-1)


def stmv(a, v):
    """sum_k a[..., k, m] * v[..., k] -> [..., m] (a^T v)."""
    return torch.sum(a * v[..., :, None], dim=-2)


def souter(a, b):
    """sum_r a[..., r, m] * b[..., r, n] -> [..., m, n] (J^T J blocks)."""
    return torch.sum(a[..., :, :, None] * b[..., :, None, :], dim=-3)
