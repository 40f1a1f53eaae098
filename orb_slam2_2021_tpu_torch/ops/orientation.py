"""Intensity-centroid keypoint orientation (counterpart of
orb_slam2_2021_tpu/ops/orientation.py `angles_from_patches`)."""

from __future__ import annotations

import functools

import numpy as np
import torch

HALF_PATCH = 15
PATCH = 2 * HALF_PATCH + 1


@functools.lru_cache(maxsize=1)
def moment_matrix() -> np.ndarray:
    """[961, 2] float32: circular-mask (dy, dx) weights giving (m01, m10)."""
    ys = np.arange(-HALF_PATCH, HALF_PATCH + 1, dtype=np.float32)
    dy = ys[:, None] * np.ones((1, PATCH), np.float32)
    dx = ys[None, :] * np.ones((PATCH, 1), np.float32)
    mask = ((dy * dy + dx * dx) <= float(HALF_PATCH * HALF_PATCH)).astype(np.float32)
    return np.stack([(mask * dy).reshape(-1), (mask * dx).reshape(-1)], axis=1)


@functools.lru_cache(maxsize=8)
def _moment_matrix_on(device: str):
    return torch.from_numpy(moment_matrix()).to(device)


def angles_from_patches(patches):
    """IC angles from [..., 961] patches (31x31 row-major) -> [...] radians.

    The moments are one float32 [N, 961] x [961, 2] product; each product of
    a bf16 sample and an integer weight is exact, only the summation order
    differs from the reference's bf16-in / f32-accumulate dot."""
    lead = patches.shape[:-1]
    m = torch.matmul(
        patches.reshape(-1, PATCH * PATCH).to(torch.float32),
        _moment_matrix_on(str(patches.device)),
    )
    return torch.atan2(m[:, 0], m[:, 1]).reshape(lead)
