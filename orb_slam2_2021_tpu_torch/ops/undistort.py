"""Keypoint undistortion, radial-tangential model (counterpart of
orb_slam2_2021_tpu/ops/undistort.py).

Model (OpenCV convention, coefficients k1 k2 p1 p2 k3):
    x' = x(1 + k1 r^2 + k2 r^4 + k3 r^6) + 2 p1 x y + p2 (r^2 + 2 x^2)
    y' = y(1 + k1 r^2 + k2 r^4 + k3 r^6) + p1 (r^2 + 2 y^2) + 2 p2 x y
The inverse is a fixed number of fixed-point iterations over the whole
[..., 2] batch, as cv::undistortPoints does.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _model(x, y, dist):
    k1, k2, p1, p2, k3 = dist
    r2 = x * x + y * y
    rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return rad, dx, dy


def distort_points(xy, fx, fy, cx, cy, dist: Sequence[float]):
    """Ideal pinhole pixel coordinates -> distorted ones (closed form)."""
    x = (xy[..., 0] - cx) / fx
    y = (xy[..., 1] - cy) / fy
    rad, dx, dy = _model(x, y, dist)
    return torch.stack([(x * rad + dx) * fx + cx, (y * rad + dy) * fy + cy], dim=-1)


def undistort_points(xy, fx, fy, cx, cy, dist: Sequence[float], iters: int = 10):
    """Distorted pixel coordinates -> ideal pinhole ones: x <- (xd -
    tangential(x)) / radial(x) from the distorted coordinates, `iters` times
    (10 for the strong freiburg1 lens)."""
    xd = (xy[..., 0] - cx) / fx
    yd = (xy[..., 1] - cy) / fy
    x, y = xd, yd
    for _ in range(iters):
        rad, dx, dy = _model(x, y, dist)
        rad = torch.clamp_min(rad, 1e-6)
        x = (xd - dx) / rad
        y = (yd - dy) / rad
    return torch.stack([x * fx + cx, y * fy + cy], dim=-1)
