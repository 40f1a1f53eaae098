"""Stereo undistortion and rectification (counterpart of
orb_slam2_2021_tpu/io/rectify.py).

The upstream arducam program reads the LEFT./RIGHT. K, D, R, P blocks of
its settings YAML, builds initUndistortRectifyMap-style sampling maps once,
and remaps every frame before tracking.

Map construction is host code (numpy, once): for each rectified pixel,
back-project with P^-1, rotate by R^-1, apply the radial/tangential
distortion model, project with K. The per-frame `remap` is a bilinear
gather on the device, with the reference's `map_coordinates(order=1,
mode="constant")` semantics: each of the four corners adds its weight times
the pixel when it lies inside the image, and nothing when it lies outside.
The gather indices and corner weights depend only on the maps, so they are
made once per maps and device and kept.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np
import torch

from .. import resolve_device


@dataclass(frozen=True)
class RectifyMaps:
    map_y: np.ndarray  # [H, W] float32 source row per rectified pixel
    map_x: np.ndarray  # [H, W] float32 source col
    # per device: (flat indices [4, H*W] int64, corner weights [4, H*W] f32)
    _gather: Dict[str, Tuple[torch.Tensor, torch.Tensor]] = field(
        default_factory=dict, init=False, repr=False, compare=False)


def build_rectify_map(K, D, R, P, size: Tuple[int, int]) -> RectifyMaps:
    """size = (width, height) of the rectified output."""
    K = np.asarray(K, np.float64)
    D = np.asarray(D, np.float64).ravel()
    D = np.pad(D, (0, max(0, 5 - len(D))))[:5]
    R = np.asarray(R, np.float64)
    P = np.asarray(P, np.float64)
    w, h = size
    u, v = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    fx_p, fy_p = P[0, 0], P[1, 1]
    cx_p, cy_p = P[0, 2], P[1, 2]
    x = (u - cx_p) / fx_p
    y = (v - cy_p) / fy_p
    ones = np.ones_like(x)
    rays = np.stack([x, y, ones], axis=-1) @ R  # R^-1 applied as row-vector @ R
    xs = rays[..., 0] / rays[..., 2]
    ys = rays[..., 1] / rays[..., 2]
    k1, k2, p1, p2, k3 = D
    r2 = xs * xs + ys * ys
    rad = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
    xd = xs * rad + 2 * p1 * xs * ys + p2 * (r2 + 2 * xs * xs)
    yd = ys * rad + p1 * (r2 + 2 * ys * ys) + 2 * p2 * xs * ys
    map_x = (K[0, 0] * xd + K[0, 2]).astype(np.float32)
    map_y = (K[1, 1] * yd + K[1, 2]).astype(np.float32)
    return RectifyMaps(map_y=map_y, map_x=map_x)


def _gather_plan(maps: RectifyMaps, dev: torch.device, shape: Tuple[int, int]):
    """The four corners of every output pixel as flat source indices
    (clamped into the image) and weights (0 for a corner outside it), in
    the reference's corner order (row-major over (lower, upper) row, then
    column). The weights follow the reference: lo = floor(c), w_hi = c - lo,
    w_lo = 1 - w_hi, in float32, and a corner's weight is w_row * w_col."""
    key = f"{dev}:{shape[0]}x{shape[1]}"
    plan = maps._gather.get(key)
    if plan is not None:
        return plan
    H, W = shape
    corners = []
    for c in (maps.map_y, maps.map_x):
        c = torch.from_numpy(np.ascontiguousarray(c, np.float32)).to(dev).reshape(-1)
        lo = torch.floor(c)
        w_hi = c - lo
        i_lo = lo.to(torch.int64)
        corners.append(((i_lo, 1 - w_hi), (i_lo + 1, w_hi)))
    idx, wts = [], []
    for iy, wy in corners[0]:
        for ix, wx in corners[1]:
            inside = (iy >= 0) & (iy < H) & (ix >= 0) & (ix < W)
            idx.append(iy.clamp(0, H - 1) * W + ix.clamp(0, W - 1))
            wts.append(torch.where(inside, wy * wx, torch.zeros_like(wy)))
    plan = (torch.stack(idx), torch.stack(wts))
    maps._gather[key] = plan
    return plan


def remap(image, maps: RectifyMaps, device="cuda") -> torch.Tensor:
    """Bilinear remap of a [H, W] image (numpy or tensor; uint8 travels as
    uint8 and is cast on the device) by `maps` on `device`; a rectified
    pixel reads 0 where all four of its corners fall outside the source.
    Returns a float32 [H_out, W_out] tensor on `device`. Images are finite
    (a corner outside the source is weighted 0, not masked)."""
    dev = resolve_device(device)
    if isinstance(image, torch.Tensor):
        img = image.to(dev)
    else:
        a = np.asarray(image)
        if a.dtype != np.uint8:
            a = a.astype(np.float32, copy=False)
        img = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    if img.dim() != 2:
        raise ValueError(f"remap takes a [H, W] image, not shape {tuple(img.shape)}")
    idx, wts = _gather_plan(maps, dev, tuple(img.shape))
    c = wts * img.to(torch.float32).reshape(-1)[idx]
    out = ((c[0] + c[1]) + c[2]) + c[3]
    return out.reshape(maps.map_y.shape)


def rectification_from_yaml(path: str):
    """(left_maps, right_maps) from a reference-format settings YAML with
    LEFT./RIGHT. K, D, R, P blocks (the upstream arducam settings). Raises
    KeyError if the blocks are absent (pre-rectified datasets like KITTI)."""
    from ..config import _parse_opencv_yaml

    scalars, mats = _parse_opencv_yaml(path)
    w = int(scalars.get("LEFT.width", scalars.get("Camera.width")))
    h = int(scalars.get("LEFT.height", scalars.get("Camera.height")))
    left = build_rectify_map(
        mats["LEFT.K"], mats["LEFT.D"], mats["LEFT.R"], mats["LEFT.P"], (w, h)
    )
    right = build_rectify_map(
        mats["RIGHT.K"], mats["RIGHT.D"], mats["RIGHT.R"], mats["RIGHT.P"], (w, h)
    )
    return left, right
