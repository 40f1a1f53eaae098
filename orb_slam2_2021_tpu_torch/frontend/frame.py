"""Frame assembly for the three sensors (counterpart of
orb_slam2_2021_tpu/frontend/frame.py).

Stereo: both eyes are extracted as one batch of 2; stereo matching is a
row-banded masked Hamming argmin, an 11x11 SAD slide with parabola subpixel
refinement and a median outlier gate, all as dense tensor ops. RGB-D: one
image, depth read from the depth map, a virtual right eye. Monocular: one
image, no depth. RGB-D and monocular keypoints are undistorted when the
config carries a lens model. Spans (io/trace.py): `build.stereo`,
`build.depth` (depth lookup and undistortion), `build.undistort` (mono).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..io import trace
from ..ops.hamming import hamming_best2
from ..ops.image import pyramid_shapes
from ..ops.undistort import undistort_points
from .features import Keypoints, extract_orb, extract_orb_batched, gather_patches, level_scales

TH_ORB_STEREO = 75  # (TH_HIGH + TH_LOW) / 2, Frame.cc:576


class Frame(NamedTuple):
    kp: Keypoints            # left-eye keypoints (capacity N)
    u_right: torch.Tensor    # [N] float32; -1 = no stereo match
    depth: torch.Tensor      # [N] float32; -1 = unknown
    sad_dist: torch.Tensor   # [N] float32; stereo SAD residual (diagnostics)

    @property
    def n(self) -> int:
        return self.kp.capacity


def _gather_blocks(stack, oct_, y0, x0, bh: int, bw: int, level_h, level_w):
    """[L, H0, W0] stack -> [N, bh, bw] blocks at per-keypoint level corners,
    corners clamped inside each level's extent (a window that would leave the
    level is shifted, not cut)."""
    o = oct_.long()
    y0c = torch.minimum(torch.clamp_min(y0, 0), level_h[o] - bh)
    x0c = torch.minimum(torch.clamp_min(x0, 0), level_w[o] - bw)
    return gather_patches(stack[None], oct_[None], y0c[None], x0c[None], bh, bw)[0]


def stereo_match(kpl: Keypoints, kpr: Keypoints, left_stack, right_stack,
                 level_h, level_w, cfg):
    """Per-left-keypoint subpixel right-eye coordinate + depth.
    Returns (u_right, depth, sad_dist), each [N]."""
    N = kpl.capacity
    scale = level_scales(cfg.orb, kpl.xy.device)
    inv_scale = 1.0 / scale

    uL, vL = kpl.xy[:, 0], kpl.xy[:, 1]
    uR, vR = kpr.xy[:, 0], kpr.xy[:, 1]
    min_z = cfg.bf / cfg.fx
    min_d = 0.0
    max_d = cfg.bf / min_z

    # candidate mask (the row band uses the right keypoint's octave)
    row_tol = cfg.stereo.row_slack_levels * scale[kpr.octave.long()]
    row_ok = torch.abs(vL[:, None] - vR[None, :]) <= row_tol[None, :]
    oct_ok = (
        (kpr.octave[None, :] >= kpl.octave[:, None] - 1)
        & (kpr.octave[None, :] <= kpl.octave[:, None] + 1)
    )
    u_ok = (uR[None, :] >= uL[:, None] - max_d) & (uR[None, :] <= uL[:, None] - min_d)
    mask = row_ok & oct_ok & u_ok & kpl.valid[:, None] & kpr.valid[None, :]

    best_idx, best_dist, _, _ = hamming_best2(kpl.desc, kpr.desc, mask)
    matched = best_dist < TH_ORB_STEREO

    # SAD subpixel refinement at the left keypoint's octave
    w = cfg.stereo.sad_window
    L = cfg.stereo.search_range
    isc = inv_scale[kpl.octave.long()]
    uL_l = torch.round(uL * isc).to(torch.int32)
    vL_l = torch.round(vL * isc).to(torch.int32)
    uR0_l = torch.round(uR[best_idx] * isc).to(torch.int32)
    size = 2 * w + 1
    wide = 2 * (w + L) + 1

    patch_l = _gather_blocks(
        left_stack, kpl.octave, vL_l - w, uL_l - w, size, size, level_h, level_w
    ).to(torch.float32)
    strip_r = _gather_blocks(
        right_stack, kpl.octave, vL_l - w, uR0_l - w - L, size, wide, level_h, level_w
    ).to(torch.float32)
    patch_l = patch_l - patch_l[:, w:w + 1, w:w + 1]

    sads = []
    for inc in range(-L, L + 1):
        sub = strip_r[:, :, L + inc:L + inc + size]
        sub = sub - sub[:, w:w + 1, w:w + 1]
        sads.append(torch.sum(torch.abs(patch_l - sub), dim=(1, 2)))
    sads = torch.stack(sads, dim=1)                                   # [N, 2L+1]
    best_inc_idx = torch.argmin(sads, dim=1)
    best_sad = torch.gather(sads, 1, best_inc_idx[:, None])[:, 0]
    at_border = (best_inc_idx == 0) | (best_inc_idx == 2 * L)

    # parabola refinement (Frame.cc:650-655)
    i1 = torch.clamp(best_inc_idx - 1, 0, 2 * L)
    i3 = torch.clamp(best_inc_idx + 1, 0, 2 * L)
    d1 = torch.gather(sads, 1, i1[:, None])[:, 0]
    d3 = torch.gather(sads, 1, i3[:, None])[:, 0]
    denom = 2.0 * (d1 + d3 - 2.0 * best_sad)
    delta = torch.where(torch.abs(denom) > 1e-6, (d1 - d3) / denom, torch.zeros_like(denom))
    delta_ok = (delta >= -1.0) & (delta <= 1.0)

    sc = scale[kpl.octave.long()]
    best_inc = (best_inc_idx - L).to(torch.float32)
    u_r_refined = sc * (uR0_l.to(torch.float32) + best_inc + delta)

    disparity = uL - u_r_refined
    # disparity in (-1, 0] snaps to 0.01 (Frame.cc:668-671)
    snap = (disparity <= 0.0) & (disparity > -1.0)
    disparity = torch.where(snap, torch.full_like(disparity, 0.01), disparity)
    u_r_refined = torch.where(snap, uL - 0.01, u_r_refined)
    disp_ok = (disparity >= min_d) & (disparity < max_d)
    ok = matched & ~at_border & delta_ok & disp_ok & kpl.valid

    # median outlier gate (Frame.cc:686-699)
    sad_masked = torch.where(ok, best_sad, torch.full_like(best_sad, float("inf")))
    n_ok = torch.sum(ok)
    sorted_sad = torch.sort(sad_masked).values
    median = sorted_sad[torch.clamp(n_ok // 2, 0, N - 1)]
    ok = ok & (best_sad < cfg.stereo.median_gate * median)

    neg = torch.full_like(disparity, -1.0)
    depth = torch.where(ok, cfg.bf / torch.clamp_min(disparity, 1e-6), neg)
    u_right = torch.where(ok, u_r_refined, neg)
    return u_right, depth, torch.where(ok, best_sad, neg)


def build_stereo_frame(image_left, image_right, cfg):
    """[H, W] float32 pair -> Frame; both eyes extracted as one batch, the
    raw canvas reused for the SAD refinement."""
    kp2, raw_stack = extract_orb_batched(torch.stack([image_left, image_right]), cfg.orb)
    kpl = Keypoints(*(x[0] for x in kp2))
    kpr = Keypoints(*(x[1] for x in kp2))
    with trace.span("build.stereo"):
        h0, w0 = image_left.shape
        shapes = pyramid_shapes(h0, w0, cfg.orb.n_levels, cfg.orb.scale_factor)
        dev = image_left.device
        level_h = torch.from_numpy(np.asarray([s[0] for s in shapes], np.int32)).to(dev)
        level_w = torch.from_numpy(np.asarray([s[1] for s in shapes], np.int32)).to(dev)
        u_right, depth, sad = stereo_match(
            kpl, kpr, raw_stack[0], raw_stack[1], level_h, level_w, cfg
        )
    return Frame(kp=kpl, u_right=u_right, depth=depth, sad_dist=sad)


def build_stereo_frame_from_u8(images_u8, cfg):
    """Stereo frame from one stacked [2, H, W] uint8 tensor."""
    return build_stereo_frame(
        images_u8[0].to(torch.float32), images_u8[1].to(torch.float32), cfg
    )


def _undistort_kp(kp: Keypoints, cfg) -> Keypoints:
    """Keypoint coordinates mapped to the ideal pinhole camera when the
    config carries lens distortion; unchanged with zero coefficients."""
    if not any(cfg.dist_coef):
        return kp
    return kp._replace(xy=undistort_points(kp.xy, cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.dist_coef))


def build_rgbd_frame(image, depth_map, cfg, depth_scale: float = 1.0):
    """RGB-D pseudo-stereo from an [H, W] float32 image and depth map.
    Depth is read at the raw (distorted) rounded keypoint coordinates, since
    the depth image is aligned with the raw image; the virtual right-eye
    coordinate uses the undistorted x."""
    kp = extract_orb(image, cfg.orb)
    with trace.span("build.depth"):
        h, w = depth_map.shape
        xs = torch.clamp(torch.round(kp.xy[:, 0]).to(torch.int64), 0, w - 1)
        ys = torch.clamp(torch.round(kp.xy[:, 1]).to(torch.int64), 0, h - 1)
        d = depth_map.reshape(-1)[ys * w + xs] * depth_scale
        kp = _undistort_kp(kp, cfg)
        ok = (d > 0) & kp.valid
        neg = torch.full_like(d, -1.0)
        u_right = torch.where(ok, kp.xy[:, 0] - cfg.bf / torch.clamp_min(d, 1e-6), neg)
        return Frame(kp=kp, u_right=u_right, depth=torch.where(ok, d, neg), sad_dist=neg)


def build_mono_frame(image, cfg):
    """Monocular frame from an [H, W] float32 image: undistorted keypoints,
    no right eye and no depth."""
    kp = extract_orb(image, cfg.orb)
    with trace.span("build.undistort"):
        kp = _undistort_kp(kp, cfg)
        neg = torch.full((kp.capacity,), -1.0, dtype=torch.float32, device=image.device)
        return Frame(kp=kp, u_right=neg, depth=neg, sad_dist=neg)
