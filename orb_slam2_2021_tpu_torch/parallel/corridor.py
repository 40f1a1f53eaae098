"""Banded corridor bundle-adjustment problems built in numpy, for the
multi-GPU bring-up and the card checks at the size of a long drive.

The layout follows scripts/scale_1500kf.py: keyframes every 0.5 m along a
straight corridor, each creating about n_pts / n_kf new points, and the
rest of the observations re-observations of points made by the previous
`window` keyframes, which gives the banded covisibility of a real
trajectory. Observations are projections through the camera (80% stereo)
plus pixel noise; poses other than the fixed ones and all points start
perturbed. The problem is flat (observations ordered by point), padded to
the given shapes, with the per-point reverse index pt_obs.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..optim.ba import BAProblem


def _rot(w):
    """Rodrigues: [n, 3] rotation vectors -> [n, 3, 3]."""
    th = np.linalg.norm(w, axis=1)[:, None, None]
    k = w / np.maximum(np.linalg.norm(w, axis=1, keepdims=True), 1e-12)
    K = np.zeros((len(w), 3, 3))
    K[:, 0, 1], K[:, 0, 2], K[:, 1, 2] = -k[:, 2], k[:, 1], -k[:, 0]
    K = K - K.transpose(0, 2, 1)
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def corridor_problem(cam, n_kf: int, n_pts: int, n_obs: int, seed: int, window: int = 8,
                     n_fixed: int = 1, C_pad: Optional[int] = None, P_pad: Optional[int] = None,
                     O_pad: Optional[int] = None, noise_px: float = 0.5,
                     pose_err: float = 0.002, point_err: float = 0.05):
    """(prob, R_gt, t_gt, xw_gt): a host (numpy) BAProblem of n_kf cameras
    (the first n_fixed fixed), n_pts points and n_obs observations, each
    point seen by its first keyframe and at most `window` later ones
    (pt_obs width window + 1)."""
    rng = np.random.default_rng(seed)
    n_extra = n_obs - n_pts
    C_pad, P_pad, O_pad = C_pad or n_kf, P_pad or n_pts, O_pad or n_obs
    if n_extra < 0 or n_kf > C_pad or n_pts > P_pad or n_obs > O_pad:
        raise ValueError("the counts exceed the padding, or n_obs < n_pts")
    first = (np.arange(n_pts, dtype=np.int64) * n_kf) // n_pts
    xw = np.stack([0.5 * first + rng.uniform(-4, 4, n_pts), rng.uniform(-3, 3, n_pts),
                   rng.uniform(4, 30, n_pts)], 1)

    # re-observations: distinct (point, later keyframe) pairs inside the band
    lag = np.tile(np.arange(1, window + 1), n_pts)
    pt_c = np.repeat(np.arange(n_pts), window)
    ok = first[pt_c] + lag < n_kf
    cand = np.nonzero(ok)[0]
    if n_extra > len(cand):
        raise ValueError(f"{n_extra} re-observations asked for, {len(cand)} possible")
    pick = np.sort(rng.choice(cand, n_extra, replace=False))
    obs_pt = np.concatenate([np.arange(n_pts), pt_c[pick]])
    obs_kf = np.concatenate([first, first[pt_c[pick]] + lag[pick]])
    order = np.lexsort((obs_kf, obs_pt))
    obs_pt, obs_kf = obs_pt[order], obs_kf[order]

    t_gt = np.zeros((n_kf, 3))
    t_gt[:, 0] = -0.5 * np.arange(n_kf)
    xc = xw[obs_pt] + t_gt[obs_kf]
    u = cam.fx * xc[:, 0] / xc[:, 2] + cam.cx
    v = cam.fy * xc[:, 1] / xc[:, 2] + cam.cy
    ur = np.where(rng.random(n_obs) < 0.8, u - cam.bf / xc[:, 2], -1.0)
    uvr = np.stack([u, v, ur], 1) + rng.normal(0, noise_px, (n_obs, 3)) * (np.stack([u, v, ur], 1) >= 0)

    f32 = np.float32
    R0 = np.tile(np.eye(3, dtype=f32), (C_pad, 1, 1))
    t0 = np.zeros((C_pad, 3), f32)
    R0[n_fixed:n_kf] = _rot(rng.normal(0, pose_err, (n_kf - n_fixed, 3)))
    t0[:n_kf] = t_gt + np.where(np.arange(n_kf)[:, None] >= n_fixed,
                                rng.normal(0, 10 * pose_err, (n_kf, 3)), 0.0)
    x0 = np.zeros((P_pad, 3), f32)
    x0[:n_pts] = xw + rng.normal(0, point_err, xw.shape)

    def pad(a, n, fill, dtype):
        out = np.full((n,) + a.shape[1:], fill, dtype)
        out[: len(a)] = a
        return out

    starts = np.searchsorted(obs_pt, np.arange(n_pts))
    slot = np.arange(n_obs) - starts[obs_pt]
    pt_obs = np.full((P_pad, window + 1), -1, np.int32)
    pt_obs[obs_pt, slot] = np.arange(n_obs)
    free = np.zeros(C_pad, bool)
    free[n_fixed:n_kf] = True
    prob = BAProblem(
        R=R0, t=t0, xw=x0, obs_cam=pad(obs_kf, O_pad, 0, np.int32),
        obs_pt=pad(obs_pt, O_pad, 0, np.int32), obs_uvr=pad(uvr, O_pad, -1.0, f32),
        obs_inv_sigma2=np.ones(O_pad, f32), obs_valid=np.arange(O_pad) < n_obs,
        pt_obs=pt_obs, cam_free=free)
    return prob, np.tile(np.eye(3), (n_kf, 1, 1)), t_gt, xw
