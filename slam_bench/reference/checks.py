"""The comparisons that decide `correct`, in plain numpy.

Three numbers, one for each layer the cells exercise:

- `feature_diff`: the frame build. The program's features of a frame
  against the reference's, recomputed from the same images: 1 - |P & R| /
  |P | R| over features keyed by position, level and descriptor, a feature
  of P matching one of R only where its right-eye coordinate and depth agree
  too. 0 is an exact reproduction.
- `ate_percent`: tracking. The RMSE of the camera centres the program
  returned, after the rigid (rotation and translation, no scale) alignment
  to the ground truth the frames were rendered from, as a share of the
  ground-truth path.
- `map_error_percent`: local mapping. The median over the map's points of
  |z - surface depth at (x, y)| / surface depth, in the world frame, which
  is the first camera's, as the generator's.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

RIGHT_TOL_PX = 1e-3       # right-eye coordinates agree to well under a float32 rounding of the subpixel fit
DEPTH_TOL_REL = 1e-4      # depths agree to a relative 1e-4


def _keys(xy, octave, desc):
    q = np.round(np.asarray(xy, np.float64) * 1000.0).astype(np.int64)
    d = np.ascontiguousarray(np.asarray(desc, np.int32))
    return [(int(q[i, 0]), int(q[i, 1]), int(octave[i]), d[i].tobytes()) for i in range(len(q))]


def feature_diff(prog: dict, ref: dict) -> float:
    """Jaccard distance between two frames' valid features. Each dict holds
    numpy `xy` [N, 2], `octave` [N], `desc` [N, 8], `valid` [N], `u_right`
    [N] and `depth` [N] (-1 where there is none)."""
    def index(f):
        v = np.asarray(f["valid"], bool)
        keys = _keys(f["xy"][v], f["octave"][v], f["desc"][v])
        out = defaultdict(list)
        for k, ur, d in zip(keys, f["u_right"][v], f["depth"][v]):
            out[k].append((float(ur), float(d)))
        return out, int(v.sum())

    p, n_p = index(prog)
    r, n_r = index(ref)
    both = 0
    for k, vals in p.items():
        cands = list(r.get(k, ()))
        for ur, d in vals:
            for j, (ur2, d2) in enumerate(cands):
                if (abs(ur - ur2) <= RIGHT_TOL_PX
                        and abs(d - d2) <= DEPTH_TOL_REL * max(abs(d2), 1.0)):
                    both += 1
                    del cands[j]
                    break
    union = n_p + n_r - both
    return 0.0 if union == 0 else 1.0 - both / union


def rigid_align(src, dst, scale: bool = False):
    """(M, t) minimising |M src + t - dst| (Umeyama); src, dst [N, 3]. M is
    a rotation, or with `scale` a rotation times a scale (a monocular
    trajectory is known up to scale)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    ms, md = src.mean(0), dst.mean(0)
    cov = (dst - md).T @ (src - ms) / len(src)
    u, sv, vt = np.linalg.svd(cov)
    s = np.eye(3)
    if np.linalg.det(u) * np.linalg.det(vt) < 0:
        s[2, 2] = -1.0
    R = u @ s @ vt
    if scale:
        var = float(((src - ms) ** 2).sum()) / len(src)
        R = R * (float(np.trace(np.diag(sv) @ s)) / max(var, 1e-300))
    return R, md - R @ ms


def ate_percent(est_centres, gt_centres, scale: bool = False) -> float:
    """Aligned RMSE of the camera centres as a percentage of the ground-truth
    path length (aligned with a scale too where `scale`)."""
    est = np.asarray(est_centres, np.float64)
    gt = np.asarray(gt_centres, np.float64)
    R, t = rigid_align(est, gt, scale)
    err = est @ R.T + t - gt
    rmse = float(np.sqrt(np.mean(np.sum(err * err, axis=1))))
    length = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    return 100.0 * rmse / max(length, 1e-9)


def surface_depth(grid, x0, y0, cell, x, y):
    """The world's surface depth at world (x, y): bilinear over the depth
    grid [gh, gw] whose node (0, 0) sits at (x0, y0), `cell` metres apart,
    clamped at its edges (the generator's own rule)."""
    g = np.asarray(grid, np.float64)
    gh, gw = g.shape
    gx = np.clip((np.asarray(x, np.float64) - x0) / cell, 0.0, gw - 1.001)
    gy = np.clip((np.asarray(y, np.float64) - y0) / cell, 0.0, gh - 1.001)
    ix, iy = gx.astype(np.int64), gy.astype(np.int64)
    fx, fy = gx - ix, gy - iy
    return (g[iy, ix] * (1 - fy) * (1 - fx) + g[iy, ix + 1] * (1 - fy) * fx
            + g[iy + 1, ix] * fy * (1 - fx) + g[iy + 1, ix + 1] * fy * fx)


def map_error_percent(points, world: dict) -> float:
    """Median relative depth error of map points [P, 3] against the
    surface; `world` holds `depth_grid`, `x0`, `y0` and `cell`."""
    p = np.asarray(points, np.float64)
    if len(p) == 0:
        return float("inf")
    d = surface_depth(world["depth_grid"], world["x0"], world["y0"], world["cell"], p[:, 0], p[:, 1])
    return 100.0 * float(np.median(np.abs(p[:, 2] - d) / d))
