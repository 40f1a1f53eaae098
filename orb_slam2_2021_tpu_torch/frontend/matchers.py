"""Projection and descriptor matchers for tracking (counterpart of
orb_slam2_2021_tpu/frontend/matchers.py).

- match_last_frame: SearchByProjection(F, LastFrame, th);
- match_local_points: frustum culling + SearchByProjection(F, local points);
- match_bruteforce_desc: descriptor-only ratio + rotation-histogram matching.

Each returns per-query best indices with accept masks, deduplicated so each
frame feature is claimed by at most one query.
"""

from __future__ import annotations

import torch

from ..geometry.camera import PinholeCamera
from ..ops.hamming import MAX_DIST, hamming_best2, rotation_histogram_filter
from .features import Keypoints, level_scales

TH_HIGH = 100
TH_LOW = 50
_BIG = 2 ** 30


def _dedupe_by_feature(best_feat, accept, dist, n_feats: int):
    """If several queries claim one frame feature, keep the lowest-distance
    query, then the lowest query index. Returns the per-query accept mask."""
    idx = best_feat.long()
    d = torch.where(accept, dist.to(torch.int32), torch.full_like(dist, MAX_DIST, dtype=torch.int32))
    feat_min = torch.full((n_feats,), MAX_DIST, dtype=torch.int32, device=d.device)
    feat_min = feat_min.scatter_reduce(0, idx, d, "amin", include_self=True)
    winner = accept & (d == feat_min[idx])
    qidx = torch.arange(best_feat.shape[0], dtype=torch.int32, device=d.device)
    q = torch.where(winner, qidx, torch.full_like(qidx, _BIG))
    feat_qmin = torch.full((n_feats,), _BIG, dtype=torch.int32, device=d.device)
    feat_qmin = feat_qmin.scatter_reduce(0, idx, q, "amin", include_self=True)
    return winner & (q == feat_qmin[idx])


def project_points(cam: PinholeCamera, R, t, xw):
    """World points -> (u, v, u_r, z, Xc) with camera pose Tcw."""
    Xc = torch.matmul(xw, R.transpose(0, 1)) + t
    z = Xc[:, 2]
    iz = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = cam.fx * Xc[:, 0] * iz + cam.cx
    v = cam.fy * Xc[:, 1] * iz + cam.cy
    ur = u - cam.bf * iz
    return u, v, ur, z, Xc


def match_last_frame(cam: PinholeCamera, kp: Keypoints, feat_ur, R, t,
                     last_xw, last_desc, last_octave, last_angle, last_valid,
                     cfg, radius):
    """[P] last-frame landmarks vs current features -> (best_feat [P],
    accept [P], dist [P]). `radius` may be a 0-dim tensor."""
    scale = level_scales(cfg.orb, kp.xy.device)
    u, v, ur, z, _ = project_points(cam, R, t, last_xw)
    in_front = z > 0
    in_img = (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)

    r = radius * scale[last_octave.long()]
    du = torch.abs(kp.xy[None, :, 0] - u[:, None])
    dv = torch.abs(kp.xy[None, :, 1] - v[:, None])
    window = (du <= r[:, None]) & (dv <= r[:, None])
    oct_ok = (
        (kp.octave[None, :] >= last_octave[:, None] - 1)
        & (kp.octave[None, :] <= last_octave[:, None] + 1)
    )
    # stereo gate: a matched feature's u_r must lie near the projected one
    ur_ok = (feat_ur[None, :] < 0) | (torch.abs(feat_ur[None, :] - ur[:, None]) <= r[:, None])
    mask = (
        window & oct_ok & ur_ok
        & last_valid[:, None] & kp.valid[None, :]
        & (in_front & in_img)[:, None]
    )
    best_feat, best_dist, _, _ = hamming_best2(last_desc, kp.desc, mask)
    accept = best_dist <= TH_HIGH
    if cfg.matcher.check_orientation:
        accept = rotation_histogram_filter(
            last_angle, kp.angle[best_feat], accept,
            cfg.matcher.histo_bins, cfg.matcher.histo_keep,
        )
    best_feat = best_feat.to(torch.int32)
    accept = _dedupe_by_feature(best_feat, accept, best_dist, kp.capacity)
    return best_feat, accept, best_dist


def match_local_points(cam: PinholeCamera, kp: Keypoints, feat_ur, feat_bound, R, t,
                       mp_pos, mp_normal, mp_min_dist, mp_max_dist, mp_desc, mp_valid,
                       cfg, th: float = 1.0):
    """Local-map point search -> (best_feat [P], accept [P], dist [P],
    visible [P]); visible = passed the frustum test."""
    scale = level_scales(cfg.orb, kp.xy.device)
    log_scale = torch.log(torch.tensor(cfg.orb.scale_factor, dtype=torch.float32,
                                       device=kp.xy.device))
    n_levels = cfg.orb.n_levels

    u, v, ur, z, Xc = project_points(cam, R, t, mp_pos)
    Ow = -torch.matmul(R.transpose(0, 1), t)         # camera centre in the world
    po = mp_pos - Ow[None]
    dist3d = torch.linalg.vector_norm(po, dim=1) + 1e-9
    in_front = z > 0
    in_img = (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    band = (dist3d >= 0.8 * mp_min_dist) & (dist3d <= 1.2 * mp_max_dist)
    view_cos = torch.sum(po * mp_normal, dim=1) / dist3d
    visible = mp_valid & in_front & in_img & band & (view_cos > 0.5)

    # predicted octave (MapPoint::PredictScale)
    pred = torch.ceil(torch.log(torch.clamp_min(mp_max_dist, 1e-9) / dist3d) / log_scale)
    pred = torch.clamp(pred, 0, n_levels - 1).to(torch.int32)
    r_base = torch.where(view_cos > 0.998, torch.full_like(view_cos, 2.5),
                         torch.full_like(view_cos, 4.0))
    r = th * r_base * scale[pred.long()]

    du = torch.abs(kp.xy[None, :, 0] - u[:, None])
    dv = torch.abs(kp.xy[None, :, 1] - v[:, None])
    window = (du <= r[:, None]) & (dv <= r[:, None])
    oct_ok = (kp.octave[None, :] >= pred[:, None] - 1) & (kp.octave[None, :] <= pred[:, None])
    mask = window & oct_ok & visible[:, None] & kp.valid[None, :] & ~feat_bound[None, :]

    best_feat, best_dist, second_feat, second_dist = hamming_best2(mp_desc, kp.desc, mask)
    accept = best_dist <= TH_HIGH
    # the ratio gate applies only when best and second share an octave
    same_lvl = kp.octave[best_feat] == kp.octave[second_feat]
    ratio_bad = same_lvl & (
        best_dist.to(torch.float32) > cfg.matcher.nn_ratio_bow * second_dist.to(torch.float32)
    ) & (second_dist < MAX_DIST)
    best_feat = best_feat.to(torch.int32)
    accept = _dedupe_by_feature(best_feat, accept & ~ratio_bad, best_dist, kp.capacity)
    return best_feat, accept, best_dist, visible


def match_bruteforce_desc(desc_a, valid_a, angle_a, desc_b, valid_b, angle_b,
                          nn_ratio: float = 0.75, check_orientation: bool = True,
                          histo_bins: int = 30, histo_keep: int = 3, th: int = TH_LOW):
    """Descriptor-only matching a -> b with ratio and rotation gates.
    Returns (best_b [A], accept [A], dist [A])."""
    mask = valid_a[:, None] & valid_b[None, :]
    best_b, best, _, second = hamming_best2(desc_a, desc_b, mask)
    accept = (best <= th) & (best.to(torch.float32) < nn_ratio * second.to(torch.float32))
    if check_orientation:
        accept = rotation_histogram_filter(angle_a, angle_b[best_b], accept, histo_bins, histo_keep)
    best_b = best_b.to(torch.int32)
    accept = _dedupe_by_feature(best_b, accept, best, desc_b.shape[0])
    return best_b, accept, best
