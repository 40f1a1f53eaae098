"""Device steps of the tracking front-end (counterpart of
orb_slam2_2021_tpu/pipeline/track_steps.py).

Each step fuses a matcher pass with the motion-only LM pose solve. The steps
read no value back to the host: a caller pulls their outputs once. The
projection searches are the spans `track.motion_search` and
`track.local_search` (io/trace.py); the pose solve records `track.pose_opt`.
"""

from __future__ import annotations

import torch

from ..frontend.features import Keypoints
from ..frontend.matchers import match_bruteforce_desc, match_last_frame, match_local_points
from ..geometry.camera import PinholeCamera
from ..io import trace
from ..optim.pose import PoseObs, pose_optimize


def _inv_sigma2(octave, cfg):
    s2 = torch.tensor([cfg.orb.scale_factor ** (2 * i) for i in range(cfg.orb.n_levels)],
                      dtype=torch.float32, device=octave.device)
    return 1.0 / s2[torch.clamp(octave, 0, cfg.orb.n_levels - 1).long()]


def _pose_obs_from_matches(kp: Keypoints, feat_ur, xw_per_feat, bound, cfg):
    uvr = torch.cat([kp.xy, feat_ur[:, None]], dim=1)
    return PoseObs(xw=xw_per_feat, uvr=uvr, inv_sigma2=_inv_sigma2(kp.octave, cfg), valid=bound)


def _scatter_slots(n: int, best, accept):
    """Per-feature slot of the accepted query that claimed it (-1 if none)."""
    q = best.shape[0]
    slot = torch.full((n + 1,), -1, dtype=torch.int32, device=best.device)
    qidx = torch.arange(q, dtype=torch.int32, device=best.device)
    target = torch.where(accept, best.long(), torch.full_like(best, n, dtype=torch.long))
    slot[target] = torch.where(accept, qidx, torch.full_like(qidx, -1))
    return slot[:n]


def motion_track_step(cam: PinholeCamera, kp: Keypoints, feat_ur, R_pred, t_pred,
                      last_xw, last_desc, last_octave, last_angle, last_valid, radius, cfg):
    """SearchByProjection(cur, last) + PoseOptimization. Returns (R, t,
    slot [N] last-frame slot per feature (-1), inlier [N], n_inliers,
    n_matched)."""
    with trace.span("track.motion_search"):
        best_feat, accept, _ = match_last_frame(
            cam, kp, feat_ur, R_pred, t_pred,
            last_xw, last_desc, last_octave, last_angle, last_valid, cfg, radius,
        )
        slot = _scatter_slots(kp.capacity, best_feat, accept)
        bound = slot >= 0
        xw = last_xw[torch.clamp_min(slot, 0).long()]
    obs = _pose_obs_from_matches(kp, feat_ur, xw, bound, cfg)
    R, t, inlier, n_in = pose_optimize(cam, R_pred, t_pred, obs, cfg.optim)
    return R, t, slot, inlier, n_in, torch.sum(bound)


def bow_track_step(cam: PinholeCamera, kp: Keypoints, feat_ur, R0, t0,
                   lm_xw, lm_desc, lm_angle, lm_valid, cfg):
    """TrackReferenceKeyFrame: window-free descriptor matching of the
    reference keyframe's landmarks + PoseOptimization from the last pose."""
    best_b, accept, _ = match_bruteforce_desc(
        lm_desc, lm_valid, lm_angle, kp.desc, kp.valid, kp.angle,
    )
    slot = _scatter_slots(kp.capacity, best_b, accept)
    bound = slot >= 0
    xw = lm_xw[torch.clamp_min(slot, 0).long()]
    obs = _pose_obs_from_matches(kp, feat_ur, xw, bound, cfg)
    R, t, inlier, n_in = pose_optimize(cam, R0, t0, obs, cfg.optim)
    return R, t, slot, inlier, n_in, torch.sum(bound)


def local_track_step(cam: PinholeCamera, kp: Keypoints, feat_ur, R0, t0,
                     bound_xw, bound_mask,
                     mp_pos, mp_normal, mp_min_dist, mp_max_dist, mp_desc, mp_valid,
                     cfg, th: float = 1.0):
    """SearchLocalPoints + final PoseOptimization. Returns (R, t, new_slot
    [N] local-snapshot slot per feature (-1), inlier [N], n_inliers,
    visible [P])."""
    with trace.span("track.local_search"):
        best_feat, accept, _, visible = match_local_points(
            cam, kp, feat_ur, bound_mask, R0, t0,
            mp_pos, mp_normal, mp_min_dist, mp_max_dist, mp_desc, mp_valid, cfg, th,
        )
        slot = _scatter_slots(kp.capacity, best_feat, accept)
        xw = torch.where(bound_mask[:, None], bound_xw, mp_pos[torch.clamp_min(slot, 0).long()])
    obs = _pose_obs_from_matches(kp, feat_ur, xw, bound_mask | (slot >= 0), cfg)
    R, t, inlier, n_in = pose_optimize(cam, R0, t0, obs, cfg.optim)
    return R, t, slot, inlier, n_in, visible


def fused_track_step(cam: PinholeCamera, kp: Keypoints, feat_ur, depth,
                     last_desc, last_octave, last_angle, last_kp_valid,
                     last_geom, last_slot, pose_pack,
                     snap_geom, snap_desc, snap_valid, cfg):
    """TrackWithMotionModel (with its widened-window retry) + TrackLocalMap.

    last_geom [N, 4]: world pos + map-liveness flag of each last-frame
    feature; last_slot [N]: its local-snapshot slot (-1); pose_pack [16]:
    R_pred(9), t_pred(3), radius, depth_th, min_matched; snap_geom [P, 8]:
    pos(3), normal(3), min_dist, max_dist; snap_desc [P, 8]; snap_valid [P].

    Both the first motion search and the widened retry run, and the retry's
    result is selected on the device, so nothing waits for the device here.

    Returns (out_f [30] f32, out_i [N + P] i32):
      out_f = [R_final(9), t_final(3), n_matched_motion, n_in_motion,
               n_in_final, tracked_close, untracked_close, widened_retry,
               R_motion(9), t_motion(3)]
      out_i = [enc (N): -1 unbound / [0,N) last-frame slot / [N,N+P) snapshot
               slot, all post-inlier-gating; visible (P) 0/1]
    """
    R_pred = pose_pack[:9].reshape(3, 3)
    t_pred = pose_pack[9:12]
    radius = pose_pack[12]
    depth_th = pose_pack[13]
    min_matched = pose_pack[14].to(torch.int32)

    last_xw = last_geom[:, :3]
    last_valid = (last_geom[:, 3] > 0) & last_kp_valid

    def motion(r):
        return motion_track_step(
            cam, kp, feat_ur, R_pred, t_pred,
            last_xw, last_desc, last_octave, last_angle, last_valid, r, cfg,
        )

    first = motion(radius)
    second = motion(2.0 * radius)
    widened = first[5] < min_matched
    R1, t1, slot1, inl1, nin1, nm1 = (torch.where(widened, b, a) for a, b in zip(first, second))

    n = kp.capacity
    bound = (slot1 >= 0) & inl1
    bound_xw = last_xw[torch.clamp_min(slot1, 0).long()]

    # points matched through the last frame are excluded from the local search
    P = snap_valid.shape[0]
    sel_slot = torch.where(bound, last_slot[torch.clamp_min(slot1, 0).long()],
                           torch.full_like(slot1, -1))
    already = torch.zeros(P + 1, dtype=torch.bool, device=snap_valid.device)
    already[torch.where(sel_slot >= 0, sel_slot, torch.full_like(sel_slot, P)).long()] = True
    snap_ok = snap_valid & ~already[:P]

    R2, t2, slot2, inl2, nin2, visible = local_track_step(
        cam, kp, feat_ur, R1, t1, bound_xw, bound,
        snap_geom[:, :3], snap_geom[:, 3:6], snap_geom[:, 6], snap_geom[:, 7],
        snap_desc, snap_ok, cfg,
    )

    new_bound = slot2 >= 0
    enc = torch.where(bound, slot1, torch.full_like(slot1, -1))
    enc = torch.where(new_bound, slot2 + n, enc)
    enc = torch.where((bound | new_bound) & inl2, enc, torch.full_like(enc, -1))

    close = (depth > 0) & (depth < depth_th) & kp.valid
    f32 = torch.float32
    counts = torch.stack([
        nm1.to(f32), nin1.to(f32), nin2.to(f32),
        torch.sum(close & (enc >= 0)).to(f32), torch.sum(close & (enc < 0)).to(f32),
        widened.to(f32),
    ])
    out_f = torch.cat([R2.reshape(-1), t2, counts, R1.reshape(-1), t1])
    out_i = torch.cat([enc, visible.to(torch.int32)])
    return out_f, out_i


def frame_pack_step(kp: Keypoints, feat_ur, depth):
    """Per-frame arrays for one host pull at keyframe creation /
    initialization: ([N, 8] f32 = xy, u_r, depth, angle, octave, valid,
    response; [N, 8] int32 descriptors)."""
    f = torch.cat([
        kp.xy, feat_ur[:, None], depth[:, None], kp.angle[:, None],
        kp.octave.to(torch.float32)[:, None], kp.valid.to(torch.float32)[:, None],
        kp.response[:, None],
    ], dim=1)
    return f, kp.desc
