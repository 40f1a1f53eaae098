"""Tracking front-end for stereo, RGB-D and monocular input (counterpart of
orb_slam2_2021_tpu/pipeline/tracking.py).

State machine (NOT_INITIALIZED / OK / LOST), stereo / RGB-D initialization
from depth, monocular initialization from two views, the fused motion-model
+ local-map step with reference-keyframe fallback, keyframe decision and
creation, and per-frame relative-pose records for trajectory export. Device
work runs in `track_steps`; this class owns the numpy-side feature ->
map-point bindings and the shared host MapStore.

With a LocalMapping attached, every new keyframe (the stereo initialization
and each later one) is handed to it together with its BoW words and the live
frame, whose device tensors it copies; synchronous mapping is always idle,
so the keyframe decision keeps its rule.

With place recognition, a lost frame relocalizes against the keyframe
database: BoW candidates, descriptor matching (K1), EPnP RANSAC and the
motion-only refine with its two-stage window escalation; without it (or
when no candidate succeeds) it falls back to the reference-keyframe search.

Localization mode (`only_tracking`) tracks against the frozen map with the
motion model, inserts no keyframe, and for stereo and RGB-D carries the pose
through match-starved stretches on temporal visual-odometry points spawned
from the last frame's depths (`vo_mode`) until a relocalization succeeds.

Monocular initialization matches a reference frame against a later one,
bootstraps the two-view geometry (`solvers/two_view.py`) over minimal sets
drawn by `init_sampler`, and seeds the map with two keyframes at unit
median depth.

Spans (io/trace.py) under System's `track`: `track.select_local_kfs`,
`track.snapshot`, `track.fused_step` (with `track.motion_search`,
`track.pose_opt` a pose solve and `track.local_search` in the device steps),
`track.readback` (the host's waits for device results), `track.bind` (the
bookkeeping after the fused or local-map readback), `track.kf_decision`,
`track.kf_create` (keyed by the new keyframe's id), and one span for each
other path: `track.init`, `track.ref_kf`, `track.reloc`, `track.local_map`.
"""

from __future__ import annotations

from dataclasses import dataclass
from enum import Enum
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..config import SlamConfig
from ..convert import camera_from_config, desc_from_numpy, desc_to_numpy, tensor, to_host
from ..frontend.frame import Frame
from ..frontend.matchers import match_bruteforce_desc
from ..io import trace
from ..mapping.map_store import MapStore
from ..solvers.epnp import MIN_SAMPLE, epnp_ransac
from ..solvers.horn_sim3 import sample_indices
from ..solvers.two_view import MIN_SET, two_view_init
from .streams import pull_after
from .track_steps import (
    bow_track_step, frame_pack_step, fused_track_step, local_track_step, motion_track_step,
)

PNP_HYPS = 256  # EPnP RANSAC hypotheses per relocalization candidate
INIT_HYPS = 256  # two-view hypotheses of a monocular initialization


def reloc_samples(valid, m: int, n_hyps: int, seed: int):
    """The relocalization RANSAC's minimal sets for one candidate keyframe:
    a host generator seeded per candidate, as the reference seeds its key
    with kc + 17."""
    return sample_indices(valid, m, n_hyps, torch.Generator().manual_seed(seed))


def _pull(*tensors):
    """`to_host` inside the `track.readback` span."""
    with trace.span("track.readback"):
        return to_host(*tensors)


def init_samples(valid, frame_id: int):
    """The monocular initialization's minimal sets [INIT_HYPS, 8], drawn
    among the valid matches by a host generator seeded with the frame id, as
    the reference keys its draw."""
    return sample_indices(valid, MIN_SET, INIT_HYPS, torch.Generator().manual_seed(frame_id))


class TrackState(Enum):
    NO_IMAGES_YET = 0
    NOT_INITIALIZED = 1
    OK = 2
    LOST = 3


class LastFrame:
    """The previous frame: its device tensors (`.kp`, read by the fused step)
    plus host views pulled lazily, in one copy, only when a slow path needs
    them."""

    def __init__(self, tracker, frame, frame_id, bind, pose, host=None):
        self._tr = tracker
        self._frame = frame
        self.kp = frame.kp
        self._data = {"frame_id": frame_id, "mp": bind, "pose": pose}
        self._host = host

    def get(self, key, default=None):
        try:
            return self[key]
        except KeyError:
            return default

    def __getitem__(self, key):
        if key in self._data:
            return self._data[key]
        if self._host is None:
            self._host = self._tr._frame_host_arrays(self._frame)
        return self._host[key]


@dataclass
class FrameRecord:
    """Per-frame trajectory bookkeeping (mlRelativeFramePoses et al.)."""
    frame_id: int
    timestamp: float
    ref_kf: int
    T_cr: np.ndarray  # [4, 4] pose relative to reference KF: Tcw * Twr
    lost: bool


class Tracking:
    def __init__(self, cfg: SlamConfig, map_store: MapStore, device,
                 local_mapper=None, place_rec=None):
        self.cfg = cfg
        self.map = map_store
        self.local_mapper = local_mapper  # None = mapping off
        self.place = place_rec            # PlaceRecognition or None
        self.reloc_sampler = reloc_samples
        self.init_sampler = init_samples
        self.sensor = "stereo"            # "stereo" | "rgbd" | "mono", set by System
        self.only_tracking = False        # localization mode
        self.vo_mode = False              # tracking mostly on temporal VO points
        self._mono_ref = None             # (frame, frame_id, timestamp) of mono init
        self.device = torch.device(device)
        self.cam = camera_from_config(cfg)
        self.state = TrackState.NO_IMAGES_YET
        self.velocity: Optional[np.ndarray] = None  # [4,4] Tcl (cur<-last)
        self.last_pose: Optional[Tuple[np.ndarray, np.ndarray]] = None
        self.last_frame_data: Optional[LastFrame] = None
        self.ref_kf: int = -1
        self.last_kf_frame_id: int = -1
        self.records: List[FrameRecord] = []
        self.n_inliers_last = 0
        self.last_reloc_frame_id = -(1 << 30)
        self.request_system_reset = None  # set by System: reset-on-early-loss
        self.last_metrics: Optional[dict] = None
        self._fh = None          # host views of the current frame (one pull)
        # local-map snapshot on the device, rebuilt only when the local
        # keyframe set or the map content changes
        self._snap_key = None
        self._snap_dev = None
        self._snap_ids = None
        self._id2slot = None
        self._kf_close_counts = None
        self._bind_cur = np.full(cfg.orb.n_features, -1, np.int64)
        self._ref_anchor = None
        # next-frame prefetch (System.track_stereo_prefetch): a callable run
        # between the fused step's launches and its readback, and its result
        self.prefetch_cb = None
        self.prefetch_result = None

    def _dev(self, a, dtype=None):
        return tensor(a, self.device, dtype)

    # ------------------------------------------------------------------
    def track_stereo_frame(self, frame: Frame, frame_id: int, timestamp: float):
        """Main per-frame entry (Tracking::Track). Returns (R, t) Tcw or None
        while not initialized / lost."""
        if self.state in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED):
            n_kf0 = self.map.n_kf
            with trace.span("track.init"):
                ok = self._stereo_initialize(frame, frame_id, timestamp)
            self.state = TrackState.OK if ok else TrackState.NOT_INITIALIZED
            self._set_metrics(frame_id, timestamp, self.map.n_kf > n_kf0)
            return self.last_pose if ok else None

        self._rebase_on_map_correction()
        n_kf0 = self.map.n_kf
        local_done = False
        self._kf_close_counts = None
        if not self.only_tracking:
            if self.state == TrackState.OK:
                if self.velocity is None or frame_id < self.last_reloc_frame_id + 2:
                    ok = self._track_reference_kf(frame)
                else:
                    fused = self._track_fused(frame, frame_id)
                    if fused is None:
                        ok = self._track_reference_kf(frame)
                    else:
                        ok = fused
                        local_done = True
            else:
                ok = self._relocalize(frame, frame_id)
        else:
            ok = self._track_localization(frame, frame_id)
        if ok and not local_done and not (self.only_tracking and self.vo_mode):
            # in VO mode too few map matches remain to select a local map
            ok = self._track_local_map(frame, frame_id)
        return self._finish_frame(frame, frame_id, timestamp, ok, n_kf0)

    def _track_localization(self, frame: Frame, frame_id: int) -> bool:
        """Localization mode: relocalize when lost; track the motion model
        (or the reference keyframe) while the last frame saw enough map
        points; in VO mode run both the motion model and relocalization and
        prefer the relocalization."""
        if self.state == TrackState.LOST:
            ok = self._relocalize(frame, frame_id)
            if ok:
                self.vo_mode = False
            return ok
        if not self.vo_mode:
            if self.velocity is not None:
                return self._track_motion_model(frame)
            return self._track_reference_kf(frame)
        ok_mm = False
        mm_pose = mm_bind = None
        if self.velocity is not None:
            ok_mm = self._track_motion_model(frame)
            if ok_mm:
                mm_pose, mm_bind = self.last_pose, self._bind_cur.copy()
        ok_reloc = self._relocalize(frame, frame_id)
        if ok_mm and not ok_reloc:
            self.last_pose, self._bind_cur = mm_pose, mm_bind
            if self.vo_mode:
                # the real map points still tracked were found
                self.map.increment_found(mm_bind[mm_bind >= 0])
        elif ok_reloc:
            self.vo_mode = False
        return ok_reloc or ok_mm

    def _rebase_on_map_correction(self) -> bool:
        """Re-anchor the cached pose state when the reference keyframe moved
        (local BA, or a cull that leaves it resolved through its parent): the
        last frame's pose relative to that keyframe is kept, see the
        reference's _rebase_on_map_correction."""
        if self.last_pose is None or self._ref_anchor is None:
            return False
        k, R_old, t_old = self._ref_anchor
        T_new = self.map.resolve_kf_pose(int(k)).astype(np.float64)
        if (np.abs(T_new[:3, :3] - R_old).max() < 1e-5
                and np.abs(T_new[:3, 3] - t_old).max() < 1e-5):
            return False
        T_old = np.eye(4)
        T_old[:3, :3] = R_old
        T_old[:3, 3] = t_old
        D = np.linalg.inv(T_old) @ T_new

        def reb(pose):
            T = np.eye(4)
            T[:3, :3] = np.asarray(pose[0], np.float64)
            T[:3, 3] = np.asarray(pose[1], np.float64)
            T = T @ D
            return (T[:3, :3].astype(np.float32), T[:3, 3].astype(np.float32))

        self.last_pose = reb(self.last_pose)
        if self.last_frame_data is not None and self.last_frame_data.get("pose") is not None:
            self.last_frame_data._data["pose"] = reb(self.last_frame_data["pose"])
        self._ref_anchor = (int(k), T_new[:3, :3].copy(), T_new[:3, 3].copy())
        return True

    def _finish_frame(self, frame: Frame, frame_id: int, timestamp: float,
                      ok: bool, n_kf0: int):
        """Per-frame tail: state transition, motion model, keyframe decision,
        trajectory record, last-frame stash, metrics."""
        if ok:
            self.state = TrackState.OK
            self._update_motion_model()
            if not self.only_tracking:
                with trace.span("track.kf_decision"):
                    need = self._need_new_keyframe(frame, frame_id)
                if need:
                    with trace.span("track.kf_create", key=self.map.next_kf):
                        self._create_new_keyframe(frame, frame_id, timestamp)
        else:
            self.state = TrackState.LOST
            self.velocity = None
            self.n_inliers_last = 0
            # reset if the camera got lost soon after initialization
            if (not self.only_tracking and self.map.n_kf <= 5
                    and self.request_system_reset is not None):
                self.request_system_reset()
                self._set_metrics(frame_id, timestamp, False)
                return None
        self._record_frame(frame_id, timestamp, lost=not ok)
        self._stash_last_frame(frame, frame_id)
        self._set_metrics(frame_id, timestamp, self.map.n_kf > n_kf0)
        return self.last_pose if ok else None

    def track_mono_frame(self, frame: Frame, frame_id: int, timestamp: float):
        """Monocular per-frame entry: the two-view initialization until it
        succeeds, then the common tracking path."""
        self.sensor = "mono"
        if self.state in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED):
            n_kf0 = self.map.n_kf
            ok = self._mono_initialize(frame, frame_id, timestamp)
            self.state = TrackState.OK if ok else TrackState.NOT_INITIALIZED
            self._set_metrics(frame_id, timestamp, self.map.n_kf > n_kf0)
            return self.last_pose if ok else None
        return self.track_stereo_frame(frame, frame_id, timestamp)

    def _mono_initialize(self, frame: Frame, frame_id: int, timestamp: float) -> bool:
        """MonocularInitialization + CreateInitialMapMonocular: the first
        frame with more than 100 features becomes the reference; a later one
        is matched against it (ratio 0.9, distance 50, a 100 px window), the
        two-view geometry is bootstrapped from the matches, and the map is
        seeded with the triangulated points at unit median depth and two
        keyframes (the reference frame at the identity, then this one)."""
        n_valid = int(frame.kp.valid.sum())
        if self._mono_ref is None:
            if n_valid > 100:
                self._mono_ref = (frame, frame_id, timestamp)
            return False
        if n_valid <= 100:
            self._mono_ref = None
            return False
        ref, ref_id, ref_ts = self._mono_ref
        best_b, accept, _ = match_bruteforce_desc(
            ref.kp.desc, ref.kp.valid, ref.kp.angle, frame.kp.desc, frame.kp.valid, frame.kp.angle,
            nn_ratio=0.9, th=50)
        p2 = frame.kp.xy[best_b.long()]
        accept = accept & ((p2 - ref.kp.xy).abs().amax(dim=1) < 100.0)
        accept_h, best_b = _pull(accept, best_b)
        if accept_h.sum() < 100:
            self._mono_ref = None
            return False
        p1 = torch.where(accept[:, None], ref.kp.xy, torch.zeros_like(ref.kp.xy))
        idx = self.init_sampler(accept_h, frame_id).to(self.device)
        c = self.cfg
        res = two_view_init(idx, p1, p2, accept, c.fx, c.fy, c.cx, c.cy)
        ok, good, R2, t2, pts = _pull(res.ok, res.good, res.R, res.t, res.points)
        if not bool(ok) or good.sum() < 80:
            return False
        med = float(np.median(pts[good][:, 2]))
        if med <= 0:
            return False
        pts = pts * (1.0 / med)
        t2 = t2 * (1.0 / med)

        host0 = self._frame_host_arrays(ref)
        host1 = self._frame_host_arrays(frame)
        n = frame.n
        bind0 = np.full(n, -1, np.int64)
        bind1 = np.full(n, -1, np.int64)
        gi = np.nonzero(good)[0]
        ids = self.map.add_map_points_batch(pts[gi].astype(np.float32), host0["desc"][gi], first_kf=0)
        bind0[gi] = ids
        bind1[best_b[gi]] = ids
        k0 = self.map.add_keyframe(
            np.eye(3, dtype=np.float32), np.zeros(3, np.float32), host0["xy"], host0["ur"],
            host0["depth"], host0["octave"], host0["angle"], host0["desc"], host0["kp_valid"],
            bind0, ref_id, ref_ts,
        )
        k1 = self.map.add_keyframe(
            R2.astype(np.float32), t2.astype(np.float32), host1["xy"], host1["ur"], host1["depth"],
            host1["octave"], host1["angle"], host1["desc"], host1["kp_valid"], bind1,
            frame_id, timestamp,
        )
        self.map.update_point_stats(ids)
        self.ref_kf = k1
        self.last_kf_frame_id = frame_id
        self.last_pose = (R2.astype(np.float32), t2.astype(np.float32))
        self.velocity = None
        self._bind_cur = bind1
        self._record_frame(frame_id, timestamp, lost=False)
        self._stash_last_frame(frame, frame_id)
        if self.local_mapper is not None:
            self.local_mapper.insert_keyframe(k0, host0["words"], ref)
            self.local_mapper.insert_keyframe(k1, host1["words"], frame)
        self._mono_ref = None
        return True

    def _stereo_initialize(self, frame: Frame, frame_id: int, timestamp: float) -> bool:
        """StereoInitialization: need enough features; one map point per
        feature with positive depth, at the identity pose."""
        host = self._frame_host_arrays(frame)
        kp_valid = host["kp_valid"]
        depth = host["depth"]
        if kp_valid.sum() < 500 * min(1.0, self.cfg.orb.n_features / 2000.0):
            return False
        R = np.eye(3, dtype=np.float32)
        t = np.zeros(3, dtype=np.float32)
        good = kp_valid & (depth > 0)
        if good.sum() < 100:
            return False
        xy = host["xy"]
        desc = host["desc"]
        z = depth[good]
        x = (xy[good, 0] - self.cfg.cx) * z / self.cfg.fx
        y = (xy[good, 1] - self.cfg.cy) * z / self.cfg.fy
        pos = np.stack([x, y, z], axis=1).astype(np.float32)
        with trace.span("track.kf_create", key=self.map.next_kf):
            ids = self.map.add_map_points_batch(pos, desc[good], first_kf=0)
            mp_bind = np.full(frame.n, -1, np.int64)
            mp_bind[np.nonzero(good)[0]] = ids
            k = self.map.add_keyframe(
                R, t, xy, host["ur"], depth, host["octave"], host["angle"],
                desc, kp_valid, mp_bind, frame_id, timestamp,
            )
            self.map.update_point_stats(ids)
            self.ref_kf = k
            self.last_kf_frame_id = frame_id
            self.last_pose = (R, t)
            self.velocity = None
            self._bind_cur = mp_bind
            self._record_frame(frame_id, timestamp, lost=False)
            self._stash_last_frame(frame, frame_id)
            if self.local_mapper is not None:
                self.local_mapper.insert_keyframe(k, host["words"], frame)
        return True

    VO_ID = -2  # id of a temporal visual-odometry point

    def _last_landmark_arrays(self):
        """The landmarks the last frame carries (its bound features). In
        localization mode with depth (stereo, RGB-D), except on the frame
        right after a keyframe, the last frame's unbound features with depth
        become temporal VO points as well: all closer than ThDepth, at least
        the 100 closest. They carry VO_ID, which map statistics skip, and
        live for one frame."""
        lf = self.last_frame_data
        ids = np.where(lf["mp"] >= 0, lf["mp"], -1)
        live = self.map.resolve_replaced(ids)
        valid = (live >= 0) & self.map.mp_valid[np.clip(live, 0, None)] & lf["kp_valid"]
        xw = self.map.mp_pos[np.clip(live, 0, None)]
        out_ids = np.where(valid, live, -1)
        if (self.only_tracking and self.sensor != "mono"
                and lf.get("frame_id", -1) != self.last_kf_frame_id):
            depth = lf["depth"]
            cand = np.nonzero((depth > 0) & lf["kp_valid"] & ~valid)[0]
            if len(cand):
                order = cand[np.argsort(depth[cand], kind="stable")]
                n_close = int((depth[order] < self.cfg.resolved_depth_th()).sum())
                take = order[: max(min(100, len(order)), n_close)]
                R_l, t_l = lf["pose"]
                z = depth[take]
                xy = lf["xy"]
                xc = np.stack([(xy[take, 0] - self.cfg.cx) * z / self.cfg.fx,
                               (xy[take, 1] - self.cfg.cy) * z / self.cfg.fy, z],
                              axis=1).astype(np.float32)
                xw = xw.copy()
                xw[take] = (xc - t_l[None]) @ R_l  # R^T (xc - t)
                valid = valid.copy()
                valid[take] = True
                out_ids = out_ids.copy()
                out_ids[take] = self.VO_ID
        return xw, valid, out_ids

    def _run_motion_step(self, frame: Frame, R_pred, t_pred, radius: float):
        """SearchByProjection against the last frame's landmarks +
        PoseOptimization. Returns (landmark ids, R, t, slot, inlier, n_in,
        n_matched) on the host."""
        xw, valid, ids = self._last_landmark_arrays()
        lkp = self.last_frame_data.kp
        out = motion_track_step(
            self.cam, frame.kp, frame.u_right, self._dev(R_pred), self._dev(t_pred),
            self._dev(xw), lkp.desc, lkp.octave, lkp.angle, self._dev(valid), radius, self.cfg)
        R, t, slot, inlier, n_in, n_matched = _pull(*out)
        return ids, R, t, slot, inlier, int(n_in), int(n_matched)

    def _track_motion_model(self, frame: Frame) -> bool:
        """TrackWithMotionModel (localization mode's tracker; SLAM mode runs
        the fused step), with the widened-window retry."""
        T_pred = self.velocity @ _mat(*self.last_pose)
        R_pred, t_pred = T_pred[:3, :3], T_pred[:3, 3]
        r = self.cfg.tracking.motion_search_radius
        ids, R, t, slot, inlier, n_in, n_matched = self._run_motion_step(frame, R_pred, t_pred, r)
        if n_matched < 20:
            ids, R, t, slot, inlier, n_in, n_matched = self._run_motion_step(frame, R_pred, t_pred, 2 * r)
            if n_matched < 20:
                return False
        # inliers on real map points: VO points count toward the pose only
        slot_ok = (slot >= 0) & inlier
        n_map = int((slot_ok & (ids[np.clip(slot, 0, None)] >= 0)).sum())
        if self.only_tracking:
            if n_in < self.cfg.tracking.min_inliers_track:
                return False
            self._apply_matches(ids, slot, inlier)
            self.last_pose = (R, t)
            self.vo_mode = n_map < 10
            self.n_inliers_last = n_in
            return n_in > 20
        if n_map < self.cfg.tracking.min_inliers_track:
            return False
        self._apply_matches(ids, slot, inlier)
        self.last_pose = (R, t)
        return True

    def _track_reference_kf(self, frame: Frame) -> bool:
        """TrackReferenceKeyFrame: window-free descriptor matching against the
        reference keyframe's landmarks, then pose optimization from the last
        pose."""
        with trace.span("track.ref_kf"):
            if self.ref_kf < 0 or self.last_pose is None:
                return False
            k = self.ref_kf
            mp = self.map.kf_mp[k]
            valid = (mp >= 0) & self.map.mp_valid[np.clip(mp, 0, None)]
            if valid.sum() < 15:
                return False
            ids = np.where(valid, mp, -1)
            xw = self.map.mp_pos[np.clip(mp, 0, None)]
            R_l, t_l = self.last_pose
            R, t, slot, inlier, n_in, n_matched = bow_track_step(
                self.cam, frame.kp, frame.u_right,
                self._dev(R_l), self._dev(t_l), self._dev(xw),
                desc_from_numpy(self.map.kf_desc[k], self.device),
                self._dev(self.map.kf_angle[k]), self._dev(valid), self.cfg,
            )
            with trace.span("track.readback"):
                R, t, slot, inlier, n_in, n_matched = (
                    x.cpu().numpy() for x in (R, t, slot, inlier, n_in, n_matched)
                )
            if int(n_matched) < 15 or int(n_in) < self.cfg.tracking.min_inliers_track:
                return False
            self._apply_matches(ids, slot, inlier)
            self.last_pose = (R, t)
            return True

    def _feature_scale(self) -> float:
        """Inlier thresholds assume nFeatures=2000; scale them down for
        smaller budgets."""
        return min(1.0, self.cfg.orb.n_features / 2000.0)

    def _relocalize(self, frame: Frame, frame_id: int) -> bool:
        """Relocalization: keyframe-database candidates first, then the
        reference-keyframe search."""
        with trace.span("track.reloc"):
            if self.place is not None and self._relocalize_bow(frame, frame_id):
                return True
            return self._track_reference_kf(frame)

    def _relocalize_bow(self, frame: Frame, frame_id: int) -> bool:
        """Per candidate (the first five): descriptor matching, EPnP RANSAC
        on the matched (point, pixel) pairs, then the motion-only refine,
        widened and narrowed as the reference does when too few inliers
        remain."""
        host = self._frame_host_arrays(frame)
        cands = self.place.kfdb.detect_reloc_candidates(
            host["words"], lambda x: self.map.covisible_keyframes(x, 10))
        if not cands:
            return False
        n = frame.n
        sigma2 = self.map.scale_factors ** 2
        dev = self.device
        c = self.cfg
        for kc in cands[:5]:
            kc = int(kc)
            if not self.map.kf_valid[kc]:
                continue
            mp = self.map.kf_mp[kc]
            feat_ok = (mp >= 0) & self.map.mp_valid[np.clip(mp, 0, None)]
            if feat_ok.sum() < 15:
                continue
            kf_desc = desc_from_numpy(self.map.kf_desc[kc], dev)
            kf_ok = self._dev(feat_ok)
            kf_angle = self._dev(self.map.kf_angle[kc])
            best_b, accept, _ = match_bruteforce_desc(
                frame.kp.desc, frame.kp.valid, frame.kp.angle, kf_desc, kf_ok, kf_angle)
            accept, best_b = _pull(accept, best_b)
            if accept.sum() < 15:
                continue
            fidx = np.nonzero(accept)[0]
            xw = np.zeros((n, 3), np.float32)
            uv = np.zeros((n, 2), np.float32)
            s2 = np.ones(n, np.float32)
            valid = np.zeros(n, bool)
            xw[fidx] = self.map.mp_pos[mp[best_b[fidx]]]
            uv[fidx] = host["xy"][fidx]
            s2[fidx] = sigma2[host["octave"][fidx]]
            valid[fidx] = True
            idx = self.reloc_sampler(valid, MIN_SAMPLE, PNP_HYPS, kc + 17).to(dev)
            R, t, _, n_in = epnp_ransac(idx, self._dev(xw), self._dev(uv), self._dev(s2),
                                        self._dev(valid), c.fx, c.fy, c.cx, c.cy)
            R, t, n_in = _pull(R, t, n_in)
            if int(n_in) < 10:
                continue
            ids = np.where(feat_ok, mp, -1)
            lm = (self._dev(self.map.mp_pos[np.clip(mp, 0, None)]), kf_desc,
                  self._dev(self.map.kf_octave[kc]), kf_angle, kf_ok)
            min_good = max(15, int(round(50 * self._feature_scale())))
            r0 = c.tracking.reloc_search_radius

            def refine(R_c, t_c, radius):
                Rn, tn, slot, inlier, n_opt, _ = motion_track_step(
                    self.cam, frame.kp, frame.u_right, self._dev(R_c), self._dev(t_c),
                    *lm, radius, c)
                Rn, tn, slot, inlier, n_opt = _pull(Rn, tn, slot, inlier, n_opt)
                return Rn, tn, slot, inlier, int(n_opt)

            Rn, tn, slot, inlier, n_good = refine(R, t, r0)
            if n_good < 10:
                continue
            if n_good < min_good:
                # coarse-window escalation from the refined pose, then a
                # narrow-window pass when it lands just short
                Rn, tn, slot, inlier, n_good = refine(Rn, tn, 2.0 * r0)
                if int(round(0.6 * min_good)) <= n_good < min_good:
                    Rn, tn, slot, inlier, n_good = refine(Rn, tn, 0.4 * r0)
            if n_good < min_good:
                continue
            self._apply_matches(ids, slot, inlier)
            self.last_pose = (Rn, tn)
            self.ref_kf = kc
            self.velocity = None
            self.last_reloc_frame_id = frame_id
            return True
        return False

    def _apply_matches(self, ids, slot, inlier):
        """Bind current-frame features to map-point ids given matcher slots."""
        bind = np.full(slot.shape[0], -1, np.int64)
        ok = (slot >= 0) & inlier
        bind[ok] = ids[slot[ok]]
        self._bind_cur = bind

    # ------------------------------------------------------------------
    def _frame_host_arrays(self, frame: Frame):
        """Host views of a frame's feature data, and its BoW words when place
        recognition is on, in one device -> host copy."""
        if self._fh is not None and self._fh[0] is frame:
            return self._fh[1]
        f, desc = frame_pack_step(frame.kp, frame.u_right, frame.depth)
        n = f.shape[0]
        parts = [f.view(torch.int32), desc]
        if self.place is not None:
            parts.append(self.place.transform(frame.kp.desc, frame.kp.valid)[:, None])
        packed = torch.cat(parts, dim=1)
        with trace.span("track.readback"):
            pulled = packed.cpu().numpy()
        f = pulled[:, :8].view(np.float32)
        host = {
            "xy": np.ascontiguousarray(f[:, :2]),
            "ur": f[:, 2].copy(),
            "depth": f[:, 3].copy(),
            "angle": f[:, 4].copy(),
            "octave": f[:, 5].astype(np.int32),
            "kp_valid": f[:, 6] > 0,
            "response": f[:, 7].copy(),
            "desc": desc_to_numpy(pulled[:, 8:16].reshape(n, 8)),
            "words": pulled[:, 16].copy() if self.place is not None else None,
        }
        self._fh = (frame, host)
        return host

    def _select_local_kfs(self, matched_ids: np.ndarray):
        """UpdateLocalKeyFrames: keyframes voting for the current matches,
        padded with their best covisibles. Returns (reference_kf,
        local_kf_list) or None."""
        with trace.span("track.select_local_kfs"):
            obs_kf = self.map.mp_obs_kf[matched_ids].reshape(-1)
            obs_kf = obs_kf[obs_kf >= 0]
            if len(obs_kf) == 0:
                return None
            votes = np.bincount(obs_kf, minlength=self.map.kf_capacity)
            voters = np.nonzero(votes)[0]
            order = voters[np.argsort(-votes[voters], kind="stable")]
            local_kfs = list(order[: self.cfg.tracking.local_window_kf // 2])
            for k in list(local_kfs):
                for nb in self.map.covisible_keyframes(int(k), 10):
                    if len(local_kfs) >= self.cfg.tracking.local_window_kf:
                        break
                    if nb not in local_kfs:
                        local_kfs.append(int(nb))
            return int(order[0]), local_kfs

    def _refresh_snapshot(self, local_kfs) -> bool:
        """Upload the local-map snapshot when the local keyframe set or the
        map content (write epoch) changed. Returns True when rebuilt."""
        with trace.span("track.snapshot"):
            key = (tuple(int(x) for x in local_kfs), self.map.write_epoch)
            if key == self._snap_key:
                return False
            P = self.cfg.tracking.local_points_cap
            snap = self.map.local_map_snapshot(np.asarray(local_kfs, np.int64), P)
            geom = np.concatenate(
                [snap["pos"], snap["normal"], snap["min_dist"][:, None], snap["max_dist"][:, None]],
                axis=1,
            ).astype(np.float32)
            self._snap_dev = (
                self._dev(geom), desc_from_numpy(snap["desc"], self.device), self._dev(snap["valid"])
            )
            self._snap_ids = snap["ids"]
            cap = len(self.map.mp_valid)
            if self._id2slot is None or len(self._id2slot) != cap:
                self._id2slot = np.full(cap, -1, np.int32)
            else:
                self._id2slot[:] = -1
            live = snap["ids"] >= 0
            self._id2slot[snap["ids"][live]] = np.arange(P, dtype=np.int32)[live]
            self._snap_key = key
            return True

    def _track_fused(self, frame: Frame, frame_id: int):
        """TrackWithMotionModel + TrackLocalMap in one device step with one
        host pull. Returns None when motion tracking failed (the caller falls
        back to the reference-KF path), else the TrackLocalMap verdict."""
        lf = self.last_frame_data
        n = self.cfg.orb.n_features
        ids = np.where(lf["mp"] >= 0, lf["mp"], -1)
        live = self.map.resolve_replaced(ids)
        alive = (live >= 0) & self.map.mp_valid[np.clip(live, 0, None)]
        lm_ids = np.where(alive, live, -1)
        matched_ids = lm_ids[lm_ids >= 0]
        if matched_ids.size == 0:
            return None
        sel_res = self._select_local_kfs(matched_ids)
        if sel_res is None:
            return None
        ref_kf, local_kfs = sel_res
        self._refresh_snapshot(local_kfs)

        with trace.span("track.fused_step"):
            geom = np.empty((n, 4), np.float32)
            geom[:, :3] = self.map.mp_pos[np.clip(live, 0, None)]
            geom[:, 3] = alive
            last_slot = np.where(lm_ids >= 0, self._id2slot[np.clip(lm_ids, 0, None)], -1)
            R_l, t_l = self.last_pose
            T_pred = self.velocity @ _mat(R_l, t_l)
            pose_pack = np.zeros(16, np.float32)
            pose_pack[:9] = T_pred[:3, :3].reshape(-1)
            pose_pack[9:12] = T_pred[:3, 3]
            pose_pack[12] = self.cfg.tracking.motion_search_radius
            pose_pack[13] = self.cfg.resolved_depth_th()
            pose_pack[14] = 20.0

            out_f, out_i = fused_track_step(
                self.cam, frame.kp, frame.u_right, frame.depth,
                lf.kp.desc, lf.kp.octave, lf.kp.angle, lf.kp.valid,
                self._dev(geom), self._dev(last_slot, torch.int32), self._dev(pose_pack),
                *self._snap_dev, self.cfg,
            )
        # the frame's one device -> host copy: out_f bits | enc | visible; a
        # prefetch hook (System.track_stereo_prefetch) enqueues the next
        # frame's upload and build behind the copy, before the host waits
        # (pull_after's wait is the `track.readback` span)
        cb, self.prefetch_cb = self.prefetch_cb, None
        out, built = pull_after(torch.cat([out_f.view(torch.int32), out_i]), cb)
        if cb is not None:
            self.prefetch_result = built
        f = out[:30].view(np.float32)
        nm1, nin1, nin2 = int(f[12]), int(f[13]), int(f[14])
        if nm1 < 20 or nin1 < self.cfg.tracking.min_inliers_track:
            return None

        with trace.span("track.bind"):
            enc = out[30:30 + n]
            visible = out[30 + n:] > 0
            snap_ids = self._snap_ids
            bind = np.full(n, -1, np.int64)
            m1 = (enc >= 0) & (enc < n)
            bind[m1] = lm_ids[enc[m1]]
            m2 = enc >= n
            bind[m2] = snap_ids[enc[m2] - n]
            self._bind_cur = bind
            self.ref_kf = ref_kf
            self.map.increment_visible(snap_ids[visible & (snap_ids >= 0)])
            self.map.increment_found(bind[bind >= 0])
            self.n_inliers_last = nin2
            self._kf_close_counts = (int(f[15]), int(f[16]))

        min_in = self._min_inliers_localmap(frame_id)
        if nin2 < min_in:
            # keep the motion-only pose (TrackLocalMap failure does not
            # revert TrackWithMotionModel's estimate)
            self.last_pose = (f[18:27].reshape(3, 3).copy(), f[27:30].copy())
            return False
        self.last_pose = (f[:9].reshape(3, 3).copy(), f[9:12].copy())
        return True

    def _min_inliers_localmap(self, frame_id: int) -> int:
        """TrackLocalMap acceptance; stricter right after a relocalization."""
        min_in = self.cfg.tracking.min_inliers_localmap
        if frame_id < self.last_reloc_frame_id + self.cfg.tracking.max_frames_between_kf:
            min_in = max(min_in, int(round(
                self.cfg.tracking.min_inliers_localmap_recent * self._feature_scale())))
        return min_in

    def _track_local_map(self, frame: Frame, frame_id: int) -> bool:
        """TrackLocalMap after a reference-KF track: match the local map's
        points, re-optimize, count inliers."""
        with trace.span("track.local_map"):
            bind = self._bind_cur
            matched_ids = bind[bind >= 0]
            if len(matched_ids) == 0:
                return False
            sel_res = self._select_local_kfs(matched_ids)
            if sel_res is None:
                return False
            self.ref_kf, local_kfs = sel_res
            with trace.span("track.snapshot"):
                snap = self.map.local_map_snapshot(
                    np.asarray(local_kfs, np.int64), self.cfg.tracking.local_points_cap
                )
            already = np.isin(snap["ids"], matched_ids)
            snap_valid = snap["valid"] & ~already
            R0, t0 = self.last_pose
            bound_mask = bind >= 0
            live = self.map.resolve_replaced(bind)
            bound_xw = self.map.mp_pos[np.clip(live, 0, None)]

            R, t, slot, inlier, n_in, visible = local_track_step(
                self.cam, frame.kp, frame.u_right, self._dev(R0), self._dev(t0),
                self._dev(bound_xw), self._dev(bound_mask),
                self._dev(snap["pos"]), self._dev(snap["normal"]),
                self._dev(snap["min_dist"]), self._dev(snap["max_dist"]),
                desc_from_numpy(snap["desc"], self.device), self._dev(snap_valid), self.cfg,
            )
            with trace.span("track.readback"):
                R, t, slot, inlier, n_in, visible = (
                    x.cpu().numpy() for x in (R, t, slot, inlier, n_in, visible)
                )
            with trace.span("track.bind"):
                n_in = int(n_in)
                new_ok = (slot >= 0) & inlier
                bind = bind.copy()
                bind[new_ok] = snap["ids"][slot[new_ok]]
                bind[~inlier & (bind >= 0) & ~bound_mask] = -1
                bind[~inlier & bound_mask] = -1
                self._bind_cur = bind
                self.map.increment_visible(snap["ids"][visible & (snap["ids"] >= 0)])
                self.map.increment_found(bind[bind >= 0])
                self.n_inliers_last = n_in
            if n_in < self._min_inliers_localmap(frame_id):
                return False
            self.last_pose = (R, t)
            return True

    # ------------------------------------------------------------------
    def _update_motion_model(self):
        if self.last_frame_data is None:
            self.velocity = None
            return
        R_l, t_l = self.last_frame_data["pose"]
        R_c, t_c = self.last_pose
        self.velocity = (_mat(R_c, t_c) @ np.linalg.inv(_mat(R_l, t_l))).astype(np.float32)

    def _need_new_keyframe(self, frame: Frame, frame_id: int) -> bool:
        """NeedNewKeyFrame. Monocular input has no close-point trigger and a
        stricter tracked-ratio gate. Synchronous mapping is always idle; an
        async worker that is busy vetoes the min-frames trigger, and when
        another trigger fires it aborts the worker's local BA and lets
        stereo or RGB-D insert while fewer than 3 keyframes are queued."""
        if self.ref_kf < 0:
            return False
        n_kf = self.map.n_kf
        min_obs = 3 if n_kf > 2 else 2
        ref_mp = self.map.kf_mp[self.ref_kf]
        sel = np.clip(ref_mp, 0, None)
        n_ref = int(
            ((ref_mp >= 0) & self.map.mp_valid[sel] & (self.map.mp_n_obs[sel] >= min_obs)).sum()
        )
        if self._kf_close_counts is not None:
            tracked_close, untracked_close = self._kf_close_counts
        else:
            depth = self._frame_host_arrays(frame)["depth"]
            close = (depth > 0) & (depth < self.cfg.resolved_depth_th())
            tracked_close = int((close & (self._bind_cur >= 0)).sum())
            untracked_close = int((close & (self._bind_cur < 0)).sum())
        need_close = tracked_close < 100 and untracked_close > 70
        frames_since = frame_id - self.last_kf_frame_id
        inl = self.n_inliers_last
        lm = self.local_mapper
        mapping_idle, queue_len = True, 0
        if lm is not None and lm.async_mode:
            queue_len = len(lm.queue)
            mapping_idle = lm.idle()
        c1a = frames_since >= self.cfg.tracking.max_frames_between_kf
        c1b = frames_since >= self.cfg.tracking.min_frames_between_kf and mapping_idle
        mono = self.sensor == "mono"
        c1c = not mono and (inl < n_ref * 0.25 or need_close)
        th_ratio = 0.9 if mono else (0.75 if n_kf >= 2 else 0.4)
        c2 = (inl < n_ref * th_ratio or need_close) and inl > 15
        if not ((c1a or c1b or c1c) and c2):
            return False
        if mapping_idle:
            return True
        lm.abort_ba = True
        return not mono and queue_len < 3

    def _create_new_keyframe(self, frame: Frame, frame_id: int, timestamp: float):
        """CreateNewKeyFrame: promote the frame and spawn map points for the
        closest unbound depths (all closer than ThDepth, at least 100)."""
        R, t = self.last_pose
        bind = self._bind_cur.copy()
        host = self._frame_host_arrays(frame)
        depth = host["depth"]
        kp_valid = host["kp_valid"]
        xy = host["xy"]
        desc = host["desc"]
        cand = np.nonzero((depth > 0) & (bind < 0) & kp_valid)[0]
        if len(cand):
            order = cand[np.argsort(depth[cand], kind="stable")]
            n_close = int((depth[order] < self.cfg.resolved_depth_th()).sum())
            take = order[: min(len(order), max(100, n_close))]
            z = depth[take]
            xc = np.stack(
                [
                    (xy[take, 0] - self.cfg.cx) * z / self.cfg.fx,
                    (xy[take, 1] - self.cfg.cy) * z / self.cfg.fy,
                    z,
                ],
                axis=1,
            ).astype(np.float32)
            xw = (xc - t[None]) @ R  # R^T (xc - t) as row vectors
            bind[take] = self.map.add_map_points_batch(xw, desc[take], first_kf=self.map.next_kf)
        k = self.map.add_keyframe(
            R.astype(np.float32), t.astype(np.float32),
            xy, host["ur"], depth, host["octave"], host["angle"],
            desc, kp_valid, bind, frame_id, timestamp,
        )
        self.map.update_point_stats(bind[bind >= 0])
        self.ref_kf = k
        self.last_kf_frame_id = frame_id
        self._bind_cur = bind
        if self.local_mapper is not None:
            self.local_mapper.insert_keyframe(k, host["words"], frame)

    # ------------------------------------------------------------------
    def _set_metrics(self, frame_id: int, timestamp: float, kf_created: bool):
        self.last_metrics = {
            "frame_id": int(frame_id),
            "timestamp": float(timestamp),
            "state": self.state.name,
            "n_matches": int((self._bind_cur >= 0).sum()),
            "n_inliers": int(self.n_inliers_last),
            "keyframe": bool(kf_created),
            "n_keyframes": int(self.map.n_kf),
            "n_map_points": int(self.map.mp_valid.sum()),
        }

    def _record_frame(self, frame_id: int, timestamp: float, lost: bool):
        if self.last_pose is None or self.ref_kf < 0:
            return
        R, t = self.last_pose
        T_rw = _mat(self.map.kf_R[self.ref_kf], self.map.kf_t[self.ref_kf])
        T_cr = _mat(R, t) @ np.linalg.inv(T_rw)
        self.records.append(FrameRecord(frame_id, timestamp, self.ref_kf,
                                        T_cr.astype(np.float32), lost))

    def reset(self):
        """Back to NO_IMAGES_YET with empty trajectory records."""
        self.state = TrackState.NO_IMAGES_YET
        self.velocity = None
        self.last_pose = None
        self.last_frame_data = None
        self.ref_kf = -1
        self.last_kf_frame_id = -1
        self.records.clear()
        self.n_inliers_last = 0
        self.vo_mode = False
        self.last_reloc_frame_id = -(1 << 30)
        self._mono_ref = None
        self._bind_cur = np.full(self.cfg.orb.n_features, -1, np.int64)
        self._fh = None
        self._snap_key = None
        self._snap_dev = None
        self._snap_ids = None
        self._kf_close_counts = None
        self._ref_anchor = None

    def _stash_last_frame(self, frame: Frame, frame_id: int = -1):
        host = self._fh[1] if self._fh is not None and self._fh[0] is frame else None
        self.last_frame_data = LastFrame(
            self, frame, frame_id, self._bind_cur.copy(), self.last_pose, host
        )
        if self.ref_kf >= 0:
            self._ref_anchor = (
                int(self.ref_kf),
                self.map.kf_R[self.ref_kf].astype(np.float64).copy(),
                self.map.kf_t[self.ref_kf].astype(np.float64).copy(),
            )
        else:
            self._ref_anchor = None

    def trajectory(self) -> List[Tuple[float, np.ndarray]]:
        """Per-frame (timestamp, Twc [4,4]), resolving reference-KF poses now."""
        out = []
        for rec in self.records:
            T_cw = rec.T_cr @ self.map.resolve_kf_pose(rec.ref_kf)
            out.append((rec.timestamp, np.linalg.inv(T_cw)))
        return out


def _mat(R, t):
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = R
    T[:3, 3] = t
    return T
