"""The port's own copy of orb_slam2_2021_tpu/mapping/map_store.py: plain Python and
numpy, the same behaviour.

The global map: keyframes, map points, observations, covisibility.

Replaces Map/KeyFrame/MapPoint (/root/reference/src/Map.cc:28-146,
KeyFrame.cc, MapPoint.cc) with flat arrays:

- keyframe block: poses [K,3,3]+[K,3] (Tcw), per-feature records [K,N,...],
  feature->map-point binding kf_mp [K,N];
- map-point block: positions [M,3], distinctive descriptors [M,8],
  viewing normal + scale band, found/visible stats;
- observation reverse index: mp_obs_kf/feat [M,O] (capped fan-in);
- covisibility weights as a dense [K,K] int32 matrix (the reference's
  per-KF weight maps, KeyFrame.cc:304-395) + spanning-tree parent array and
  loop-edge sets (KeyFrame.cc:469-562 SetBadFlag reparenting semantics).

Single-writer discipline: only the mapping pipeline mutates; tracking reads
immutable snapshots. No locks — the Python GIL plus snapshot copies give the
consistency the reference gets from Map::mMutexMapUpdate (Tracking.cc:297).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ..config import SlamConfig
from .. import native

OBS_CAP = 32  # initial per-point observation fan-in (grows by doubling)


class MapStore:
    """All arrays grow by doubling on the host when full (cfg.max_keyframes /
    cfg.max_map_points are the INITIAL capacities); jitted consumers see
    fixed-size padded snapshots, so growth never retraces device code."""

    def __init__(self, cfg: SlamConfig):
        self.cfg = cfg
        # the map-update lock (Map::mMutexMapUpdate, Tracking.cc:297): held by
        # the tracking lane for its host-side map section and by the mapping
        # worker for mutations; long device solves run outside it on padded
        # snapshots and re-validate at write-back. Reentrant so the sync mode
        # (everything on one thread) is unchanged.
        self.lock = threading.RLock()
        self._alloc()

    def clear(self):
        """Map::clear (Map.cc:133-146) + the id-counter resets in
        Tracking::Reset (Tracking.cc:1568-1570): drop every keyframe and map
        point and restart ids from 0. Capacities return to the configured
        initial sizes."""
        self._alloc()

    def _alloc(self):
        cfg = self.cfg
        K = cfg.max_keyframes
        M = cfg.max_map_points
        N = cfg.orb.n_features
        self.obs_cap = OBS_CAP
        # coarse mutation counter: bumped on keyframe/point insertion and by
        # the mapping/loop workers after each write-back batch. The tracker
        # keys its device-cached local-map snapshot on it so stale geometry
        # is never reused after BA/fusion/loop corrections.
        self.write_epoch = 0

        # --- keyframes ---
        self.kf_valid = np.zeros(K, bool)
        self.kf_R = np.zeros((K, 3, 3), np.float32)  # Tcw rotation
        self.kf_t = np.zeros((K, 3), np.float32)
        self.kf_xy = np.zeros((K, N, 2), np.float32)
        self.kf_ur = np.full((K, N), -1.0, np.float32)
        self.kf_depth = np.full((K, N), -1.0, np.float32)
        self.kf_octave = np.zeros((K, N), np.int32)
        self.kf_angle = np.zeros((K, N), np.float32)
        self.kf_desc = np.zeros((K, N, 8), np.uint32)
        self.kf_feat_valid = np.zeros((K, N), bool)
        self.kf_mp = np.full((K, N), -1, np.int64)  # feature -> map point id
        self.kf_frame_id = np.zeros(K, np.int64)
        self.kf_timestamp = np.zeros(K, np.float64)
        self.n_kf = 0
        self.next_kf = 0  # monotonically increasing id == array slot

        # covisibility / spanning tree / loop edges
        self.covis = np.zeros((K, K), np.int32)
        self.parent = np.full(K, -1, np.int64)
        self.children: Dict[int, Set[int]] = {}
        self.loop_edges: Dict[int, Set[int]] = {}
        self.kf_not_erase = np.zeros(K, bool)
        self.kf_to_be_erased = np.zeros(K, bool)
        # mTcp (KeyFrame.cc:556): relative pose to the parent stored at cull
        # time so trajectories referencing culled KFs stay resolvable (and
        # receive later loop/GBA corrections through the live ancestor) —
        # System.cc:418-420, 510-513 walk this chain in the savers
        self.culled_tcp: Dict[int, Tuple[np.ndarray, int]] = {}
        # invoked with the culled id AFTER a successful erase (System wires
        # this to KeyFrameDatabase.erase — KeyFrame.cc:561); survives clear()
        self.on_kf_erased = getattr(self, "on_kf_erased", None)

        # --- map points ---
        self.mp_valid = np.zeros(M, bool)
        self.mp_pos = np.zeros((M, 3), np.float32)
        self.mp_desc = np.zeros((M, 8), np.uint32)
        self.mp_normal = np.zeros((M, 3), np.float32)
        self.mp_min_dist = np.zeros(M, np.float32)
        self.mp_max_dist = np.zeros(M, np.float32)
        self.mp_n_obs = np.zeros(M, np.int32)
        self.mp_visible = np.ones(M, np.int32)
        self.mp_found = np.ones(M, np.int32)
        self.mp_first_kf = np.full(M, -1, np.int64)
        self.mp_obs_kf = np.full((M, self.obs_cap), -1, np.int64)
        self.mp_obs_feat = np.full((M, self.obs_cap), -1, np.int32)
        self.mp_obs_n = np.zeros(M, np.int32)
        self.mp_replaced_by = np.full(M, -1, np.int64)  # Replace() forwarding
        self.next_mp = 0

        # scale pyramid constants (PredictScale, MapPoint.cc:415-447)
        self.scale_factors = np.array(
            [cfg.orb.scale_factor ** i for i in range(cfg.orb.n_levels)], np.float32
        )
        self.log_scale = float(np.log(cfg.orb.scale_factor))

        self.big_change_idx = 0  # Map::InformNewBigChange (Map.cc)

    # ------------------------------------------------------------------
    # capacity growth (grow-by-doubling; the reference's pointer graph is
    # unbounded, ours is amortized-O(1) reallocation)
    # ------------------------------------------------------------------
    @property
    def kf_capacity(self) -> int:
        return len(self.kf_valid)

    @property
    def mp_capacity(self) -> int:
        return len(self.mp_valid)

    @staticmethod
    def _grown(a: np.ndarray, new_n: int, fill) -> np.ndarray:
        out = np.full((new_n, *a.shape[1:]), fill, a.dtype)
        out[: len(a)] = a
        return out

    _KF_GROW = [
        ("kf_valid", False), ("kf_R", 0.0), ("kf_t", 0.0), ("kf_xy", 0.0),
        ("kf_ur", -1.0), ("kf_depth", -1.0), ("kf_octave", 0), ("kf_angle", 0.0),
        ("kf_desc", 0), ("kf_feat_valid", False), ("kf_mp", -1),
        ("kf_frame_id", 0), ("kf_timestamp", 0.0), ("parent", -1),
        ("kf_not_erase", False), ("kf_to_be_erased", False),
    ]
    _MP_GROW = [
        ("mp_valid", False), ("mp_pos", 0.0), ("mp_desc", 0), ("mp_normal", 0.0),
        ("mp_min_dist", 0.0), ("mp_max_dist", 0.0), ("mp_n_obs", 0),
        ("mp_visible", 1), ("mp_found", 1), ("mp_first_kf", -1),
        ("mp_obs_kf", -1), ("mp_obs_feat", -1), ("mp_obs_n", 0),
        ("mp_replaced_by", -1),
    ]

    def ensure_kf_capacity(self, n: int):
        K = self.kf_capacity
        if n <= K:
            return
        new_K = K
        while new_K < n:
            new_K *= 2
        for name, fill in self._KF_GROW:
            setattr(self, name, self._grown(getattr(self, name), new_K, fill))
        covis = np.zeros((new_K, new_K), np.int32)
        covis[:K, :K] = self.covis
        self.covis = covis

    def ensure_mp_capacity(self, n: int):
        M = self.mp_capacity
        if n <= M:
            return
        new_M = M
        while new_M < n:
            new_M *= 2
        for name, fill in self._MP_GROW:
            setattr(self, name, self._grown(getattr(self, name), new_M, fill))

    def _grow_obs_cap(self):
        """Double the per-point observation fan-in columns."""
        cap = self.obs_cap
        self.mp_obs_kf = np.concatenate(
            [self.mp_obs_kf, np.full((len(self.mp_obs_kf), cap), -1, np.int64)], axis=1
        )
        self.mp_obs_feat = np.concatenate(
            [self.mp_obs_feat, np.full((len(self.mp_obs_feat), cap), -1, np.int32)], axis=1
        )
        self.obs_cap = 2 * cap

    # ------------------------------------------------------------------
    # keyframe lifecycle
    # ------------------------------------------------------------------
    def add_keyframe(
        self,
        R_cw: np.ndarray,
        t_cw: np.ndarray,
        xy: np.ndarray,
        ur: np.ndarray,
        depth: np.ndarray,
        octave: np.ndarray,
        angle: np.ndarray,
        desc: np.ndarray,
        feat_valid: np.ndarray,
        mp_bind: np.ndarray,
        frame_id: int = 0,
        timestamp: float = 0.0,
    ) -> int:
        k = self.next_kf
        self.ensure_kf_capacity(k + 1)
        # one binding per point per keyframe: the matcher stages (motion +
        # local fused step) can both bind the same landmark at two features;
        # the reference's AddObservation silently refuses the duplicate and
        # leaves the second feature binding dangling (MapPoint.cc:128-139) —
        # we drop the duplicate binding instead so kf_mp <-> mp_obs stay
        # exact mirrors (check_invariants)
        mp_bind = np.asarray(mp_bind).copy()
        # re-validate: between the tracker's match snapshot and this insert
        # the mapping worker may have culled or replaced points (the
        # reference re-checks isBad() in ProcessNewKeyFrame,
        # LocalMapping.cc:141-160)
        sel = np.clip(mp_bind, 0, None)
        live = np.where(
            (mp_bind >= 0) & ~self.mp_valid[sel], self.mp_replaced_by[sel], mp_bind
        )
        live_sel = np.clip(live, 0, None)
        mp_bind = np.where(
            (live >= 0) & self.mp_valid[live_sel], live, -1
        )
        bound_feats = np.nonzero(mp_bind >= 0)[0]
        if len(bound_feats):
            _, first = np.unique(mp_bind[bound_feats], return_index=True)
            dup = np.ones(len(bound_feats), bool)
            dup[first] = False
            mp_bind[bound_feats[dup]] = -1
        self.kf_valid[k] = True
        self.kf_R[k] = R_cw
        self.kf_t[k] = t_cw
        self.kf_xy[k] = xy
        self.kf_ur[k] = ur
        self.kf_depth[k] = depth
        self.kf_octave[k] = octave
        self.kf_angle[k] = angle
        self.kf_desc[k] = desc
        self.kf_feat_valid[k] = feat_valid
        self.kf_mp[k] = mp_bind
        self.kf_frame_id[k] = frame_id
        self.kf_timestamp[k] = timestamp
        self.next_kf += 1
        self.n_kf += 1
        self.write_epoch += 1
        # bind observations on the map-point side (native batch path when the
        # C++ kernels are built; python loop otherwise)
        bound = mp_bind[mp_bind >= 0]
        if len(bound) and (self.mp_obs_n[bound] >= self.obs_cap).any():
            self._grow_obs_cap()  # one KF adds <= 1 obs per point
        if native.HAVE_NATIVE:
            native.batch_add_observations(
                k, self.kf_mp[k], self.kf_ur[k],
                self.mp_obs_kf, self.mp_obs_feat, self.mp_obs_n, self.mp_n_obs,
                self.obs_cap,
            )
        else:
            feats = np.nonzero(mp_bind >= 0)[0]
            for f in feats:
                self._add_observation(int(mp_bind[f]), k, int(f))
        self.update_connections(k)
        return k

    def erase_keyframe(self, k: int):
        """KeyFrame::SetBadFlag (KeyFrame.cc:469-562): unbind observations,
        reparent children to the best covisible candidate in the parent set."""
        if k == 0 or not self.kf_valid[k]:
            return  # first KF never culled (KeyFrame.cc:471)
        if self.kf_not_erase[k]:
            self.kf_to_be_erased[k] = True
            return
        # mTcp: relative pose to the parent at cull time (KeyFrame.cc:556);
        # resolve_kf_pose walks this chain for trajectory export
        p = int(self.parent[k])
        if p >= 0:
            T_cw = np.eye(4, dtype=np.float32)
            T_cw[:3, :3] = self.kf_R[k]
            T_cw[:3, 3] = self.kf_t[k]
            T_pw = np.eye(4, dtype=np.float32)
            T_pw[:3, :3] = self.kf_R[p]
            T_pw[:3, 3] = self.kf_t[p]
            self.culled_tcp[k] = (T_cw @ np.linalg.inv(T_pw), p)
        for f in np.nonzero(self.kf_mp[k] >= 0)[0]:
            self._remove_observation(int(self.kf_mp[k][f]), k)
        self.kf_mp[k] = -1
        # reparent children: greedy max-weight to the ancestor candidate set
        kids = set(self.children.get(k, set()))
        candidates = {int(self.parent[k])} if self.parent[k] >= 0 else set()
        while kids:
            best_w, best_child, best_parent = -1, None, None
            for c in kids:
                # child connects to a candidate via covisibility?
                for p in candidates:
                    w = int(self.covis[c, p])
                    if w > best_w:
                        best_w, best_child, best_parent = w, c, p
            if best_child is None or best_w <= 0:
                break
            self._set_parent(best_child, best_parent)
            candidates.add(best_child)
            kids.discard(best_child)
        # leftovers hang off the erased KF's parent (KeyFrame.cc:546-552)
        for c in kids:
            self._set_parent(c, int(self.parent[k]))
        self.children.pop(k, None)
        # clear covisibility
        self.covis[k, :] = 0
        self.covis[:, k] = 0
        self.kf_valid[k] = False
        self.n_kf -= 1
        if self.on_kf_erased is not None:
            self.on_kf_erased(k)

    def resolve_kf_pose(self, k: int) -> np.ndarray:
        """T_cw of keyframe k, walking the culled-KF relative-pose chain to
        the first live spanning-tree ancestor (the savers' `while isBad():
        Trw = Trw * mTcp` walk, System.cc:418-420, 510-513). Culled KFs thus
        inherit every later loop/GBA correction through their ancestor."""
        T = np.eye(4, dtype=np.float32)
        seen = set()
        while k >= 0 and not self.kf_valid[k] and k not in seen:
            seen.add(k)
            entry = self.culled_tcp.get(k)
            if entry is None:
                break
            T_cp, k = entry[0], int(entry[1])
            T = T @ T_cp
        T_aw = np.eye(4, dtype=np.float32)
        if k >= 0:
            T_aw[:3, :3] = self.kf_R[k]
            T_aw[:3, 3] = self.kf_t[k]
        return T @ T_aw

    def set_erase(self, k: int):
        """KeyFrame::SetErase (KeyFrame.cc:446-467): lift loop-detection
        protection and run a deferred cull."""
        self.kf_not_erase[k] = False
        if self.kf_to_be_erased[k]:
            self.kf_to_be_erased[k] = False
            self.erase_keyframe(k)

    def _set_parent(self, child: int, parent: int):
        old = int(self.parent[child])
        if old >= 0:
            self.children.get(old, set()).discard(child)
        self.parent[child] = parent
        if parent >= 0:
            self.children.setdefault(parent, set()).add(child)

    def update_connections(self, k: int):
        """KeyFrame::UpdateConnections (KeyFrame.cc:304-395): covisibility
        weights = shared map-point counts; edges kept if weight >= th (15) or
        at least the single best; parent = max-weight neighbor for new KFs."""
        counts = np.zeros(self.kf_capacity, np.int32)
        if native.HAVE_NATIVE:
            native.covis_counts(k, self.kf_mp[k], self.mp_obs_kf, self.mp_obs_n, self.obs_cap, counts)
        else:
            mps = self.kf_mp[k]
            mps = mps[mps >= 0]
            if len(mps):
                obs_kf = self.mp_obs_kf[mps].reshape(-1)
                obs_kf = obs_kf[(obs_kf >= 0) & (obs_kf != k)]
                if len(obs_kf):
                    np.add.at(counts, obs_kf, 1)
        th = self.cfg.covis.weight_th
        keep = counts >= th
        if not keep.any() and counts.max(initial=0) > 0:
            keep = counts == counts.max()
        weights = np.where(keep, counts, 0)
        self.covis[k, :] = weights
        self.covis[:, k] = weights
        if self.parent[k] < 0 and k != 0 and weights.max(initial=0) > 0:
            self._set_parent(k, int(np.argmax(weights)))

    def covisible_keyframes(self, k: int, n: Optional[int] = None) -> np.ndarray:
        """GetBestCovisibilityKeyFrames (KeyFrame.cc:175-183)."""
        w = self.covis[k]
        order = np.argsort(-w, kind="stable")
        order = order[w[order] > 0]
        return order[:n] if n is not None else order

    # ------------------------------------------------------------------
    # map points
    # ------------------------------------------------------------------
    def add_map_point(self, pos, desc, first_kf: int) -> int:
        m = self.next_mp
        self.ensure_mp_capacity(m + 1)
        self.mp_valid[m] = True
        self.mp_pos[m] = pos
        self.mp_desc[m] = desc
        self.mp_first_kf[m] = first_kf
        self.mp_n_obs[m] = 0
        self.mp_visible[m] = 1
        self.mp_found[m] = 1
        self.next_mp += 1
        return m

    def add_map_points_batch(self, pos, desc, first_kf: int) -> np.ndarray:
        """Vectorized bulk insert; returns the new ids."""
        n = len(pos)
        m0 = self.next_mp
        self.ensure_mp_capacity(m0 + n)
        sl = slice(m0, m0 + n)
        self.mp_valid[sl] = True
        self.mp_pos[sl] = pos
        self.mp_desc[sl] = desc
        self.mp_first_kf[sl] = first_kf
        self.mp_n_obs[sl] = 0
        self.mp_visible[sl] = 1
        self.mp_found[sl] = 1
        self.next_mp += n
        self.write_epoch += 1
        return np.arange(m0, m0 + n)

    def _add_observation(self, m: int, k: int, feat: int):
        """MapPoint::AddObservation (MapPoint.cc:128-139); stereo features
        count 2 toward nObs."""
        n = self.mp_obs_n[m]
        if n >= self.obs_cap:
            self._grow_obs_cap()
        # already observed by this KF?
        if (self.mp_obs_kf[m, :n] == k).any():
            return
        self.mp_obs_kf[m, n] = k
        self.mp_obs_feat[m, n] = feat
        self.mp_obs_n[m] = n + 1
        stereo = self.kf_ur[k, feat] >= 0
        self.mp_n_obs[m] += 2 if stereo else 1

    def _remove_observation(self, m: int, k: int):
        """MapPoint::EraseObservation (MapPoint.cc:141-167)."""
        n = self.mp_obs_n[m]
        idx = np.nonzero(self.mp_obs_kf[m, :n] == k)[0]
        if len(idx) == 0:
            return
        i = idx[0]
        feat = self.mp_obs_feat[m, i]
        stereo = self.kf_ur[k, feat] >= 0
        self.mp_n_obs[m] -= 2 if stereo else 1
        self.mp_obs_kf[m, i : n - 1] = self.mp_obs_kf[m, i + 1 : n]
        self.mp_obs_feat[m, i : n - 1] = self.mp_obs_feat[m, i + 1 : n]
        self.mp_obs_kf[m, n - 1] = -1
        self.mp_obs_feat[m, n - 1] = -1
        self.mp_obs_n[m] = n - 1
        if self.mp_n_obs[m] <= 2:
            self.erase_map_point(m)

    def erase_map_point(self, m: int):
        """MapPoint::SetBadFlag: unbind from all observing KFs."""
        if not self.mp_valid[m]:
            return
        n = self.mp_obs_n[m]
        for i in range(n):
            k, f = int(self.mp_obs_kf[m, i]), int(self.mp_obs_feat[m, i])
            if k >= 0 and self.kf_mp[k, f] == m:
                self.kf_mp[k, f] = -1
        self.mp_obs_kf[m, :] = -1
        self.mp_obs_feat[m, :] = -1
        self.mp_obs_n[m] = 0
        self.mp_n_obs[m] = 0
        self.mp_valid[m] = False

    def replace_map_point(self, m_old: int, m_new: int):
        """MapPoint::Replace (MapPoint.cc:207-245): rebind all observations of
        m_old to m_new (skipping KFs already observing m_new)."""
        if m_old == m_new or not self.mp_valid[m_old]:
            return
        n = self.mp_obs_n[m_old]
        obs = [(int(self.mp_obs_kf[m_old, i]), int(self.mp_obs_feat[m_old, i])) for i in range(n)]
        self.mp_found[m_new] += self.mp_found[m_old]
        self.mp_visible[m_new] += self.mp_visible[m_old]
        # drop m_old first so _add_observation sees a clean slate
        self.mp_obs_kf[m_old, :] = -1
        self.mp_obs_feat[m_old, :] = -1
        self.mp_obs_n[m_old] = 0
        self.mp_n_obs[m_old] = 0
        self.mp_valid[m_old] = False
        self.mp_replaced_by[m_old] = m_new
        nn = self.mp_obs_n[m_new]
        seen = set(self.mp_obs_kf[m_new, :nn].tolist())
        for k, f in obs:
            if k in seen:
                self.kf_mp[k, f] = -1
            else:
                self.kf_mp[k, f] = m_new
                self._add_observation(m_new, k, f)

    def resolve_replaced(self, ids: np.ndarray) -> np.ndarray:
        """Follow Replace() forwarding chains (vectorized, bounded depth)."""
        out = ids.copy()
        for _ in range(4):
            live = out >= 0
            fwd = np.where(live, self.mp_replaced_by[np.clip(out, 0, None)], -1)
            out = np.where(fwd >= 0, fwd, out)
        return out

    # ------------------------------------------------------------------
    # derived per-point state
    # ------------------------------------------------------------------
    def update_point_stats(self, ids: np.ndarray):
        """UpdateNormalAndDepth + ComputeDistinctiveDescriptors
        (MapPoint.cc:360-401, 272-337) for a batch of points, vectorized over
        observations."""
        ids = np.asarray([m for m in np.unique(ids) if m >= 0 and self.mp_valid[m]])
        if len(ids) == 0:
            return
        if native.HAVE_NATIVE:
            native.update_point_stats(
                ids, self.mp_pos, self.mp_obs_kf, self.mp_obs_feat,
                self.mp_obs_n, self.obs_cap,
                self.kf_R, self.kf_t, self.kf_desc, self.kf_octave,
                self.cfg.orb.n_features, self.scale_factors,
                self.mp_normal, self.mp_min_dist, self.mp_max_dist, self.mp_desc,
            )
            return
        for m in ids:
            n = int(self.mp_obs_n[m])
            if n == 0:
                continue
            kfs = self.mp_obs_kf[m, :n]
            feats = self.mp_obs_feat[m, :n]
            pos = self.mp_pos[m]
            # viewing normal: mean of unit vectors from KF centers
            centers = self._kf_centers(kfs)
            vecs = pos[None] - centers
            norms = np.linalg.norm(vecs, axis=1, keepdims=True) + 1e-9
            normal = (vecs / norms).mean(axis=0)
            self.mp_normal[m] = normal / (np.linalg.norm(normal) + 1e-9)
            # scale band from the reference KF (last obs; ref uses mnFirst...
            # actually pRefKF = mObservations.begin; we use the first)
            k0, f0 = int(kfs[0]), int(feats[0])
            dist = float(np.linalg.norm(pos - self._kf_centers(np.array([k0]))[0]))
            level = int(self.kf_octave[k0, f0])
            s = self.scale_factors
            self.mp_max_dist[m] = dist * s[level]
            self.mp_min_dist[m] = self.mp_max_dist[m] / s[-1]
            # distinctive descriptor: min median Hamming among observations
            descs = self.kf_desc[kfs, feats]  # [n, 8]
            x = descs[:, None, :] ^ descs[None, :, :]
            d = np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)
            med = np.median(d, axis=1)
            self.mp_desc[m] = descs[int(np.argmin(med))]

    def _kf_centers(self, kfs: np.ndarray) -> np.ndarray:
        """Camera centers Ow = -R^T t for keyframe ids."""
        R = self.kf_R[kfs]
        t = self.kf_t[kfs]
        return -np.einsum("nij,ni->nj", R, t)

    # ------------------------------------------------------------------
    # snapshots for jitted steps
    # ------------------------------------------------------------------
    def local_map_snapshot(self, center_kfs: np.ndarray, max_points: int):
        """Collect the union of map points seen by `center_kfs` (the local
        keyframe set, Tracking::UpdateLocalPoints) as fixed-size arrays.

        Returns dict of numpy arrays padded to max_points + the id vector.
        """
        mps = self.kf_mp[center_kfs]
        mps = np.unique(mps[mps >= 0])
        mps = mps[self.mp_valid[mps]]
        if len(mps) > max_points:
            # prefer well-observed points
            order = np.argsort(-self.mp_n_obs[mps], kind="stable")
            mps = mps[order[:max_points]]
        P = max_points
        pad = P - len(mps)
        ids = np.concatenate([mps, np.full(pad, -1, np.int64)])
        sel = np.clip(ids, 0, None)
        snap = {
            "pos": self.mp_pos[sel].copy(),
            "desc": self.mp_desc[sel].copy(),
            "normal": self.mp_normal[sel].copy(),
            "min_dist": self.mp_min_dist[sel].copy(),
            "max_dist": self.mp_max_dist[sel].copy(),
            "valid": ids >= 0,
            "ids": ids,
        }
        return snap

    def check_invariants(self, strict: bool = True):
        """Cross-check the SoA map's bidirectional bookkeeping — the
        invariants the reference maintains with per-object mutexes
        (KeyFrame/MapPoint mutexes, SURVEY.md §2 mutex inventory) and we
        maintain with the coarse map lock + snapshot discipline. Used by the
        thread-interleaving stress test (our sanitizer substitute: the
        reference ships with no TSan either, SURVEY.md §5).

        Returns a list of violation strings (empty = consistent)."""
        bad = []
        kfs = np.nonzero(self.kf_valid)[0]
        # 1. every keyframe binding is mirrored in the point's observation list
        for k in kfs:
            mp = self.kf_mp[k]
            feats = np.nonzero(mp >= 0)[0]
            for f in feats:
                m = int(mp[f])
                if not self.mp_valid[m]:
                    bad.append(f"kf {k} feat {f} bound to dead point {m}")
                    continue
                n = self.mp_obs_n[m]
                idx = np.nonzero(self.mp_obs_kf[m, :n] == k)[0]
                if len(idx) == 0:
                    bad.append(f"kf {k} feat {f} -> point {m} missing reverse obs")
                elif int(self.mp_obs_feat[m, idx[0]]) != int(f):
                    bad.append(
                        f"kf {k} point {m}: obs feat "
                        f"{int(self.mp_obs_feat[m, idx[0]])} != bound feat {f}"
                    )
        # 2. every observation points back at a live, correctly-bound KF slot
        for m in np.nonzero(self.mp_valid)[0]:
            n = self.mp_obs_n[m]
            obs_k = self.mp_obs_kf[m, :n]
            if (obs_k < 0).any():
                bad.append(f"point {m}: -1 inside obs list (n={n})")
                continue
            for i in range(n):
                k, f = int(obs_k[i]), int(self.mp_obs_feat[m, i])
                if not self.kf_valid[k]:
                    bad.append(f"point {m} observed by dead kf {k}")
                elif int(self.kf_mp[k, f]) != m:
                    bad.append(
                        f"point {m} obs ({k},{f}) not mirrored: kf_mp={int(self.kf_mp[k, f])}"
                    )
            # stereo obs count 2 (MapPoint.cc:128-139)
            expect = sum(
                2 if self.kf_ur[int(obs_k[i]), int(self.mp_obs_feat[m, i])] >= 0 else 1
                for i in range(n) if self.kf_valid[int(obs_k[i])]
            )
            if strict and expect != int(self.mp_n_obs[m]):
                bad.append(f"point {m}: mp_n_obs {int(self.mp_n_obs[m])} != {expect}")
        # 3. covisibility symmetry + no self-parenting cycles among live KFs
        for k in kfs:
            w = self.covis[k]
            nbs = np.nonzero(w > 0)[0]
            for nb in nbs:
                if self.kf_valid[nb] and self.covis[nb, k] != w[nb]:
                    bad.append(f"covis asymmetric ({k},{nb}): {w[nb]} vs {self.covis[nb, k]}")
            p = int(self.parent[k])
            if p == k:
                bad.append(f"kf {k} is its own parent")
        return bad

    def increment_visible(self, ids: np.ndarray):
        ids = ids[ids >= 0]
        np.add.at(self.mp_visible, ids, 1)

    def increment_found(self, ids: np.ndarray):
        ids = ids[ids >= 0]
        np.add.at(self.mp_found, ids, 1)

    def found_ratio(self) -> np.ndarray:
        return self.mp_found / np.maximum(self.mp_visible, 1)
