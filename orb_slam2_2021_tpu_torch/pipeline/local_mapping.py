"""Local mapping, synchronous stereo path (counterpart of
orb_slam2_2021_tpu/pipeline/local_mapping.py).

Per inserted keyframe (LocalMapping::Run):
  1. observation binding and covisibility (done at insert by MapStore);
  2. recent map-point culling (MapPointCulling);
  3. new points triangulated against the covisible neighbours
     (CreateNewMapPoints) and neighbour fusion both ways (SearchInNeighbors),
     as bounded device units with one device -> host copy each;
  4. local bundle adjustment (reduced-camera LM with PCG, optim/ba_cg.py);
  5. keyframe culling (KeyFrameCulling);
  6. with a loop closer attached, the keyframe and its BoW words go to loop
     closing, which runs inline.

Not ported yet (ROADMAP.md): the async worker, its abort and pacing
(step 11); monocular mapping (step 10); the dense BA path
`use_cg_local_ba=False`.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from ..convert import camera_from_config, desc_from_numpy, tensor, to_host
from ..optim.assemble import assemble_ba_problem, upload_problem
from ..optim.ba_cg import lm_chunk_pq
from .mapping_steps import KFView, fuse_project, triangulate_pair

FUSE_TARGETS_PER_UNIT = 8   # target keyframes per forward-fuse launch
FUSE_POINTS_PER_UNIT = 4096  # points per backward-fuse launch


class DeviceKFStore:
    """Per-keyframe feature data (descriptors, coordinates, stereo, depth,
    octaves) on the device. Features never change once a keyframe exists,
    so each keyframe's rows are written once: copied from the live tracking
    frame that became the keyframe, or uploaded from the host map store. The
    copy means a keyframe never shares storage with a frame the lane later
    drops or reuses."""

    def __init__(self, cap_kf: int, n_feat: int, device):
        self.cap = cap_kf
        dev = torch.device(device)
        self.device = dev
        self.desc = torch.zeros((cap_kf, n_feat, 8), dtype=torch.int32, device=dev)
        self.xy = torch.zeros((cap_kf, n_feat, 2), dtype=torch.float32, device=dev)
        self.ur = torch.full((cap_kf, n_feat), -1.0, dtype=torch.float32, device=dev)
        self.depth = torch.full((cap_kf, n_feat), -1.0, dtype=torch.float32, device=dev)
        self.octave = torch.zeros((cap_kf, n_feat), dtype=torch.int32, device=dev)
        self.uploaded = np.zeros(cap_kf, bool)

    def set_from_frame(self, k: int, frame):
        """Copy a live tracking frame's device tensors into slot k."""
        self.desc[k].copy_(frame.kp.desc)
        self.xy[k].copy_(frame.kp.xy)
        self.ur[k].copy_(frame.u_right)
        self.depth[k].copy_(frame.depth)
        self.octave[k].copy_(frame.kp.octave)
        self.uploaded[k] = True

    def set_from_host(self, k: int, m):
        """Upload slot k from the host map store."""
        self.desc[k].copy_(desc_from_numpy(m.kf_desc[k], self.device))
        self.xy[k].copy_(tensor(m.kf_xy[k], self.device))
        self.ur[k].copy_(tensor(m.kf_ur[k], self.device))
        self.depth[k].copy_(tensor(m.kf_depth[k], self.device))
        self.octave[k].copy_(tensor(m.kf_octave[k], self.device))
        self.uploaded[k] = True

    def maybe_grow(self, cap_kf: int):
        if cap_kf <= self.cap:
            return

        def grow(a, fill=0):
            new = torch.full((cap_kf,) + tuple(a.shape[1:]), fill, dtype=a.dtype, device=a.device)
            new[: self.cap] = a
            return new

        self.desc = grow(self.desc)
        self.xy = grow(self.xy)
        self.ur = grow(self.ur, -1.0)
        self.depth = grow(self.depth, -1.0)
        self.octave = grow(self.octave)
        up = np.zeros(cap_kf, bool)
        up[: self.cap] = self.uploaded
        self.uploaded = up
        self.cap = cap_kf

    def reset(self):
        """After a map clear keyframe slots restart at 0: force re-uploads."""
        self.uploaded[:] = False

    def ensure(self, ks, m):
        self.maybe_grow(m.kf_capacity)
        for k in ks:
            if not self.uploaded[int(k)]:
                self.set_from_host(int(k), m)

    def gather_views(self, idx: np.ndarray, valid: np.ndarray,
                     R: np.ndarray, t: np.ndarray) -> KFView:
        """[T]-stacked KFView: features gathered on the device, the mutable
        mask and poses uploaded."""
        di = torch.from_numpy(idx.astype(np.int64)).to(self.device)
        return KFView(
            xy=self.xy[di], ur=self.ur[di], depth=self.depth[di],
            octave=self.octave[di], desc=self.desc[di],
            valid=tensor(valid, self.device),
            R=tensor(R.astype(np.float32), self.device),
            t=tensor(t.astype(np.float32), self.device),
        )


class LocalMapping:
    def __init__(self, cfg, map_store, device):
        if not cfg.optim.use_cg_local_ba:
            raise NotImplementedError(
                "the dense local BA (use_cg_local_ba=False) is not ported (ROADMAP.md queue 1, step 8)")
        self.cfg = cfg
        self.map = map_store
        self.device = torch.device(device)
        self.cam = camera_from_config(cfg)
        self.queue: Deque[tuple] = deque()  # (keyframe, BoW words or None)
        self.recent: Dict[int, int] = {}  # mp id -> created-at kf id
        self.abort_ba = False  # mbAbortBA: set by a newly inserted keyframe
        self.ba_solve_times: List[tuple] = []  # (seconds, lm_iterations)
        self._devkf: Optional[DeviceKFStore] = None
        self.loop_closer = None  # set by System when loop closing is on

    def _store(self) -> DeviceKFStore:
        if self._devkf is None:
            self._devkf = DeviceKFStore(self.map.kf_capacity, self.cfg.orb.n_features, self.device)
        self._devkf.maybe_grow(self.map.kf_capacity)
        return self._devkf

    def insert_keyframe(self, k: int, words, frame):
        """Queue keyframe k with its BoW words (None without place
        recognition), copying the features of the live frame it was
        promoted from into the device store."""
        self._store().set_from_frame(k, frame)
        self.queue.append((k, words))
        self.abort_ba = True
        mps = self.map.kf_mp[k]
        for m in mps[mps >= 0]:
            if self.map.mp_first_kf[m] == self.map.kf_frame_id[k] or self.map.mp_first_kf[m] == k:
                self.recent[int(m)] = k

    def _pop(self):
        if not self.queue:
            return None
        item = self.queue.popleft()
        self.abort_ba = bool(self.queue)
        return item

    def process_pending(self):
        while True:
            item = self._pop()
            if item is None:
                return
            self._process(*item)

    def request_reset(self):
        """RequestReset: drop the queued keyframes so the caller can clear
        the map."""
        self.queue.clear()
        self.recent.clear()
        self.abort_ba = False
        if self._devkf is not None:
            self._devkf.reset()

    def _process(self, k: int, words=None):
        """The per-keyframe pipeline."""
        if not self.map.kf_valid[k]:
            return
        self._cull_recent_points(k)
        self._mapping_device_pass(k)
        if self.map.n_kf > 2 and not self.queue:
            self._local_ba(k)
        self._cull_keyframes(k)
        self.map.write_epoch += 1  # the tracker's snapshot cache must refresh
        if self.loop_closer is not None:
            self.loop_closer.insert_keyframe(k, words)
            self.loop_closer.process_pending()

    # ------------------------------------------------------------------
    def _kf_views(self, ks, unbound_only: bool) -> KFView:
        """Stacked [T, ...] views of keyframes `ks`: immutable features
        gathered from the device store, the mask and poses uploaded."""
        m = self.map
        idx = np.asarray(list(ks), np.int64)
        valid = m.kf_feat_valid[idx].copy()
        if unbound_only:
            valid &= m.kf_mp[idx] < 0
        store = self._store()
        store.ensure(idx, m)
        return store.gather_views(idx, valid, m.kf_R[idx], m.kf_t[idx])

    def _kf_view(self, k: int, unbound_only: bool) -> KFView:
        return KFView(*(x[0] for x in self._kf_views([k], unbound_only)))

    # ------------------------------------------------------------------
    def _cull_recent_points(self, k: int):
        """MapPointCulling (stereo: a stereo observation counts 2 toward
        nObs, so the threshold is cull_min_obs)."""
        th_obs = self.cfg.mapping.cull_min_obs
        drop: List[int] = []
        done: List[int] = []
        for m, k0 in self.recent.items():
            if not self.map.mp_valid[m]:
                done.append(m)
                continue
            ratio = self.map.mp_found[m] / max(int(self.map.mp_visible[m]), 1)
            age = k - k0
            if ratio < self.cfg.mapping.cull_found_ratio:
                drop.append(m)
            elif age >= 2 and self.map.mp_n_obs[m] <= th_obs:
                drop.append(m)
            elif age >= 3:
                done.append(m)
        for m in drop:
            self.map.erase_map_point(m)
            self.recent.pop(m, None)
        for m in done:
            self.recent.pop(m, None)

    # ------------------------------------------------------------------
    def _snapshot_triangulation(self, k: int):
        """Host snapshot for CreateNewMapPoints: (neighbours, view1, views2)
        or None. Stereo only: pairs closer than the stereo baseline are
        dropped on the host before any device work."""
        nn = self.cfg.mapping.triangulation_neighbors
        m = self.map
        if not m.kf_valid[k]:
            return None
        neighbors = [int(x) for x in m.covisible_keyframes(k, nn)]
        if not neighbors:
            return None
        baseline_min = self.cfg.bf / self.cfg.fx
        c1 = -m.kf_R[k].T @ m.kf_t[k]
        neighbors = [k2 for k2 in neighbors
                     if float(np.linalg.norm((-m.kf_R[k2].T @ m.kf_t[k2]) - c1)) >= baseline_min]
        if not neighbors:
            return None
        return neighbors, self._kf_view(k, unbound_only=True), \
            self._kf_views(neighbors, unbound_only=True)

    def _mapping_device_pass(self, k: int):
        """CreateNewMapPoints + SearchInNeighbors as bounded device units,
        each one launch group and one device -> host copy. Fuse projects the
        point set as it was before this keyframe's triangulation (both
        snapshots are taken first, as in the reference)."""
        m = self.map
        tri = self._snapshot_triangulation(k)
        fuse = self._snapshot_fuse(k)

        if tri is not None:
            neighbors, view1, views2 = tri
            match2_b, xw_b, ok_b, _ = triangulate_pair(self.cam, view1, views2, self.cfg)
            match2_b, xw_b, ok_b = to_host(match2_b, xw_b, ok_b)
            if m.kf_valid[k]:
                self._merge_new_points(k, neighbors, match2_b, xw_b, ok_b)
        if fuse is not None:
            chunks, sel, pts, back, touched = fuse
            for chunk, views in chunks:
                bf_b, acc_b, _ = fuse_project(self.cam, views, *pts, self.cfg)
                acc_b, bf_b = to_host(acc_b, bf_b)
                for ti, kt in enumerate(chunk):
                    if m.kf_valid[kt]:
                        self._merge_fuse(sel, acc_b[ti], bf_b[ti], kt)
            for bsel, bpts, view in back:
                best_feat, accept, _ = fuse_project(self.cam, view, *bpts, self.cfg)
                accept, best_feat = to_host(accept[0], best_feat[0])
                if m.kf_valid[k]:
                    self._merge_fuse(bsel, accept, best_feat, k)
            if len(touched):
                m.update_point_stats(np.asarray(touched, np.int64))
            if m.kf_valid[k]:
                m.update_connections(k)

    def _merge_new_points(self, k, neighbors, match2_b, xw_b, ok_b):
        created: List[int] = []
        for ti, k2 in enumerate(neighbors):
            if not self.map.kf_valid[k2]:
                continue
            ok = ok_b[ti]
            if not ok.any():
                continue
            match2 = match2_b[ti]
            xw = xw_b[ti]
            for f1 in np.nonzero(ok)[0]:
                f2 = int(match2[f1])
                # either side may have been bound by a previous neighbour pass
                if self.map.kf_mp[k, f1] >= 0 or self.map.kf_mp[k2, f2] >= 0:
                    continue
                mp = self.map.add_map_point(xw[f1], self.map.kf_desc[k, f1], first_kf=k)
                self.map.kf_mp[k, f1] = mp
                self.map.kf_mp[k2, f2] = mp
                self.map._add_observation(mp, k, int(f1))
                self.map._add_observation(mp, k2, f2)
                self.recent[mp] = k
                created.append(mp)
        if created:
            self.map.update_point_stats(np.asarray(created))
            self.map.update_connections(k)

    # ------------------------------------------------------------------
    def _point_tensors(self, sel: np.ndarray):
        """Device tensors of the fuse candidates `sel` (all valid)."""
        m, dev = self.map, self.device
        return (
            tensor(m.mp_pos[sel], dev), tensor(m.mp_normal[sel], dev),
            tensor(m.mp_min_dist[sel], dev), tensor(m.mp_max_dist[sel], dev),
            desc_from_numpy(m.mp_desc[sel], dev),
            torch.ones(len(sel), dtype=torch.bool, device=dev),
        )

    def _snapshot_fuse(self, k: int):
        """Host snapshot for SearchInNeighbors: (forward units [(targets,
        views)], the forward point ids and their tensors, backward units,
        the ids whose stats the merge refreshes) or None."""
        nn = self.cfg.mapping.triangulation_neighbors
        m = self.map
        if not m.kf_valid[k]:
            return None
        targets: List[int] = []
        for k1 in m.covisible_keyframes(k, nn):
            k1 = int(k1)
            if k1 not in targets:
                targets.append(k1)
            for k2 in m.covisible_keyframes(k1, 5):
                k2 = int(k2)
                if k2 != k and k2 not in targets:
                    targets.append(k2)
        if not targets:
            return None

        own_ids = m.kf_mp[k]
        own_ids = own_ids[own_ids >= 0]
        touched: List[int] = list(own_ids)

        # forward: k's points projected into every target, a few per launch
        ids = np.asarray(own_ids, np.int64)
        ids = ids[m.mp_valid[ids]]
        sel = None
        pts = None
        chunks = []
        if len(ids):
            sel = ids[: self.cfg.orb.n_features]  # one keyframe binds <= n_features
            pts = self._point_tensors(sel)
            for s in range(0, len(targets), FUSE_TARGETS_PER_UNIT):
                chunk = targets[s: s + FUSE_TARGETS_PER_UNIT]
                chunks.append((chunk, self._kf_views(chunk, unbound_only=False)))
        # backward: every target point projected into k
        fuse_ids = m.kf_mp[np.asarray(targets, np.int64)]
        fuse_ids = np.unique(fuse_ids[fuse_ids >= 0])
        back = self._snapshot_fuse_into(fuse_ids, k)
        touched.extend(fuse_ids.tolist())
        return chunks, sel, pts, back, touched

    def _snapshot_fuse_into(self, ids: np.ndarray, kt: int):
        """Device arguments for fusing `ids` into keyframe kt:
        [(sel, point tensors, view), ...] in units of FUSE_POINTS_PER_UNIT."""
        ids = ids[self.map.mp_valid[ids]]
        if len(ids) == 0:
            return []
        view = self._kf_views([kt], unbound_only=False)
        return [(ids[s: s + FUSE_POINTS_PER_UNIT],
                 self._point_tensors(ids[s: s + FUSE_POINTS_PER_UNIT]), view)
                for s in range(0, len(ids), FUSE_POINTS_PER_UNIT)]

    def _fuse_points_into(self, ids: np.ndarray, kt: int):
        """Fuse the points `ids` into keyframe kt (loop closing's
        SearchAndFuse): snapshot, one device unit per FUSE_POINTS_PER_UNIT
        points, one device -> host copy, merge."""
        units = self._snapshot_fuse_into(ids, kt)
        if not units:
            return
        outs = []
        for _, pts, view in units:
            best_feat, accept, _ = fuse_project(self.cam, view, *pts, self.cfg)
            outs += [accept[0], best_feat[0]]
        pulled = to_host(*outs)
        if not self.map.kf_valid[kt]:
            return
        for u, (sel, _, _) in enumerate(units):
            self._merge_fuse(sel, pulled[2 * u], pulled[2 * u + 1], kt)

    def _merge_fuse(self, sel, accept, best_feat, kt: int):
        """Apply fuse matches: add an observation or merge duplicate points
        (ORBmatcher::Fuse host half)."""
        for i in np.nonzero(accept)[0]:
            m = int(sel[i])
            if not self.map.mp_valid[m]:
                continue
            f = int(best_feat[i])
            existing = int(self.map.kf_mp[kt, f])
            if existing >= 0:
                if existing == m or not self.map.mp_valid[existing]:
                    continue
                # merge into the better-observed point
                if self.map.mp_n_obs[existing] > self.map.mp_n_obs[m]:
                    self.map.replace_map_point(m, existing)
                else:
                    self.map.replace_map_point(existing, m)
            else:
                # the point may already live at another feature of kt
                n = self.map.mp_obs_n[m]
                if (self.map.mp_obs_kf[m, :n] == kt).any():
                    continue
                self.map.kf_mp[kt, f] = m
                self.map._add_observation(m, kt, f)

    # ------------------------------------------------------------------
    def _local_ba_window(self, k: int):
        """Optimizer::LocalBundleAdjustment's window for keyframe k: k and
        its covisibles free (keyframe 0 stays fixed), the other observers of
        their points fixed. Returns the host problem, padded to power-of-two
        buckets of the cameras, points and observations per point actually
        present (the reference's padding), with its bookkeeping:
        (prob, cams, cam_free, mp, obs_kf, obs_feat, obs_mp), or None."""
        ocfg = self.cfg.optim
        m = self.map
        local = [k] + [int(x) for x in m.covisible_keyframes(k, ocfg.local_ba_max_cams - 1)]
        local_set = set(local)
        mp = m.kf_mp[np.asarray(local, np.int64)]
        mp = np.unique(mp[mp >= 0])
        mp = mp[m.mp_valid[mp]]
        if len(mp) > ocfg.local_ba_max_points:
            order = np.argsort(-m.mp_n_obs[mp], kind="stable")
            mp = mp[order[: ocfg.local_ba_max_points]]
        if len(mp) < 8 or len(local) < 2:
            return None
        obs_kf_all = m.mp_obs_kf[mp]
        fixed = np.unique(obs_kf_all[obs_kf_all >= 0])
        fixed = [int(x) for x in fixed if int(x) not in local_set][: ocfg.local_ba_max_fixed]
        C_max = ocfg.local_ba_max_cams + ocfg.local_ba_max_fixed
        cams = np.asarray((local + fixed)[:C_max], np.int64)
        cam_free = np.array([(kf in local_set) and kf != 0 for kf in cams.tolist()], bool)

        C = min(max(32, 1 << (max(len(cams), 1) - 1).bit_length()), C_max)
        P = min(max(512, 1 << (max(len(mp), 1) - 1).bit_length()), ocfg.local_ba_max_points)
        cam_lut = np.full(m.kf_capacity, -1, np.int64)
        cam_lut[cams] = np.arange(len(cams))
        in_win = (obs_kf_all >= 0) & (cam_lut[np.clip(obs_kf_all, 0, None)] >= 0)
        q_need = int(in_win.sum(axis=1).max(initial=1))
        Q = min(max(4, 1 << (q_need - 1).bit_length()), ocfg.local_ba_max_obs_per_point)
        prob, obs_kf, obs_fe, obs_mp = assemble_ba_problem(
            m, cams, cam_free, mp, C_pad=C, P_pad=P, Q_pad=Q,
            obs_per_point_cap=Q, pq_layout=True,
        )
        return prob, cams, cam_free, mp, obs_kf, obs_fe, obs_mp

    def _local_ba(self, k: int):
        """Local BA of keyframe k's window; writes back the poses and points
        and erases the outlier observations."""
        window = self._local_ba_window(k)
        if window is None:
            return
        prob_h, cams, cam_free, mp, obs_kf, obs_fe, obs_mp = window
        m = self.map
        t0 = time.perf_counter()
        out = self._solve_ba_abortable(upload_problem(prob_h, self.device))
        if out is None:
            return  # aborted by a newly inserted keyframe
        Rn, tn, xwn, inlier = to_host(*out)
        self.ba_solve_times.append(
            (time.perf_counter() - t0, self.cfg.optim.local_ba_iters1 + self.cfg.optim.local_ba_iters2))

        # write back optimized poses and points, skipping anything erased
        nc = len(cams)
        wr = cam_free & m.kf_valid[cams]
        m.kf_R[cams[wr]] = Rn[:nc][wr]
        m.kf_t[cams[wr]] = tn[:nc][wr]
        alive = m.mp_valid[mp]
        m.mp_pos[mp[alive]] = xwn[: len(mp)][alive]

        # erase outlier observations
        for o_i in np.nonzero(prob_h.obs_valid & ~inlier)[0]:
            kf, f, mp_id = int(obs_kf[o_i]), int(obs_fe[o_i]), int(obs_mp[o_i])
            if m.kf_mp[kf, f] == mp_id:
                m.kf_mp[kf, f] = -1
                m._remove_observation(mp_id, kf)

    def _solve_ba_abortable(self, prob):
        """Two LM phases (5 Huber iterations, reclassify, 10 plain ones) with
        an abort check before each; in synchronous mode nothing sets the
        flag between them. Returns (R, t, xw, inlier) or None when aborted."""
        ocfg = self.cfg.optim
        if self.abort_ba:
            return None
        lam = torch.tensor(ocfg.lm_lambda_init, dtype=torch.float32, device=self.device)
        R, t, xw, lam, inlier = lm_chunk_pq(
            self.cam, prob, prob.R, prob.t, prob.xw, lam, prob.obs_valid.to(torch.float32),
            True, ocfg, ocfg.local_ba_iters1)
        if not self.abort_ba:
            R, t, xw, lam, inlier = lm_chunk_pq(
                self.cam, prob, R, t, xw, lam, inlier.to(torch.float32),
                False, ocfg, ocfg.local_ba_iters2)
        return R, t, xw, inlier

    # ------------------------------------------------------------------
    def _cull_keyframes(self, k: int):
        """KeyFrameCulling: drop a covisible keyframe when 90% of its close
        points are seen by 3 other keyframes at the same or a finer scale."""
        m = self.map
        th = self.cfg.resolved_depth_th()
        for kf in m.covisible_keyframes(k):
            kf = int(kf)
            if kf == 0 or kf == k or not m.kf_valid[kf]:
                continue
            mps = m.kf_mp[kf]
            feats = np.nonzero(mps >= 0)[0]
            if len(feats) == 0:
                continue
            ms = mps[feats]
            live = m.mp_valid[ms]
            d = m.kf_depth[kf, feats]
            near = (d > 0) & (d <= th) & live
            if near.sum() == 0:
                continue
            feats_n = feats[near]
            ms_n = ms[near]
            levels = m.kf_octave[kf, feats_n]
            okf = m.mp_obs_kf[ms_n]          # [n, OBS_CAP]
            ofe = m.mp_obs_feat[ms_n]
            vmask = (okf >= 0) & (okf != kf)
            lv = m.kf_octave[np.clip(okf, 0, None), np.clip(ofe, 0, None)]
            cnt = ((lv <= (levels[:, None] + 1)) & vmask).sum(axis=1)
            redundant = (cnt >= self.cfg.mapping.kf_cull_min_obs).sum()
            if redundant > self.cfg.mapping.kf_cull_redundancy * len(ms_n):
                m.erase_keyframe(kf)

    def finish(self):
        self.process_pending()
