"""Local mapping, synchronous stereo path (counterpart of
orb_slam2_2021_tpu/pipeline/local_mapping.py).

Per inserted keyframe (LocalMapping::Run):
  1. observation binding and covisibility (done at insert by MapStore);
  2. recent map-point culling (MapPointCulling);
  3. new points triangulated against the covisible neighbours
     (CreateNewMapPoints) and neighbour fusion both ways (SearchInNeighbors),
     as bounded device units with one device -> host copy each;
  4. local bundle adjustment: reduced-camera LM with PCG (optim/ba_cg.py)
     by default, or with `use_cg_local_ba=False` the dense solve of the
     reduced system (optim/ba.py) at the static window shapes;
  5. keyframe culling (KeyFrameCulling);
  6. with a loop closer attached, the keyframe and its BoW words go to loop
     closing, which runs inline.

With `monocular` set (System does it for monocular input), recent points
need fewer observations to survive, triangulation pairs are gated by their
baseline over the neighbour's median scene depth instead of the stereo
baseline, and local BA pins a second camera when no fixed camera observes
the window, since a monocular map has a free scale.

Runs inline (`process_pending`, synchronous mode) or on a worker thread
(`run_worker`, started by System in async mode: LocalMapping::Run), which
also keeps the occupancy grid. The map lock is held only for the host
snapshot and merge sections of each stage, never across device work, so
the tracking lane interleaves with the worker; a keyframe inserted while a
local BA solves aborts the solve between its two LM phases (mbAbortBA);
the dense local BA runs as one unit, as the reference's does.
The worker reads the live frame a keyframe was promoted from on its own
stream, after an event the lane recorded (pipeline/streams.py).

Spans (io/trace.py), keyed by the keyframe's id: `mapping.queued` (from
`insert_keyframe` to the pop), `mapping.kf` around the pipeline, and inside
it `mapping.cull_points`, `mapping.device_pass` (its readbacks
`mapping.readback`), `local_ba` (`local_ba.window`,
`local_ba.upload`, `local_ba.phase` with the counter `local_ba.iters`,
`local_ba.readback`, `local_ba.writeback`), `mapping.cull_kfs`,
`mapping.loop` and `mapping.grid`.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from ..convert import camera_from_config, desc_from_numpy, tensor, to_host
from ..io import trace
from ..optim.assemble import assemble_ba_problem, upload_problem
from ..optim.ba import make_local_ba
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
        self.cfg = cfg
        self.map = map_store
        self.device = torch.device(device)
        self.cam = camera_from_config(cfg)
        self.queue: Deque[tuple] = deque()  # (keyframe, BoW words or None)
        self.recent: Dict[int, int] = {}  # mp id -> created-at kf id
        self.abort_ba = False  # mbAbortBA: set by a newly inserted keyframe
        # (seconds, LM iterations run) of each local BA that returned a result
        self.ba_solve_times: List[tuple] = []
        self._queued_at: Dict[int, int] = {}  # keyframe -> insert stamp, while tracing
        self._devkf: Optional[DeviceKFStore] = None
        self.loop_closer = None  # set by System when loop closing is on
        self.monocular = False   # set by System for monocular input
        # async mode (System sets these): the worker thread's state, its
        # stream, the grid it keeps, and the exception it died of
        self.async_mode = False
        self.streams = None
        self.grid_mapper = None
        self.error: Optional[BaseException] = None
        self._cv = threading.Condition()
        self._finish_requested = False
        self._busy = False

    def _store(self) -> DeviceKFStore:
        if self._devkf is None:
            self._devkf = DeviceKFStore(self.map.kf_capacity, self.cfg.orb.n_features, self.device)
        self._devkf.maybe_grow(self.map.kf_capacity)
        return self._devkf

    def insert_keyframe(self, k: int, words, frame=None):
        """Queue keyframe k with its BoW words (None without place
        recognition) and the live frame it was promoted from, whose device
        features the store adopts when k is processed (None: uploaded from
        the host map store). Aborts a local BA in flight. The caller holds
        the map lock."""
        ready = None
        if frame is not None and self.streams is not None:
            ready = self.streams.handoff(
                (frame.kp.desc, frame.kp.xy, frame.u_right, frame.depth, frame.kp.octave), "mapping")
        t_insert = trace.stamp()
        with self._cv:
            if t_insert is not None:
                self._queued_at[k] = t_insert
            self.queue.append((k, words, frame, ready))
            self.abort_ba = True
            self._cv.notify_all()
        mps = self.map.kf_mp[k]
        for m in mps[mps >= 0]:
            if self.map.mp_first_kf[m] == self.map.kf_frame_id[k] or self.map.mp_first_kf[m] == k:
                self.recent[int(m)] = k

    def _pop(self):
        with self._cv:
            if not self.queue:
                return None
            item = self.queue.popleft()
            self.abort_ba = bool(self.queue)
            t_insert = self._queued_at.pop(item[0], None)
        if t_insert is not None:
            trace.record("mapping.queued", t_insert, trace.stamp(), key=item[0])
        return item

    def process_pending(self):
        while True:
            item = self._pop()
            if item is None:
                return
            self._process(*item)

    def run_worker(self):
        """The mapping thread (LocalMapping::Run): drain the queue on the
        mapping stream until request_finish and an empty queue. Loop closing
        runs inline on this thread (its global BA on a thread of its own). An
        exception ends the thread and is kept in `error` for System to
        raise on the lane."""
        with self.streams.enter("mapping"):
            try:
                while True:
                    with self._cv:
                        while not self.queue and not self._finish_requested:
                            self._cv.wait(timeout=0.05)
                        if not self.queue:
                            return
                        self._busy = True
                    try:
                        self.process_pending()
                    finally:
                        with self._cv:
                            self._busy = False
                            self._cv.notify_all()
            except BaseException as e:  # re-raised on the lane by System
                self.error = e

    def idle(self) -> bool:
        """No keyframe queued or in process (AcceptKeyFrames)."""
        with self._cv:
            return not self.queue and not self._busy

    def wait_idle(self, thread):
        """Block until the worker has drained the queue (or died)."""
        with self._cv:
            while (self.queue or self._busy) and thread.is_alive():
                self._cv.wait(timeout=0.05)

    def request_finish(self):
        """RequestFinish: the worker ends once its queue is empty."""
        with self._cv:
            self._finish_requested = True
            self._cv.notify_all()

    def request_reset(self):
        """RequestReset: drop the queued keyframes and, in async mode, wait
        until the worker is between keyframes and its stream has finished,
        so the caller can clear the map. Call it without the map lock (the
        worker may need it to finish its keyframe)."""
        with self._cv:
            self.queue.clear()
            self._queued_at.clear()
            self.abort_ba = True
            while self._busy:
                self._cv.wait(timeout=0.05)
        if self.streams is not None:
            self.streams.synchronize("mapping")
        self.recent.clear()
        self.abort_ba = False
        if self._devkf is not None:
            self._devkf.reset()

    def _process(self, k: int, words=None, frame=None, ready=None):
        """The per-keyframe pipeline. The map lock is held for the host
        snapshot and merge sections inside each stage, never across device
        work."""
        with trace.span("mapping.kf", key=k):
            if frame is not None:
                if ready is not None:
                    self.streams.wait(ready)
                self._store().set_from_frame(k, frame)
            lock = self.map.lock
            with lock:
                if not self.map.kf_valid[k]:
                    return
                with trace.span("mapping.cull_points"):
                    self._cull_recent_points(k)
            with trace.span("mapping.device_pass"):
                self._mapping_device_pass(k)
            if self.map.n_kf > 2 and not self.queue:
                with trace.span("local_ba"):
                    self._local_ba(k)
            with lock, trace.span("mapping.cull_kfs"):
                self._cull_keyframes(k)
                self.map.write_epoch += 1  # the tracker's snapshot cache must refresh
            if self.loop_closer is not None:
                with trace.span("mapping.loop"):
                    self.loop_closer.insert_keyframe(k, words)
                    self.loop_closer.process_pending()
            if self.async_mode and self.grid_mapper is not None:
                # the worker keeps the grid in async mode (the GridMapping thread)
                with lock, trace.span("mapping.grid"):
                    loop_closed = bool(self.loop_closer and self.loop_closer.loop_closed_flag)
                    if loop_closed:
                        self.loop_closer.loop_closed_flag = False
                    self.grid_mapper.process_new(loop_closed)

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
        """MapPointCulling: a point created two keyframes ago needs more
        than cull_min_obs observations (stereo, a stereo observation counts
        2), or more than 2 in a monocular map."""
        th_obs = 2 if self.monocular else self.cfg.mapping.cull_min_obs
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
        or None. Pairs are gated on the host before any device work: closer
        than the stereo baseline, or monocular, with a baseline under 1% of
        the neighbour's median scene depth."""
        nn = self.cfg.mapping.triangulation_neighbors
        m = self.map
        if not m.kf_valid[k]:
            return None
        neighbors = [int(x) for x in m.covisible_keyframes(k, nn)]
        if not neighbors:
            return None
        c1 = -m.kf_R[k].T @ m.kf_t[k]

        def baseline(k2):
            return float(np.linalg.norm((-m.kf_R[k2].T @ m.kf_t[k2]) - c1))

        def far_enough(k2):
            if self.monocular:
                med = self._median_scene_depth(k2)
                return med > 0 and baseline(k2) / med >= 0.01
            return baseline(k2) >= self.cfg.bf / self.cfg.fx

        neighbors = [k2 for k2 in neighbors if far_enough(k2)]
        if not neighbors:
            return None
        return neighbors, self._kf_view(k, unbound_only=True), \
            self._kf_views(neighbors, unbound_only=True)

    def _median_scene_depth(self, k: int) -> float:
        """KeyFrame::ComputeSceneMedianDepth: the median camera-frame depth
        of keyframe k's live points, or -1 without any."""
        mp = self.map.kf_mp[k]
        ids = mp[mp >= 0]
        ids = ids[self.map.mp_valid[ids]]
        if len(ids) == 0:
            return -1.0
        z = self.map.mp_pos[ids] @ self.map.kf_R[k][2] + self.map.kf_t[k][2]
        return float(np.median(z))

    def _mapping_device_pass(self, k: int):
        """CreateNewMapPoints + SearchInNeighbors as bounded device units,
        each one launch group and one device -> host copy, merged under the
        map lock (bindings that changed in flight are re-checked there). Fuse
        projects the point set as it was before this keyframe's
        triangulation (both snapshots are taken first, as in the reference)."""
        m = self.map
        with m.lock:
            tri = self._snapshot_triangulation(k)
            fuse = self._snapshot_fuse(k)

        if tri is not None:
            neighbors, view1, views2 = tri
            match2_b, xw_b, ok_b, _ = triangulate_pair(self.cam, view1, views2, self.cfg)
            with trace.span("mapping.readback"):
                match2_b, xw_b, ok_b = to_host(match2_b, xw_b, ok_b)
            with m.lock:
                if m.kf_valid[k]:
                    self._merge_new_points(k, neighbors, match2_b, xw_b, ok_b)
        if fuse is not None:
            chunks, sel, pts, back, touched = fuse
            for chunk, views in chunks:
                bf_b, acc_b, _ = fuse_project(self.cam, views, *pts, self.cfg)
                with trace.span("mapping.readback"):
                    acc_b, bf_b = to_host(acc_b, bf_b)
                with m.lock:
                    for ti, kt in enumerate(chunk):
                        if m.kf_valid[kt]:
                            self._merge_fuse(sel, acc_b[ti], bf_b[ti], kt)
            for bsel, bpts, view in back:
                best_feat, accept, _ = fuse_project(self.cam, view, *bpts, self.cfg)
                with trace.span("mapping.readback"):
                    accept, best_feat = to_host(accept[0], best_feat[0])
                with m.lock:
                    if m.kf_valid[k]:
                        self._merge_fuse(bsel, accept, best_feat, k)
            with m.lock:
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
        with self.map.lock:
            units = self._snapshot_fuse_into(ids, kt)
        if not units:
            return
        outs = []
        for _, pts, view in units:
            best_feat, accept, _ = fuse_project(self.cam, view, *pts, self.cfg)
            outs += [accept[0], best_feat[0]]
        pulled = to_host(*outs)
        with self.map.lock:
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
        their points fixed. Returns the host problem with its bookkeeping:
        (prob, cams, cam_free, mp, obs_kf, obs_feat, obs_mp), or None. The
        CG solver's problem is in the PQ layout, padded to power-of-two
        buckets of the cameras, points and observations per point actually
        present; the dense solver's is flat, at the static capacities (the
        reference's padding either way)."""
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
        if self.monocular and len(fixed) == 0:
            # with one fixed camera the problem keeps an exact scale null
            # space (scaling about it changes no residual) and the solve
            # drifts along it: pin the oldest free camera too
            frees = np.nonzero(cam_free)[0]
            if len(frees):
                cam_free[frees[np.argmin(cams[frees])]] = False

        if not ocfg.use_cg_local_ba:
            Q = ocfg.local_ba_max_obs_per_point
            prob, obs_kf, obs_fe, obs_mp = assemble_ba_problem(
                m, cams, cam_free, mp, C_pad=C_max, P_pad=ocfg.local_ba_max_points,
                O_pad=ocfg.local_ba_max_obs, Q_pad=Q, obs_per_point_cap=Q)
            return prob, cams, cam_free, mp, obs_kf, obs_fe, obs_mp
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
        m = self.map
        ocfg = self.cfg.optim
        with m.lock, trace.span("local_ba.window"):
            window = self._local_ba_window(k)
        if window is None:
            return
        prob_h, cams, cam_free, mp, obs_kf, obs_fe, obs_mp = window
        t0 = time.perf_counter()
        with trace.span("local_ba.upload"):
            prob = upload_problem(prob_h, self.device)
        if ocfg.use_cg_local_ba:
            phases: List[int] = []
            out = self._solve_ba_abortable(prob, phases)
            if out is None:
                return  # aborted by a newly inserted keyframe
            iters = sum(phases)
        else:
            with trace.span("local_ba.phase"):
                out = make_local_ba(ocfg)(self.cam, prob)
                iters = ocfg.local_ba_iters1 + ocfg.local_ba_iters2
                trace.count("local_ba.iters", iters)
        with trace.span("local_ba.readback"):
            Rn, tn, xwn, inlier = to_host(*out)
        self.ba_solve_times.append((time.perf_counter() - t0, iters))
        with m.lock, trace.span("local_ba.writeback"):
            self._ba_writeback(cams, cam_free, mp, prob_h.obs_valid & ~inlier, obs_kf, obs_fe, obs_mp,
                               Rn, tn, xwn)

    def _ba_writeback(self, cams, cam_free, mp, outlier, obs_kf, obs_fe, obs_mp, Rn, tn, xwn):
        """Write back the optimized poses and points, skipping anything
        erased while the solve was in flight, and erase the outlier
        observations. The caller holds the map lock."""
        m = self.map
        nc = len(cams)
        wr = cam_free & m.kf_valid[cams]
        m.kf_R[cams[wr]] = Rn[:nc][wr]
        m.kf_t[cams[wr]] = tn[:nc][wr]
        alive = m.mp_valid[mp]
        m.mp_pos[mp[alive]] = xwn[: len(mp)][alive]

        # erase outlier observations
        for o_i in np.nonzero(outlier)[0]:
            kf, f, mp_id = int(obs_kf[o_i]), int(obs_fe[o_i]), int(obs_mp[o_i])
            if m.kf_mp[kf, f] == mp_id:
                m.kf_mp[kf, f] = -1
                m._remove_observation(mp_id, kf)

    def _solve_ba_abortable(self, prob, phases: Optional[List[int]] = None):
        """Two LM phases (5 Huber iterations, reclassify, 10 plain ones) with
        an abort check before each (the g2o force-stop polled through
        mbAbortBA); in synchronous mode nothing sets the flag between them.
        Returns (R, t, xw, inlier), the first phase's when the second was
        aborted, or None when aborted before the first; appends each phase's
        LM iterations to `phases`."""
        ocfg = self.cfg.optim
        if self.abort_ba:
            return None
        lam = torch.tensor(ocfg.lm_lambda_init, dtype=torch.float32, device=self.device)
        with trace.span("local_ba.phase"):
            R, t, xw, lam, inlier = lm_chunk_pq(
                self.cam, prob, prob.R, prob.t, prob.xw, lam, prob.obs_valid.to(torch.float32),
                True, ocfg, ocfg.local_ba_iters1)
            trace.count("local_ba.iters", ocfg.local_ba_iters1)
        if phases is not None:
            phases.append(ocfg.local_ba_iters1)
        if not self.abort_ba:
            with trace.span("local_ba.phase"):
                R, t, xw, lam, inlier = lm_chunk_pq(
                    self.cam, prob, R, t, xw, lam, inlier.to(torch.float32),
                    False, ocfg, ocfg.local_ba_iters2)
                trace.count("local_ba.iters", ocfg.local_ba_iters2)
            if phases is not None:
                phases.append(ocfg.local_ba_iters2)
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

    def finish(self, worker=None):
        """Drain the queue: inline, or with a live worker thread, by waiting
        for it."""
        if worker is not None and worker.is_alive():
            self.wait_idle(worker)
        else:
            self.process_pending()
