"""Loop closing, synchronous (counterpart of
orb_slam2_2021_tpu/pipeline/loop_closing.py).

Per keyframe handed over by local mapping (LoopClosing::Run):
- DetectLoop: BoW candidates from the keyframe database gated by the
  minimum covisible score, then covisibility consistency across 3
  consecutive detections;
- ComputeSim3: per candidate, descriptor matching (K1) -> Sim3 RANSAC ->
  relative Sim3 refine (>= 20 inliers) -> the loop region's map points
  projected under the corrected pose (K1; >= 40 matches in all);
- CorrectLoop: the corrected Sim3 propagated through the covisibility group,
  its points moved, the loop points fused in (one keyframe after another),
  the essential graph optimized, then global BA over every keyframe and
  point.

Each device unit (the matcher, RANSAC + refine, the projection search, the
essential graph, the global BA solve) ends in one device -> host copy; the
map is updated on the host as in the reference, dtypes included.

RANSAC samples come from `self.sampler(valid, m, n_hyps)`: by default a
`torch.Generator` on the host seeded with cfg.orb.n_features, as the
reference seeds its key. Tests may inject the reference's own samples.

Not ported (ROADMAP.md): the global-BA thread of async mode and its pacing
(step 11), the device-mesh and cross-process global BA (step 12). Without
the thread a global BA is never stale or aborted, so the reference's
staleness index and stop flag are not carried.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

import numpy as np
import torch

from ..convert import camera_from_config, desc_from_numpy, tensor, to_host
from ..frontend.matchers import match_bruteforce_desc
from ..optim.assemble import assemble_ba_problem, global_problem_shapes, upload_problem
from ..optim.ba_cg import flat_index, gba_iteration, lm_chunk_pq
from ..optim.sim3_opt import PoseGraph, essential_graph_solve, optimize_sim3_relative
from ..solvers.horn_sim3 import sample_indices, sim3_ransac
from .mapping_steps import KFView, fuse_project

N_HYPS = 128          # Sim3 RANSAC hypotheses per candidate
SCW_POINTS_PER_UNIT = 4096


def _sim3_mat(s, R, t):
    """(s, R, t) -> 4x4 with the scale folded in: [sR | t]."""
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = s * R
    T[:3, 3] = t
    return T


def _sim3_inv(s, R, t):
    si = 1.0 / s
    Ri = R.T
    return si, Ri, -si * (Ri @ t)


def _sim3_mul(a, b):
    sa, Ra, ta = a
    sb, Rb, tb = b
    return sa * sb, Ra @ Rb, sa * (Ra @ tb) + ta


def _pose_mat(R, t):
    T = np.eye(4, dtype=np.float64)
    T[:3, :3] = R
    T[:3, 3] = t
    return T


class LoopClosing:
    def __init__(self, cfg, map_store, kfdb, device, fix_scale: bool = True):
        self.cfg = cfg
        self.map = map_store
        self.kfdb = kfdb
        self.device = torch.device(device)
        self.fix_scale = fix_scale
        self.cam = camera_from_config(cfg)
        self.queue: List[tuple] = []
        self.last_loop_kf = -int(1e9)
        self.consistent_groups: List[Tuple[Set[int], int]] = []  # (group, count)
        self.loop_closed_flag = False  # consumed by the grid (System._post_track)
        self.n_loops = 0
        self.local_mapper = None
        self._gen = torch.Generator().manual_seed(cfg.orb.n_features)
        self.sampler = lambda valid, m, n_hyps: sample_indices(valid, m, n_hyps, self._gen)
        self.gba_iter_times: List[float] = []
        # host-clock seconds of the last closed loop's stages
        self.loop_times: Dict[str, float] = {}

    @property
    def loop_edges(self) -> Dict[int, Set[int]]:
        """Essential-graph loop constraints; they live on the MapStore so
        map files keep them."""
        return self.map.loop_edges

    # ------------------------------------------------------------------
    def request_reset(self):
        """Drop queued keyframes and forget the loop bookkeeping."""
        self.queue.clear()
        self.last_loop_kf = -int(1e9)
        self.consistent_groups = []
        self.map.loop_edges.clear()
        self.loop_closed_flag = False

    def insert_keyframe(self, k: int, words=None):
        self.queue.append((k, words))

    def process_pending(self):
        while self.queue:
            self._process(*self.queue.pop(0))

    def _process(self, k: int, words):
        if words is not None:
            self.kfdb.add_bow(k, words)
        if not self.map.kf_valid[k]:
            return
        # protect the keyframe from culling while its detection runs
        self.map.kf_not_erase[k] = True
        candidates = self._detect_loop(k)
        result = None
        if candidates:
            for c in candidates:
                self.map.kf_not_erase[c] = True
            t0 = time.perf_counter()
            result = self._compute_sim3(k, candidates)
            t_sim3 = time.perf_counter() - t0
        if result is not None:
            loop_kf, scw, matched_feat_mp = result
            self._correct_loop(k, loop_kf, scw, matched_feat_mp)
            self.loop_times["compute_sim3"] = t_sim3
        # release erase protection; the matched pair stays protected
        for c in set(candidates) | {k}:
            if result is not None and c in (k, result[0]):
                continue
            self.map.set_erase(int(c))
        # the keyframe becomes a retrieval candidate only now
        if k in self.kfdb.bow:
            self.kfdb.add_to_index(k)

    # ------------------------------------------------------------------
    def _detect_loop(self, k: int) -> List[int]:
        """DetectLoop: the candidates consistent over enough detections."""
        if k < self.last_loop_kf + self.cfg.place.loop_min_kf_gap:
            self.consistent_groups = []
            return []
        if k not in self.kfdb.bow:
            return []
        connected = set(int(x) for x in self.map.covisible_keyframes(k))
        min_score = 1.0
        for nb in connected:
            if nb in self.kfdb.bow:
                min_score = min(min_score, self.kfdb.score(k, nb))
        cands = self.kfdb.detect_loop_candidates(
            k, min_score, connected, lambda x: self.map.covisible_keyframes(x, 10))
        if not cands:
            self.consistent_groups = []
            return []
        enough: List[int] = []
        new_groups: List[Tuple[Set[int], int]] = []
        th = self.cfg.place.covis_consistency_th
        for c in cands:
            group = set(int(x) for x in self.map.covisible_keyframes(c)) | {c}
            best_count = 0
            matched_any = False
            for prev_group, count in self.consistent_groups:
                if group & prev_group:
                    matched_any = True
                    best_count = max(best_count, count + 1)
            new_groups.append((group, best_count))
            if best_count >= th:
                enough.append(c)
            if not matched_any:
                new_groups[-1] = (group, 0)
        self.consistent_groups = new_groups
        return enough

    # ------------------------------------------------------------------
    def _kf_cam_points(self, k: int):
        """Map points of keyframe k in its camera frame + their features."""
        mp = self.map.kf_mp[k]
        feats = np.nonzero((mp >= 0) & self.map.mp_valid[np.clip(mp, 0, None)])[0]
        ids = mp[feats]
        pc = self.map.mp_pos[ids] @ self.map.kf_R[k].T + self.map.kf_t[k]
        return feats, ids, pc, self.map.kf_xy[k, feats], self.map.kf_octave[k, feats]

    def _compute_sim3(self, k: int, candidates: List[int]):
        """ComputeSim3. Returns (loop_kf, Scw (s, R, t), feature -> loop map
        point [N]) or None."""
        sigma2 = self.map.scale_factors ** 2
        dev = self.device
        c = self.cfg
        for kc in candidates:
            kc = int(kc)
            f1, _, pc1, uv1, oct1 = self._kf_cam_points(k)
            f2, _, pc2, uv2, oct2 = self._kf_cam_points(kc)
            if len(f1) < 20 or len(f2) < 20:
                continue
            best_b, accept, _ = match_bruteforce_desc(
                desc_from_numpy(self.map.kf_desc[k, f1], dev),
                torch.ones(len(f1), dtype=torch.bool, device=dev),
                tensor(self.map.kf_angle[k, f1], dev),
                desc_from_numpy(self.map.kf_desc[kc, f2], dev),
                torch.ones(len(f2), dtype=torch.bool, device=dev),
                tensor(self.map.kf_angle[kc, f2], dev),
            )
            accept, best_b = to_host(accept, best_b)
            if accept.sum() < 20:
                continue
            m1 = np.nonzero(accept)[0]
            m2 = best_b[m1]
            n = len(m1)
            idx = self.sampler(np.ones(n, bool), 3, N_HYPS).to(dev)
            x1, x2 = tensor(pc1[m1], dev), tensor(pc2[m2], dev)
            u1, u2 = tensor(uv1[m1], dev), tensor(uv2[m2], dev)
            s2_1, s2_2 = sigma2[oct1[m1]], sigma2[oct2[m2]]
            valid = torch.ones(n, dtype=torch.bool, device=dev)
            s12, R12, t12, _, n_ransac = sim3_ransac(
                idx, x1, x2, u1, u2, tensor(s2_1, dev, torch.float32),
                tensor(s2_2, dev, torch.float32), valid, c.fx, c.fy, c.cx, c.cy, self.fix_scale)
            # the refine runs unconditionally so the unit needs one copy back
            s12, R12, t12, _, n_in = optimize_sim3_relative(
                s12, R12, t12, x1, x2, u1, u2, tensor(1.0 / s2_1, dev, torch.float32),
                tensor(1.0 / s2_2, dev, torch.float32), valid,
                c.fx, c.fy, c.cx, c.cy, self.fix_scale)
            n_ransac, s12, R12, t12, n_in = to_host(n_ransac, s12, R12, t12, n_in)
            if int(n_ransac) < 20 or int(n_in) < c.place.sim3_min_inliers:
                continue
            # corrected current pose: Scw = S12 * S2w
            S2w = (1.0, self.map.kf_R[kc], self.map.kf_t[kc])
            scw = _sim3_mul((float(s12), R12, t12), S2w)
            loop_kfs = [kc] + [int(x) for x in self.map.covisible_keyframes(kc)]
            loop_mps = self.map.kf_mp[np.asarray(loop_kfs, np.int64)]
            loop_mps = np.unique(loop_mps[loop_mps >= 0])
            loop_mps = loop_mps[self.map.mp_valid[loop_mps]]
            matched = self._project_match_scw(k, scw, loop_mps, radius_th=10.0)
            if int((matched >= 0).sum()) >= c.place.loop_min_matches:
                return kc, scw, matched
        return None

    def _project_match_scw(self, k: int, scw, loop_mps: np.ndarray, radius_th: float):
        """Project the loop points into keyframe k under Scw (the scale folded
        into the rotation); returns feature -> loop map point [N] (-1)."""
        s, R, t = scw
        m, dev = self.map, self.device
        view = KFView(
            xy=tensor(m.kf_xy[k][None], dev), ur=tensor(m.kf_ur[k][None], dev),
            depth=tensor(m.kf_depth[k][None], dev), octave=tensor(m.kf_octave[k][None], dev),
            desc=desc_from_numpy(m.kf_desc[k][None], dev), valid=tensor(m.kf_feat_valid[k][None], dev),
            R=tensor((s * R).astype(np.float32)[None], dev), t=tensor(t.astype(np.float32)[None], dev),
        )
        out = np.full(self.cfg.orb.n_features, -1, np.int64)
        units = [loop_mps[s0: s0 + SCW_POINTS_PER_UNIT]
                 for s0 in range(0, len(loop_mps), SCW_POINTS_PER_UNIT)]
        if not units:
            return out
        res = []
        for sel in units:
            best_feat, accept, _ = fuse_project(
                self.cam, view, tensor(m.mp_pos[sel], dev), tensor(m.mp_normal[sel], dev),
                tensor(m.mp_min_dist[sel], dev), tensor(m.mp_max_dist[sel], dev),
                desc_from_numpy(m.mp_desc[sel], dev),
                torch.ones(len(sel), dtype=torch.bool, device=dev), self.cfg, radius_th=radius_th)
            res += [accept[0], best_feat[0]]
        pulled = to_host(*res)
        for u, sel in enumerate(units):
            accept, best_feat = pulled[2 * u], pulled[2 * u + 1]
            for i in np.nonzero(accept)[0]:
                out[best_feat[i]] = sel[i]
        return out

    # ------------------------------------------------------------------
    def _correct_loop(self, k: int, loop_kf: int, scw, matched_feat_mp: np.ndarray):
        """CorrectLoop."""
        t0 = time.perf_counter()
        if self.local_mapper is not None:
            self.local_mapper.process_pending()

        # corrected Sim3 of the covisibility group
        group = [k] + [int(x) for x in self.map.covisible_keyframes(k)]
        T_kw_old = (1.0, self.map.kf_R[k].copy(), self.map.kf_t[k].copy())
        corrected: Dict[int, Tuple[float, np.ndarray, np.ndarray]] = {}
        old_poses: Dict[int, Tuple[float, np.ndarray, np.ndarray]] = {}
        for ki in group:
            S_iw_old = (1.0, self.map.kf_R[ki].copy(), self.map.kf_t[ki].copy())
            old_poses[ki] = S_iw_old
            if ki == k:
                corrected[ki] = scw
            else:
                corrected[ki] = _sim3_mul(_sim3_mul(S_iw_old, _sim3_inv(*T_kw_old)), scw)

        # move the group's points and set the corrected poses; remember which
        # group keyframe moved each point (the essential graph's write-back
        # un-projects those through that keyframe's corrected pose)
        moved_by: Dict[int, int] = {}
        for ki in group:
            sc, Rc, tc = corrected[ki]
            so, Ro, to = old_poses[ki]
            mp = self.map.kf_mp[ki]
            ids = mp[mp >= 0]
            ids = ids[self.map.mp_valid[ids]]
            fresh = [m for m in ids if m not in moved_by]
            if fresh:
                fresh = np.asarray(fresh)
                pc = so * self.map.mp_pos[fresh] @ Ro.T + to
                sci, Rci, tci = _sim3_inv(sc, Rc, tc)
                self.map.mp_pos[fresh] = (sci * pc @ Rci.T + tci).astype(np.float32)
                for m in fresh:
                    moved_by[int(m)] = ki
            # the scale folds into the translation: Tiw = [R, t / s]
            self.map.kf_R[ki] = Rc.astype(np.float32)
            self.map.kf_t[ki] = (tc / sc).astype(np.float32)

        # loop fusion: the current keyframe's features take the loop points
        for f in np.nonzero(matched_feat_mp >= 0)[0]:
            m_loop = int(matched_feat_mp[f])
            if not self.map.mp_valid[m_loop]:
                continue
            cur = int(self.map.kf_mp[k, f])
            if cur >= 0 and self.map.mp_valid[cur]:
                self.map.replace_map_point(cur, m_loop)
            else:
                n = self.map.mp_obs_n[m_loop]
                if (self.map.mp_obs_kf[m_loop, :n] == k).any():
                    continue  # already bound at another feature of k
                self.map.kf_mp[k, f] = m_loop
                self.map._add_observation(m_loop, k, int(f))

        # SearchAndFuse: the loop points into each corrected group keyframe,
        # in order, each after the previous merge
        loop_kfs = [loop_kf] + [int(x) for x in self.map.covisible_keyframes(loop_kf)]
        loop_mps = self.map.kf_mp[np.asarray(loop_kfs, np.int64)]
        loop_mps = np.unique(loop_mps[loop_mps >= 0])
        loop_mps = loop_mps[self.map.mp_valid[loop_mps]]
        if self.local_mapper is not None:
            for ki in group:
                self.local_mapper._fuse_points_into(loop_mps, ki)
        for ki in group:
            self.map.update_connections(ki)

        self.loop_edges.setdefault(k, set()).add(loop_kf)
        self.loop_edges.setdefault(loop_kf, set()).add(k)
        t1 = time.perf_counter()
        self._optimize_essential_graph(k, loop_kf, corrected, old_poses, moved_by)
        t2 = time.perf_counter()
        self._run_global_ba()
        t3 = time.perf_counter()
        self.loop_times = {"correct": t1 - t0, "essential_graph": t2 - t1, "global_ba": t3 - t2}

        self.last_loop_kf = k
        self.loop_closed_flag = True
        self.n_loops += 1
        self.map.big_change_idx += 1
        self.map.write_epoch += 1

    # ------------------------------------------------------------------
    def _optimize_essential_graph(self, k, loop_kf, corrected, old_poses,
                                  moved_by: Optional[Dict[int, int]] = None):
        """Essential graph (spanning tree + covisibility >= 100 + loop edges)
        solved by the PCG pose-graph LM, then the write-back: points moved by
        the loop correction through their correcting keyframe's corrected
        pose, all others through their reference keyframe's."""
        moved_by = moved_by or {}
        kfs = np.nonzero(self.map.kf_valid)[0]
        if len(kfs) < 3:
            return
        K = len(kfs)
        idx_of = {int(kf): i for i, kf in enumerate(kfs)}

        s_arr = np.ones(K, np.float32)
        R_arr = np.zeros((K, 3, 3), np.float32)
        t_arr = np.zeros((K, 3), np.float32)
        for kf, i in idx_of.items():
            if kf in corrected:
                s_arr[i], R_arr[i], t_arr[i] = corrected[kf]
            else:
                R_arr[i] = self.map.kf_R[kf]
                t_arr[i] = self.map.kf_t[kf]

        def old_pose_of(kf):
            if kf in old_poses:
                return old_poses[kf]
            return (1.0, self.map.kf_R[kf], self.map.kf_t[kf])

        edges = set()
        ei, ej, ms, mR, mt = [], [], [], [], []

        def push(a, b, Sa, Sb):
            s_, R_, t_ = _sim3_mul(Sa, _sim3_inv(*Sb))
            ei.append(idx_of[a])
            ej.append(idx_of[b])
            ms.append(s_)
            mR.append(R_)
            mt.append(t_)

        def add_edge(a, b):  # measured from the pre-correction poses
            key = (min(a, b), max(a, b))
            if key in edges or a == b:
                return
            edges.add(key)
            push(a, b, old_pose_of(a), old_pose_of(b))

        def add_loop_edge(a, b):  # the loop edge carries the corrected poses
            key = (min(a, b), max(a, b))
            if key in edges:
                return
            edges.add(key)
            push(a, b, corrected.get(a, old_pose_of(a)), corrected.get(b, old_pose_of(b)))

        add_loop_edge(k, loop_kf)
        for kf in kfs:
            kf = int(kf)
            p = int(self.map.parent[kf])
            if p >= 0 and p in idx_of:
                add_edge(kf, p)
            for le in self.loop_edges.get(kf, ()):
                if le in idx_of:
                    add_loop_edge(kf, le)
            w = self.map.covis[kf]
            for nb in np.nonzero(w >= self.cfg.place.essential_min_weight)[0]:
                if int(nb) in idx_of:
                    add_edge(kf, int(nb))
        if len(ei) < 2:
            return

        fixed = np.zeros(K, bool)
        fixed[idx_of[loop_kf]] = True
        # padded to power-of-two counts with identity vertices marked fixed
        # and zero-weight edges, as the reference pads: the CG's dot products
        # run over the padded stacks
        K_pad = max(32, int(2 ** np.ceil(np.log2(K))))
        E = len(ei)
        E_pad = max(256, int(2 ** np.ceil(np.log2(E))))
        s_p = np.ones(K_pad, np.float32)
        s_p[:K] = s_arr
        R_p = np.tile(np.eye(3, dtype=np.float32), (K_pad, 1, 1))
        R_p[:K] = R_arr
        t_p = np.zeros((K_pad, 3), np.float32)
        t_p[:K] = t_arr
        fx_p = np.ones(K_pad, bool)
        fx_p[:K] = fixed
        ei_p = np.zeros(E_pad, np.int64)
        ei_p[:E] = ei
        ej_p = np.zeros(E_pad, np.int64)
        ej_p[:E] = ej
        ms_p = np.ones(E_pad, np.float32)
        ms_p[:E] = ms
        mR_p = np.tile(np.eye(3, dtype=np.float32), (E_pad, 1, 1))
        mR_p[:E] = np.stack(mR)
        mt_p = np.zeros((E_pad, 3), np.float32)
        mt_p[:E] = np.stack(mt)
        w_p = np.zeros(E_pad, np.float32)
        w_p[:E] = 1.0

        dev = self.device
        g = PoseGraph(
            s=tensor(s_p, dev), R=tensor(R_p, dev), t=tensor(t_p, dev),
            edge_i=tensor(ei_p, dev), edge_j=tensor(ej_p, dev),
            m_s=tensor(ms_p, dev), m_R=tensor(mR_p, dev), m_t=tensor(mt_p, dev),
            weight=tensor(w_p, dev), fixed=tensor(fx_p, dev),
        )
        s_new, R_new, t_new = to_host(*essential_graph_solve(g, self.fix_scale))

        mp_ids = np.nonzero(self.map.mp_valid)[0]
        if len(mp_ids):
            lut = np.full(self.map.kf_R.shape[0], -1, np.int64)
            lut[kfs] = np.arange(K)
            ref_kf = self.map.mp_obs_kf[mp_ids, 0]
            rid = np.where(ref_kf >= 0, lut[np.clip(ref_kf, 0, None)], -1)
            if moved_by:
                pos_lut = np.full(self.map.mp_pos.shape[0], -1, np.int64)
                pos_lut[mp_ids] = np.arange(len(mp_ids))
                mv_ids = np.fromiter(moved_by.keys(), np.int64, len(moved_by))
                mv_kf = np.fromiter(moved_by.values(), np.int64, len(moved_by))
                p = pos_lut[mv_ids]
                sel = p >= 0
                rid[p[sel]] = lut[mv_kf[sel]]
            okm = rid >= 0
            ids = mp_ids[okm]
            r = rid[okm]
            pw = self.map.mp_pos[ids]
            pc = s_arr[r, None] * np.einsum("nij,nj->ni", R_arr[r], pw) + t_arr[r]
            pw_new = (1.0 / s_new[r])[:, None] * np.einsum("nji,nj->ni", R_new[r], pc - t_new[r])
            self.map.mp_pos[ids] = pw_new.astype(np.float32)

        for kf, i in idx_of.items():
            self.map.kf_R[kf] = R_new[i].astype(np.float32)
            self.map.kf_t[kf] = (t_new[i] / s_new[i]).astype(np.float32)
        self.map.update_point_stats(mp_ids)

    # ------------------------------------------------------------------
    def _run_global_ba(self):
        """Bundle adjustment over every keyframe and map point, keyframe 0
        fixed for the gauge: the reduced camera system of the PQ layout up to
        128 padded cameras (one LM iteration per call), the matrix-free flat
        solver above. Observations beyond global_ba_obs_per_point per point
        are dropped on the reduced-system path, as in the reference."""
        m = self.map
        ocfg = self.cfg.optim
        kfs = np.nonzero(m.kf_valid)[0]
        mp = np.nonzero(m.mp_valid)[0]
        mp = mp[m.mp_obs_n[mp] > 0]
        if len(kfs) < 3 or len(mp) < 32:
            return
        n_obs = int(np.count_nonzero(m.mp_obs_kf[mp] >= 0))
        C_pad, P_pad, O_pad = global_problem_shapes(len(kfs), len(mp), n_obs)
        Qg = ocfg.global_ba_obs_per_point
        use_rcs = C_pad <= 128
        cam_free = kfs != 0
        if use_rcs:
            prob, _, _, _ = assemble_ba_problem(m, kfs, cam_free, mp, C_pad, P_pad, O_pad=None,
                                                Q_pad=Qg, obs_per_point_cap=Qg, pq_layout=True)
        else:
            prob, _, _, _ = assemble_ba_problem(m, kfs, cam_free, mp, C_pad, P_pad, O_pad)
        prob = upload_problem(prob, self.device)
        R, t, xw = prob.R, prob.t, prob.xw
        lam = torch.tensor(ocfg.lm_lambda_init, dtype=torch.float32, device=self.device)
        active = prob.obs_valid.to(torch.float32)
        n_iters = ocfg.global_ba_iters
        t0 = time.perf_counter()
        if use_rcs:
            for _ in range(n_iters):
                R, t, xw, lam, _ = lm_chunk_pq(self.cam, prob, R, t, xw, lam, active, True, ocfg, 1)
        else:
            index = flat_index(prob)
            for _ in range(n_iters):
                R, t, xw, lam, _ = gba_iteration(self.cam, prob, index, R, t, xw, lam, active,
                                                 True, ocfg)
        R, t, xw = to_host(R, t, xw)
        self.gba_iter_times = [(time.perf_counter() - t0) / n_iters] * n_iters
        self._gba_writeback(kfs, cam_free, mp, R, t, xw)

    def _gba_writeback(self, kfs, cam_free, mp, Rn, tn, xwn):
        """Write the global BA result into the map: optimized keyframes and
        points directly; keyframes outside the problem through the spanning
        tree, their points through their reference keyframe."""
        m = self.map
        nk = len(kfs)
        in_prob_kf = np.zeros(m.kf_capacity, bool)
        in_prob_kf[kfs] = True
        bef_R = m.kf_R.copy()
        bef_t = m.kf_t.copy()

        wr = m.kf_valid[kfs] & cam_free
        m.kf_R[kfs[wr]] = Rn[:nk][wr]
        m.kf_t[kfs[wr]] = tn[:nk][wr]

        todo = deque(int(x) for x in kfs)
        seen = set(int(x) for x in kfs)
        while todo:
            p = todo.popleft()
            for c in m.children.get(p, ()):
                if c in seen:
                    continue
                seen.add(c)
                if m.kf_valid[c] and not in_prob_kf[c]:
                    T_cn = (_pose_mat(bef_R[c], bef_t[c]) @ np.linalg.inv(_pose_mat(bef_R[p], bef_t[p]))
                            @ _pose_mat(m.kf_R[p], m.kf_t[p]))
                    m.kf_R[c] = T_cn[:3, :3].astype(np.float32)
                    m.kf_t[c] = T_cn[:3, 3].astype(np.float32)
                todo.append(c)

        in_prob_mp = np.zeros(m.mp_capacity, bool)
        in_prob_mp[mp] = True
        alive = m.mp_valid[mp]
        m.mp_pos[mp[alive]] = xwn[: len(mp)][alive]
        others = np.nonzero(m.mp_valid & ~in_prob_mp)[0]
        if len(others):
            r = m.mp_obs_kf[others, 0]
            ok = (r >= 0) & m.kf_valid[np.clip(r, 0, None)]
            others, r = others[ok], r[ok]
            pc = np.einsum("nij,nj->ni", bef_R[r], m.mp_pos[others]) + bef_t[r]
            m.mp_pos[others] = np.einsum("nji,nj->ni", m.kf_R[r], pc - m.kf_t[r]).astype(np.float32)
        m.update_point_stats(np.nonzero(m.mp_valid)[0])
        m.write_epoch += 1
