"""The essential-graph Sim3 pose graph of the PyTorch port against the JAX
reference on the CPU, on the drifted 8-keyframe map of
tests/test_loop_writeback.py: the solver on the reference's own pose graph,
and `_optimize_essential_graph` (graph assembly, solve, write-back) on two
identically built maps."""

import numpy as np
import pytest
import torch

from orb_slam2_2021_tpu.config import synthetic_config
from orb_slam2_2021_tpu.mapping.map_store import MapStore
from orb_slam2_2021_tpu.pipeline.loop_closing import LoopClosing as JLC, _sim3_inv
from orb_slam2_2021_tpu.place.kf_database import KeyFrameDatabase as JDB
from orb_slam2_2021_tpu.place.vocab import BinaryVocabulary as JVoc
from orb_slam2_2021_tpu_torch.convert import pose_graph_from_reference
from orb_slam2_2021_tpu_torch.optim.sim3_opt import essential_graph_solve
from orb_slam2_2021_tpu_torch.pipeline.loop_closing import LoopClosing as TLC
from orb_slam2_2021_tpu_torch.place.kf_database import KeyFrameDatabase as TDB
from orb_slam2_2021_tpu_torch.place.vocab import BinaryVocabulary as TVoc

torch.set_num_threads(1)


def _drifted_map(cfg):
    """Keyframes 0..7 along x, 4..7 drifted by 0.8 m and 12 degrees, 40
    points each; the loop state at the essential graph's entry: keyframe 7
    closes on keyframe 0, the group {7, 6} already corrected and its points
    moved. Returns (map, corrected, old_poses, moved_by)."""
    m = MapStore(cfg)
    rng = np.random.default_rng(3)
    n_kf, drift_from = 8, 4
    gt_pos = np.stack([np.array([0.5 * k, 0, 0]) for k in range(n_kf)]).astype(np.float32)
    a = np.deg2rad(12.0)
    Rd = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]], np.float32)
    td = np.array([0.8, 0.3, -0.4], np.float32)
    kf_pw = {}
    N = cfg.orb.n_features
    for k in range(n_kf):
        R_cw = np.eye(3, dtype=np.float32)
        t_cw = (-gt_pos[k]).astype(np.float32)
        if k >= drift_from:
            R_cw = Rd.T.astype(np.float32)
            t_cw = (-Rd.T @ (gt_pos[k] + td)).astype(np.float32)
        xc = np.stack([rng.uniform(-2, 2, 40), rng.uniform(-1.5, 1.5, 40), rng.uniform(4, 8, 40)],
                      axis=1).astype(np.float32)
        pw = (xc - t_cw) @ R_cw
        valid = np.zeros(N, bool)
        valid[:40] = True
        k_id = m.add_keyframe(
            R_cw, t_cw, np.zeros((N, 2), np.float32), np.full(N, -1.0, np.float32),
            np.full(N, -1.0, np.float32), np.zeros(N, np.int32), np.zeros(N, np.float32),
            np.zeros((N, 8), np.uint32), valid, np.full(N, -1, np.int64),
        )
        ids = m.add_map_points_batch(pw, np.zeros((40, 8), np.uint32), first_kf=k_id)
        for f, mp in enumerate(ids):
            m.kf_mp[k_id, f] = mp
            m._add_observation(int(mp), k_id, f)
        kf_pw[k] = ids
        if k > 0:
            m._set_parent(k, k - 1)
        m.update_connections(k)
    corrected, old_poses, moved_by = {}, {}, {}
    for ki in (7, 6):
        old_poses[ki] = (1.0, m.kf_R[ki].copy(), m.kf_t[ki].copy())
        corrected[ki] = (1.0, np.eye(3, dtype=np.float32), (-gt_pos[ki]).astype(np.float32))
    for ki in (7, 6):
        sc, Rc, tc = corrected[ki]
        so, Ro, to = old_poses[ki]
        for mp in kf_pw[ki]:
            mp = int(mp)
            if mp in moved_by:
                continue
            pc = so * (Ro @ m.mp_pos[mp]) + to
            sci, Rci, tci = _sim3_inv(sc, Rc, tc)
            m.mp_pos[mp] = (sci * (Rci @ pc) + tci).astype(np.float32)
            moved_by[mp] = ki
        m.kf_R[ki] = Rc
        m.kf_t[ki] = (tc / sc).astype(np.float32)
    m.loop_edges = {7: {0}, 0: {7}}
    return m, corrected, old_poses, moved_by


def _closers(cfg, mj, mt, fix_scale=True):
    voc = JVoc(2, 2, np.zeros((7, 8), np.uint32), np.ones(4, np.float32))
    tvoc = TVoc(2, 2, voc.node_desc, voc.word_idf)
    return (JLC(cfg, mj, JDB(voc), fix_scale=fix_scale),
            TLC(cfg, mt, TDB(tvoc), "cpu", fix_scale=fix_scale))


@pytest.mark.parametrize("fix_scale", [True, False])
def test_essential_graph_solve_matches_reference(fix_scale):
    """The reference's padded pose graph (32 vertices, 256 edges) through
    both solvers, with the scale fixed (stereo and RGB-D loops) and free
    (monocular loops): s, R within 1e-5, t within 1e-4 m."""
    cfg = synthetic_config()
    m, corrected, old_poses, moved_by = _drifted_map(cfg)
    jlc, _ = _closers(cfg, m, m, fix_scale)
    seen = {}
    solve = jlc._essential

    def capture(g):
        seen["g"] = g
        seen["out"] = solve(g)
        return seen["out"]

    jlc._essential = capture
    jlc._optimize_essential_graph(7, 0, corrected, old_poses, moved_by)
    g = seen["g"]
    assert g.s.shape == (32,) and g.edge_i.shape == (256,) and float(g.weight.sum()) >= 8
    s, R, t = essential_graph_solve(pose_graph_from_reference(g, "cpu"), fix_scale=fix_scale)
    js, jR, jt = (np.asarray(x) for x in seen["out"])
    assert np.abs(s.numpy() - js).max() < 1e-5, "s: tolerance 1e-5"
    assert np.abs(R.numpy() - jR).max() < 1e-5, "R: tolerance 1e-5"
    assert np.abs(t.numpy() - jt).max() < 1e-4, "t: tolerance 1e-4 m"
    assert np.abs(t.numpy() - g.t).max() > 0.05, "the solve moved the drifted keyframes"
    # a free scale moves: the drifted keyframes' scales leave 1
    assert (np.abs(js - 1.0).max() > 1e-3) != fix_scale


def test_optimize_essential_graph_on_identical_maps():
    """Graph assembly, solve and write-back on two identically built maps:
    keyframe poses within 1e-5 (R) and 1e-4 m (t), points within 1e-4 m;
    the port keeps every point's reprojection into its reference keyframe
    within 1 px, the write-back invariant of the reference."""
    cfg = synthetic_config()
    mj, corrected, old_poses, moved_by = _drifted_map(cfg)
    mt, *_ = _drifted_map(cfg)
    jlc, tlc = _closers(cfg, mj, mt)

    def uv_in_ref(m):
        ids = np.nonzero(m.mp_valid)[0]
        rk = m.mp_obs_kf[ids, 0]
        pc = np.einsum("nij,nj->ni", m.kf_R[rk], m.mp_pos[ids]) + m.kf_t[rk]
        return np.stack([cfg.fx * pc[:, 0] / pc[:, 2], cfg.fy * pc[:, 1] / pc[:, 2]], 1), pc[:, 2]

    uv0, _ = uv_in_ref(mt)
    jlc._optimize_essential_graph(7, 0, corrected, old_poses, moved_by)
    tlc._optimize_essential_graph(7, 0, corrected, old_poses, moved_by)
    kfs = np.nonzero(mj.kf_valid)[0]
    assert np.abs(mt.kf_R[kfs] - mj.kf_R[kfs]).max() < 1e-5
    assert np.abs(mt.kf_t[kfs] - mj.kf_t[kfs]).max() < 1e-4
    assert np.abs(mt.mp_pos - mj.mp_pos).max() < 1e-4
    assert mt.kf_R.dtype == mt.mp_pos.dtype == np.float32
    uv1, z = uv_in_ref(mt)
    assert (z > 0).all() and np.linalg.norm(uv1 - uv0, axis=1).max() < 1.0
