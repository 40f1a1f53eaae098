"""Global bundle adjustment of the PyTorch port against the JAX reference on
the CPU: the padded global shapes, one flat-layout LM iteration (the solver
above 128 cameras) on a seeded problem, and `_run_global_ba` with its
write-back on two identically built maps, on both solver paths."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orb_slam2_2021_tpu.config import OptimConfig, synthetic_config
from orb_slam2_2021_tpu.geometry.camera import PinholeCamera as JCam
from orb_slam2_2021_tpu.mapping.map_store import MapStore
from orb_slam2_2021_tpu.optim import assemble as jassemble
from orb_slam2_2021_tpu.optim.ba import BAProblem as JProb
from orb_slam2_2021_tpu.optim.ba_cg import make_gba_iteration
from orb_slam2_2021_tpu.pipeline.loop_closing import LoopClosing as JLC
from orb_slam2_2021_tpu.place.kf_database import KeyFrameDatabase as JDB
from orb_slam2_2021_tpu.place.vocab import BinaryVocabulary as JVoc
from orb_slam2_2021_tpu_torch.convert import ba_problem_from_reference
from orb_slam2_2021_tpu_torch.geometry.camera import PinholeCamera as TCam
from orb_slam2_2021_tpu_torch.optim.assemble import global_problem_shapes
from orb_slam2_2021_tpu_torch.optim.ba_cg import flat_index, gba_iteration
from orb_slam2_2021_tpu_torch.pipeline import loop_closing as tloop
from orb_slam2_2021_tpu_torch.place.kf_database import KeyFrameDatabase as TDB
from orb_slam2_2021_tpu_torch.place.vocab import BinaryVocabulary as TVoc

torch.set_num_threads(1)


def test_global_problem_shapes_match_reference():
    for n in ((3, 40, 90), (64, 1024, 4096), (65, 1025, 4097), (129, 5574, 30000), (300, 9000, 70000)):
        assert global_problem_shapes(*n) == jassemble.global_problem_shapes(*n)


def _flat_problem(rng, C=10, P=300, q=3, O_pad=1024):
    """Cameras along x looking at a point cloud, observations in shuffled
    order, padded; poses and points perturbed, 2% gross outliers."""
    t_gt = np.zeros((C, 3), np.float32)
    t_gt[:, 0] = -0.4 * np.arange(C)
    pts = np.stack([rng.uniform(-2, 2 + 0.4 * C, P), rng.uniform(-2, 2, P),
                    rng.uniform(5, 12, P)], 1).astype(np.float32)
    cam = np.stack([rng.choice(C, q, replace=False) for _ in range(P)]).reshape(-1)
    pt = np.repeat(np.arange(P), q)
    order = rng.permutation(P * q)
    cam, pt = cam[order], pt[order]
    O = P * q
    xc = pts[pt] + t_gt[cam]
    u = 400 * xc[:, 0] / xc[:, 2] + 320
    uvr = np.stack([u, 400 * xc[:, 1] / xc[:, 2] + 240, u - 80 / xc[:, 2]], 1)
    uvr = (uvr + rng.normal(0, 0.3, uvr.shape)).astype(np.float32)
    uvr[rng.random(O) < 0.3, 2] = -1.0
    uvr[rng.choice(O, O // 50, replace=False), :2] += 25.0
    pad = O_pad - O
    f32 = np.float32
    t0 = t_gt + np.where(np.arange(C)[:, None] >= 1, rng.normal(0, 0.04, (C, 3)), 0).astype(f32)
    return JProb(
        R=np.tile(np.eye(3, dtype=f32), (C, 1, 1)), t=t0.astype(f32),
        xw=(pts + rng.normal(0, 0.04, pts.shape)).astype(f32),
        obs_cam=np.r_[cam, np.zeros(pad)].astype(np.int32),
        obs_pt=np.r_[pt, np.zeros(pad)].astype(np.int32),
        obs_uvr=np.r_[uvr, -np.ones((pad, 3), f32)].astype(f32),
        obs_inv_sigma2=np.ones(O_pad, f32), obs_valid=np.arange(O_pad) < O,
        pt_obs=np.full((P, 1), -1, np.int32), cam_free=np.arange(C) >= 1,
    )


def test_flat_gba_iteration_matches_reference():
    """Three Huber LM iterations of the flat solver from a perturbed start:
    R within 1e-5, t within 1e-4 m, xw within 1e-3 m, lambda identical."""
    cfg = OptimConfig()
    prob = _flat_problem(np.random.default_rng(0))
    jcam = JCam.create(400.0, 400.0, 320.0, 240.0, 80.0, 640, 480)
    tcam = TCam.create(400.0, 400.0, 320.0, 240.0, 80.0, 640, 480)
    step = make_gba_iteration(cfg)
    jp = JProb(*(jnp.asarray(x) for x in prob))
    tp = ba_problem_from_reference(prob, "cpu")
    index = flat_index(tp)
    assert index.pt_table.shape == (300, 3) and int((index.pt_table >= 0).sum()) == 900
    jR, jt, jx, jlam = jp.R, jp.t, jp.xw, jnp.float32(cfg.lm_lambda_init)
    R, t, xw, lam = tp.R, tp.t, tp.xw, torch.tensor(cfg.lm_lambda_init)
    for _ in range(3):
        jR, jt, jx, jlam, jcost = step(jcam, jp, jR, jt, jx, jlam, jp.obs_valid.astype(jnp.float32), True)
        R, t, xw, lam, cost = gba_iteration(tcam, tp, index, R, t, xw, lam, tp.obs_valid.float(),
                                            True, cfg)
        assert float(lam) == float(jlam)
    assert np.abs(R.numpy() - np.asarray(jR)).max() < 1e-5
    assert np.abs(t.numpy() - np.asarray(jt)).max() < 1e-4
    assert np.abs(xw.numpy() - np.asarray(jx)).max() < 1e-3
    assert abs(float(cost) - float(jcost)) <= 1e-4 * float(jcost)
    assert np.abs(t.numpy() - prob.t).max() > 0.01, "the solve moved the cameras"


def _stereo_map(cfg, seed=5, n_kf=6, n_pts=500):
    """Keyframes along x looking at a wall of points, every visible point
    observed with noisy stereo pixels; poses (except keyframe 0) and points
    perturbed."""
    rng = np.random.default_rng(seed)
    m = MapStore(cfg)
    N = cfg.orb.n_features
    pts = np.stack([rng.uniform(-3, 3 + 0.3 * n_kf, n_pts), rng.uniform(-2, 2, n_pts),
                    rng.uniform(4, 10, n_pts)], 1).astype(np.float32)
    ids = m.add_map_points_batch(pts + rng.normal(0, 0.03, pts.shape).astype(np.float32),
                                 np.zeros((n_pts, 8), np.uint32), first_kf=0)
    for k in range(n_kf):
        t_true = np.array([-0.3 * k, 0, 0], np.float32)
        xc = pts + t_true
        u = cfg.fx * xc[:, 0] / xc[:, 2] + cfg.cx
        v = cfg.fy * xc[:, 1] / xc[:, 2] + cfg.cy
        vis = np.nonzero((u > 0) & (u < cfg.width) & (v > 0) & (v < cfg.height))[0][:N]
        xy = np.zeros((N, 2), np.float32)
        ur = np.full(N, -1.0, np.float32)
        n = len(vis)
        xy[:n] = np.stack([u[vis], v[vis]], 1) + rng.normal(0, 0.5, (n, 2))
        ur[:n] = u[vis] - cfg.bf / xc[vis, 2] + rng.normal(0, 0.5, n)
        valid = np.zeros(N, bool)
        valid[:n] = True
        t0 = t_true + (rng.normal(0, 0.03, 3).astype(np.float32) if k else 0)
        kf = m.add_keyframe(np.eye(3, dtype=np.float32), t0, xy, ur, np.full(N, -1.0, np.float32),
                            np.zeros(N, np.int32), np.zeros(N, np.float32),
                            np.zeros((N, 8), np.uint32), valid, np.full(N, -1, np.int64))
        for f, p in enumerate(vis):
            m.kf_mp[kf, f] = ids[p]
            m._add_observation(int(ids[p]), kf, f)
        if k:
            m._set_parent(kf, kf - 1)
    for k in range(n_kf):
        m.update_connections(k)
    m.update_point_stats(ids)
    return m


@pytest.mark.parametrize("path", ["reduced", "flat"])
def test_run_global_ba_on_identical_maps(monkeypatch, path):
    """`_run_global_ba` + write-back on two identically built maps: keyframe
    poses within 1e-5 (R) and 1e-4 m (t), points within 1e-3 m. "flat"
    forces the solver of more than 128 padded cameras on both sides."""
    cfg = synthetic_config(width=320, height=240)
    mj, mt = _stereo_map(cfg), _stereo_map(cfg)
    if path == "flat":
        shapes = lambda c, p, o: (256,) + global_problem_shapes(c, p, o)[1:]  # noqa: E731
        monkeypatch.setattr(jassemble, "global_problem_shapes", shapes)
        monkeypatch.setattr(tloop, "global_problem_shapes", shapes)
    voc = JVoc(2, 2, np.zeros((7, 8), np.uint32), np.ones(4, np.float32))
    jlc = JLC(cfg, mj, JDB(voc))
    tlc = tloop.LoopClosing(cfg, mt, TDB(TVoc(2, 2, voc.node_desc, voc.word_idf)), "cpu")
    t_before = mt.kf_t[:6].copy()
    jlc._run_global_ba(idx=jlc.full_ba_idx)
    tlc._run_global_ba()
    assert tlc.gba_runs[-1]["iters"] == len(jlc.gba_iter_times) == cfg.optim.global_ba_iters
    assert np.abs(mt.kf_R[:6] - mj.kf_R[:6]).max() < 1e-5
    assert np.abs(mt.kf_t[:6] - mj.kf_t[:6]).max() < 1e-4
    ids = np.nonzero(mj.mp_valid)[0]
    assert np.abs(mt.mp_pos[ids] - mj.mp_pos[ids]).max() < 1e-3
    assert np.abs(mt.kf_t[1:6] - t_before[1:]).max() > 0.005, "the solve moved the keyframes"
    assert np.array_equal(mt.kf_t[0], t_before[0]), "keyframe 0 fixed"
    assert mt.write_epoch == mj.write_epoch
