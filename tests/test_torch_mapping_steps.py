"""Local-mapping device steps of the PyTorch port held against the JAX
reference on identical inputs: `triangulate_pair` and `fuse_project` on
keyframe views built from rendered 320x240 frames at their true poses, and
the port's batched (leading T axis) form against its own per-pair form."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orb_slam2_2021_tpu.config import synthetic_config
from orb_slam2_2021_tpu.frontend.frame import make_stereo_frame_u8_fn
from orb_slam2_2021_tpu.geometry.camera import PinholeCamera
from orb_slam2_2021_tpu.io.synthetic import SyntheticStereoWorld, forward_trajectory
from orb_slam2_2021_tpu.mapping.map_store import MapStore
from orb_slam2_2021_tpu.pipeline import mapping_steps as jms
from orb_slam2_2021_tpu_torch.convert import (
    camera_from_config,
    desc_from_numpy,
    kfview_from_reference,
    tensor,
)
from orb_slam2_2021_tpu_torch.pipeline import mapping_steps as tms

torch.set_num_threads(1)

CFG = synthetic_config(width=320, height=240)
KF1, KF2S = 0, (5, 10, 15)   # frame indices; 0.6-1.8 m baselines at step 0.12
T = lambda a: tensor(a, "cpu")  # noqa: E731


@pytest.fixture(scope="module")
def views():
    """Reference KFViews of rendered frames at their true Tcw poses, and a
    map point set: frame 0's stereo points with their normals and scale
    bands (MapStore.update_point_stats)."""
    world = SyntheticStereoWorld(CFG, seed=3)
    gt = forward_trajectory(16, step=0.12)
    build = make_stereo_frame_u8_fn(CFG)
    out = {}
    for i in (KF1,) + KF2S:
        R_wc, t_wc = gt[i]
        pair = np.clip(np.stack(world.render(R_wc, t_wc)), 0, 255).astype(np.uint8)
        f = build(jnp.asarray(pair))
        R = np.asarray(R_wc, np.float32).T
        out[i] = jms.KFView(xy=f.kp.xy, ur=f.u_right, depth=f.depth, octave=f.kp.octave,
                            desc=f.kp.desc, valid=f.kp.valid, R=jnp.asarray(R),
                            t=jnp.asarray((-R @ np.asarray(t_wc, np.float32)).astype(np.float32)))
    v0 = out[KF1]
    m = MapStore(CFG)
    good = np.asarray(v0.valid) & (np.asarray(v0.depth) > 0)
    xy, z = np.asarray(v0.xy)[good], np.asarray(v0.depth)[good]
    pos = np.stack([(xy[:, 0] - CFG.cx) * z / CFG.fx, (xy[:, 1] - CFG.cy) * z / CFG.fy, z], 1)
    ids = m.add_map_points_batch(pos.astype(np.float32), np.asarray(v0.desc)[good], first_kf=0)
    bind = np.full(CFG.orb.n_features, -1, np.int64)
    bind[np.nonzero(good)[0]] = ids
    m.add_keyframe(np.asarray(v0.R), np.asarray(v0.t), np.asarray(v0.xy), np.asarray(v0.ur),
                   np.asarray(v0.depth), np.asarray(v0.octave), np.zeros(CFG.orb.n_features, np.float32),
                   np.asarray(v0.desc), np.asarray(v0.valid), bind, 0, 0.0)
    m.update_point_stats(ids)
    pts = (m.mp_pos[ids], m.mp_normal[ids], m.mp_min_dist[ids], m.mp_max_dist[ids],
           m.mp_desc[ids], np.ones(len(ids), bool))
    return out, pts


def _jcam():
    return PinholeCamera.create(CFG.fx, CFG.fy, CFG.cx, CFG.cy, CFG.bf, CFG.width, CFG.height)


def _stack(vs):
    return jax.tree.map(lambda *x: jnp.stack(x), *vs)


def test_triangulate_pair_matches_reference(views):
    vs, _ = views
    tri = jms.make_triangulate_fn(CFG)
    ref = [tuple(np.asarray(x) for x in tri(_jcam(), vs[KF1], vs[k])) for k in KF2S]
    match2, xw, ok, base = tms.triangulate_pair(
        camera_from_config(CFG), kfview_from_reference(vs[KF1], "cpu"),
        kfview_from_reference(_stack([vs[k] for k in KF2S]), "cpu"), CFG)
    n_ok = 0
    for ti, (m_r, xw_r, ok_r, b_r) in enumerate(ref):
        assert np.array_equal(ok.numpy()[ti], ok_r), f"pair {ti}: ok mask identical"
        assert np.array_equal(match2.numpy()[ti][ok_r], m_r[ok_r]), f"pair {ti}: match2 identical"
        # the matched feature of every kf1 feature, gated or not
        assert np.array_equal(match2.numpy()[ti], m_r), f"pair {ti}: argmin identical"
        # the float32 normal equations of a 0.6-1.8 m baseline at 5-80 m
        # amplify summation-order differences: measured at most 1.2e-4 of
        # the point's distance (2.8 mm at 23 m)
        err = np.abs(xw.numpy()[ti][ok_r] - xw_r[ok_r]).max(axis=1)
        rel = err / np.linalg.norm(xw_r[ok_r], axis=1)
        assert rel.max(initial=0.0) < 5e-4, f"pair {ti}: xw within 5e-4 of its distance"
        assert abs(float(base[ti]) - float(b_r)) < 1e-6
        n_ok += int(ok_r.sum())
    assert n_ok > 100, n_ok


def test_triangulate_batched_equals_per_pair(views):
    vs, _ = views
    cam = camera_from_config(CFG)
    kf1 = kfview_from_reference(vs[KF1], "cpu")
    batch = tms.triangulate_pair(cam, kf1, kfview_from_reference(_stack([vs[k] for k in KF2S]), "cpu"), CFG)
    for ti, k in enumerate(KF2S):
        one = tms.triangulate_pair(cam, kf1, kfview_from_reference(_stack([vs[k]]), "cpu"), CFG)
        for b, o in zip(batch, one):
            assert torch.equal(b[ti], o[0]), "batched == per pair (tolerance 0)"


def test_fuse_project_matches_reference(views):
    vs, pts = views
    fuse = jms.make_fuse_fn(CFG)
    jpts = [jnp.asarray(p) for p in pts]
    tpts = [T(p) for p in pts[:4]] + [desc_from_numpy(pts[4], "cpu"), T(pts[5])]
    cam = camera_from_config(CFG)
    best, acc, dist = tms.fuse_project(cam, kfview_from_reference(_stack([vs[k] for k in KF2S]), "cpu"),
                                       *tpts, CFG)
    n_acc = 0
    for ti, k in enumerate(KF2S):
        bf_r, acc_r, d_r = (np.asarray(x) for x in fuse(_jcam(), vs[k], *jpts))
        assert np.array_equal(acc.numpy()[ti], acc_r), f"target {ti}: accept identical"
        assert np.array_equal(best.numpy()[ti], bf_r), f"target {ti}: best_feat identical"
        assert np.array_equal(dist.numpy()[ti], d_r), f"target {ti}: best_dist identical"
        one = tms.fuse_project(cam, kfview_from_reference(_stack([vs[k]]), "cpu"), *tpts, CFG)
        for b, o in zip((best, acc, dist), one):
            assert torch.equal(b[ti], o[0]), "batched == per target (tolerance 0)"
        n_acc += int(acc_r.sum())
    assert n_acc > 100, n_acc
