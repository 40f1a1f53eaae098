"""Tracking steps of the PyTorch port held against the JAX reference on
identical inputs: the geometry substrate, the matchers, `pose_optimize`
(with outliers) and the fused track step.

The matcher and fused-step inputs are real tracking state: the reference's
Tracking is driven over a few rendered 320x240 frames and the arguments of
its fused step (frame, last frame, snapshot, pose pack) are recorded and
handed to both packages.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orb_slam2_2021_tpu.config import synthetic_config
from orb_slam2_2021_tpu.frontend import matchers as jmatch
from orb_slam2_2021_tpu.frontend.frame import make_stereo_frame_u8_fn
from orb_slam2_2021_tpu.geometry import camera as jcam
from orb_slam2_2021_tpu.geometry import se3 as jse3
from orb_slam2_2021_tpu.io.synthetic import SyntheticStereoWorld, forward_trajectory
from orb_slam2_2021_tpu.mapping.map_store import MapStore
from orb_slam2_2021_tpu.optim import pose as jpose
from orb_slam2_2021_tpu.optim import robust as jrobust
from orb_slam2_2021_tpu.pipeline import track_steps as jsteps
from orb_slam2_2021_tpu.pipeline.tracking import Tracking as JTracking
from orb_slam2_2021_tpu_torch.convert import (
    camera_from_config,
    desc_from_numpy,
    keypoints_from_reference,
    tensor,
    track_inputs_from_reference,
)
from orb_slam2_2021_tpu_torch.frontend import matchers as tmatch
from orb_slam2_2021_tpu_torch.geometry import camera as tcam
from orb_slam2_2021_tpu_torch.geometry import se3 as tse3
from orb_slam2_2021_tpu_torch.optim import pose as tpose
from orb_slam2_2021_tpu_torch.optim import robust as trobust
from orb_slam2_2021_tpu_torch.pipeline import track_steps as tsteps

torch.set_num_threads(1)

CFG = synthetic_config(width=320, height=240)
T = lambda a: tensor(a, "cpu")  # noqa: E731


def test_geometry_substrate_matches_reference():
    rng = np.random.default_rng(0)
    xi = (rng.normal(size=(64, 6)) * np.array([1, 1, 1, 0.5, 0.5, 0.5])).astype(np.float32)
    xi[:4, 3:] *= 1e-5  # the small-angle branch
    Rj, tj = jse3.se3_exp(jnp.asarray(xi))
    Rt, tt = tse3.se3_exp(T(xi))
    assert np.allclose(Rt.numpy(), np.asarray(Rj), rtol=1e-6, atol=1e-6), "se3_exp R: 1e-6"
    assert np.allclose(tt.numpy(), np.asarray(tj), rtol=1e-6, atol=1e-6), "se3_exp t: 1e-6"
    Rc_j, tc_j = jse3.se3_compose(Rj[:32], tj[:32], Rj[32:], tj[32:])
    Rc_t, tc_t = tse3.se3_compose(Rt[:32], tt[:32], Rt[32:], tt[32:])
    assert np.allclose(Rc_t.numpy(), np.asarray(Rc_j), rtol=1e-6, atol=1e-6), "compose R: 1e-6"
    assert np.allclose(tc_t.numpy(), np.asarray(tc_j), rtol=1e-6, atol=1e-6), "compose t: 1e-6"

    cj = jcam.PinholeCamera.create(CFG.fx, CFG.fy, CFG.cx, CFG.cy, CFG.bf, CFG.width, CFG.height)
    ct = camera_from_config(CFG)
    xc = (rng.normal(size=(200, 3)) + np.array([0, 0, 8])).astype(np.float32)
    pj, zj = jcam.project_stereo(cj, jnp.asarray(xc))
    pt, zt = tcam.project_stereo(ct, T(xc))
    assert np.allclose(pt.numpy(), np.asarray(pj), rtol=1e-6, atol=1e-4), "project_stereo: 1e-6 rel"
    obs = (np.asarray(pj) + rng.normal(0, 1, (200, 3))).astype(np.float32)
    pairs = [
        (jrobust.stereo_residual(cj, jnp.asarray(xc), jnp.asarray(obs)),
         trobust.stereo_residual(ct, T(xc), T(obs))),
        (jrobust.mono_residual(cj, jnp.asarray(xc), jnp.asarray(obs[:, :2])),
         trobust.mono_residual(ct, T(xc), T(obs[:, :2]))),
        (jrobust.proj_jacobian_stereo(cj, jnp.asarray(xc)), trobust.proj_jacobian_stereo(ct, T(xc))),
        (jrobust.proj_jacobian_mono(cj, jnp.asarray(xc)), trobust.proj_jacobian_mono(ct, T(xc))),
        (jrobust.point_jacobian_pose(jnp.asarray(xc)), trobust.point_jacobian_pose(T(xc))),
        (jrobust.huber_weight(jnp.asarray(obs[:, 0] ** 2), 5.991),
         trobust.huber_weight(T(obs[:, 0] ** 2), 5.991)),
    ]
    for j, t in pairs:
        assert np.allclose(t.numpy(), np.asarray(j), rtol=1e-6, atol=1e-4), \
            "residuals / Jacobians / Huber weight: 1e-6 relative"


def test_pose_optimize_with_outliers():
    rng = np.random.default_rng(1)
    n = 300
    xw = np.stack([rng.uniform(-6, 6, n), rng.uniform(-4, 4, n), rng.uniform(4, 25, n)], 1)
    xw = xw.astype(np.float32)
    Rt, tt = jse3.se3_exp(jnp.asarray(np.array([0.1, -0.05, 0.2, 0.01, 0.02, -0.015], np.float32)))
    cj = jcam.PinholeCamera.create(CFG.fx, CFG.fy, CFG.cx, CFG.cy, CFG.bf, CFG.width, CFG.height)
    uvr, _ = jcam.project_stereo(cj, jnp.einsum("ij,nj->ni", Rt, jnp.asarray(xw)) + tt)
    uvr = np.array(uvr) + rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    out = rng.random(n) < 0.2
    uvr[out, :2] += rng.uniform(-40, 40, (out.sum(), 2))   # gross outliers
    uvr[rng.random(n) < 0.3, 2] = -1.0                     # monocular observations
    inv_s2 = (1.0 / 1.2 ** (2 * rng.integers(0, 4, n))).astype(np.float32)
    valid = rng.random(n) < 0.95
    R0, t0 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)

    obs_j = jpose.PoseObs(jnp.asarray(xw), jnp.asarray(uvr), jnp.asarray(inv_s2), jnp.asarray(valid))
    Rj, tj, inl_j, n_j = jax.jit(jpose.pose_optimize, static_argnums=4)(
        cj, jnp.asarray(R0), jnp.asarray(t0), obs_j, CFG.optim)
    obs_t = tpose.PoseObs(T(xw), T(uvr), T(inv_s2), T(valid))
    R, t, inl, n_in = tpose.pose_optimize(camera_from_config(CFG), T(R0), T(t0), obs_t, CFG.optim)
    assert np.array_equal(inl.numpy(), np.asarray(inl_j)), "inlier mask: identical"
    assert int(n_in) == int(n_j) and int(n_in) > 150
    assert np.abs(R.numpy() - np.asarray(Rj)).max() < 1e-5, "R: tolerance 1e-5"
    assert np.abs(t.numpy() - np.asarray(tj)).max() < 1e-4, "t: tolerance 1e-4 m"
    assert np.abs(t.numpy() - np.asarray(tt)).max() < 0.05, "recovers the true pose within 5 cm"


@pytest.fixture(scope="module")
def recorded():
    """Arguments of the reference tracker's fused step on frame 4 of a
    rendered sequence (frame 0 initializes, frame 1 tracks the reference KF,
    frames 2-4 take the fused path)."""
    world = SyntheticStereoWorld(CFG, seed=3)
    tracker = JTracking(CFG, MapStore(CFG))
    build = make_stereo_frame_u8_fn(CFG)
    calls = []
    fused = tracker._fused_fn
    tracker._fused_fn = lambda *args: calls.append(args) or fused(*args)
    for i, (R, t) in enumerate(forward_trajectory(5, step=0.12)):
        left, right = world.render(R, t)
        pair = np.clip(np.stack([left, right]), 0, 255).astype(np.uint8)
        assert tracker.track_stereo_frame(build(jnp.asarray(pair)), i, 0.1 * i) is not None
    cam, kp, ur, depth, l_desc, l_oct, l_ang, l_valid, pack, s_geom, s_desc, s_valid = calls[-1]
    n = CFG.orb.n_features
    pack = np.asarray(pack)
    return dict(
        cam=cam, kp=kp, ur=ur, depth=depth, last=(l_desc, l_oct, l_ang, l_valid),
        last_geom=pack[:4 * n].reshape(n, 4), last_slot=pack[4 * n:5 * n].view(np.int32),
        pose_pack=pack[5 * n:], snap=(s_geom, s_desc, s_valid),
    )


def _port_last(rec):
    l_desc, l_oct, l_ang, l_valid = rec["last"]
    kp = keypoints_from_reference(
        type(rec["kp"])(xy=rec["kp"].xy, response=rec["kp"].response, octave=l_oct,
                        angle=l_ang, desc=l_desc, valid=l_valid), "cpu")
    return kp.desc, kp.octave, kp.angle, kp.valid


def test_match_last_frame_identical(recorded):
    rec = recorded
    pp = rec["pose_pack"]
    R, t = pp[:9].reshape(3, 3), pp[9:12]
    last_valid = (rec["last_geom"][:, 3] > 0) & np.asarray(rec["last"][3])
    ref = jmatch.match_last_frame(
        rec["cam"], rec["kp"], rec["ur"], jnp.asarray(R), jnp.asarray(t),
        jnp.asarray(rec["last_geom"][:, :3]), rec["last"][0], rec["last"][1], rec["last"][2],
        jnp.asarray(last_valid), CFG, float(pp[12]))
    d, o, a, _ = _port_last(rec)
    out = tmatch.match_last_frame(
        camera_from_config(CFG), keypoints_from_reference(rec["kp"], "cpu"), T(rec["ur"]),
        T(R), T(t), T(rec["last_geom"][:, :3]), d, o, a, T(last_valid), CFG, float(pp[12]))
    acc = np.asarray(ref[1])
    assert acc.sum() > 100
    assert np.array_equal(out[1].numpy(), acc), "accept mask: identical"
    assert np.array_equal(out[0].numpy()[acc], np.asarray(ref[0])[acc]), "matched features: identical"
    assert np.array_equal(out[2].numpy(), np.asarray(ref[2])), "best distances: identical"


def test_match_local_points_identical(recorded):
    rec = recorded
    pp = rec["pose_pack"]
    R, t = pp[:9].reshape(3, 3), pp[9:12]
    geom, desc, valid = rec["snap"]
    geom = np.asarray(geom)
    bound = np.zeros(CFG.orb.n_features, bool)
    bound[::7] = True
    ref = jmatch.match_local_points(
        rec["cam"], rec["kp"], rec["ur"], jnp.asarray(bound), jnp.asarray(R), jnp.asarray(t),
        jnp.asarray(geom[:, :3]), jnp.asarray(geom[:, 3:6]), jnp.asarray(geom[:, 6]),
        jnp.asarray(geom[:, 7]), desc, valid, CFG)
    s_desc = desc_from_numpy(desc, "cpu")
    out = tmatch.match_local_points(
        camera_from_config(CFG), keypoints_from_reference(rec["kp"], "cpu"), T(rec["ur"]),
        T(bound), T(R), T(t), T(geom[:, :3]), T(geom[:, 3:6]), T(geom[:, 6]), T(geom[:, 7]),
        s_desc, T(valid), CFG)
    acc = np.asarray(ref[1])
    assert acc.sum() > 50
    assert np.array_equal(out[3].numpy(), np.asarray(ref[3])), "visible: identical"
    assert np.array_equal(out[1].numpy(), acc), "accept mask: identical"
    assert np.array_equal(out[0].numpy()[acc], np.asarray(ref[0])[acc]), "matched features: identical"


def test_match_bruteforce_identical(recorded):
    rec = recorded
    l_desc, _, l_ang, l_valid = rec["last"]
    kp = rec["kp"]
    ref = jmatch.match_bruteforce_desc(l_desc, l_valid, l_ang, kp.desc, kp.valid, kp.angle)
    d, _, a, v = _port_last(rec)
    tkp = keypoints_from_reference(kp, "cpu")
    out = tmatch.match_bruteforce_desc(d, v, a, tkp.desc, tkp.valid, tkp.angle)
    acc = np.asarray(ref[1])
    assert acc.sum() > 100
    assert np.array_equal(out[1].numpy(), acc), "accept mask: identical"
    assert np.array_equal(out[0].numpy(), np.asarray(ref[0])), "best indices: identical"


def test_fused_track_step_matches_reference(recorded):
    rec = recorded
    geom, desc, valid = rec["snap"]
    fused = jax.jit(jsteps.fused_track_step, static_argnames="cfg")
    ref_f, ref_i = fused(
        rec["cam"], rec["kp"], rec["ur"], rec["depth"], *rec["last"],
        jnp.asarray(rec["last_geom"]), jnp.asarray(rec["last_slot"]), jnp.asarray(rec["pose_pack"]),
        geom, desc, valid, cfg=CFG)
    ins = track_inputs_from_reference(
        rec["last_geom"], rec["last_slot"], rec["pose_pack"], geom, desc, valid, "cpu")
    out_f, out_i = tsteps.fused_track_step(
        camera_from_config(CFG), keypoints_from_reference(rec["kp"], "cpu"), T(rec["ur"]),
        T(rec["depth"]), *_port_last(rec), *ins, CFG)
    ref_f, ref_i = np.asarray(ref_f), np.asarray(ref_i)
    assert np.array_equal(out_i.numpy(), ref_i), "out_i (bindings + visibility): identical"
    assert (ref_i[:CFG.orb.n_features] >= 0).sum() > 100
    f = out_f.numpy()
    assert np.array_equal(f[12:18], ref_f[12:18]), "out_f counts: identical"
    assert np.abs(f[:12] - ref_f[:12]).max() < 1e-4, "final R, t: tolerance 1e-4"
    assert np.abs(f[18:] - ref_f[18:]).max() < 1e-4, "motion R, t: tolerance 1e-4"
