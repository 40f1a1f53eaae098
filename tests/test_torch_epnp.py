"""PnP RANSAC of the PyTorch port against the JAX reference on the CPU, on
matches from a rendered scene: keyframe-side 3-D points from one rendered
stereo frame, pixels from a frame three steps later, matched by descriptor.
The port's solver gets the minimal sets the reference drew from its key."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orb_slam2_2021_tpu.config import synthetic_config
from orb_slam2_2021_tpu.io.synthetic import SyntheticStereoWorld, forward_trajectory
from orb_slam2_2021_tpu.solvers.epnp import epnp_ransac as j_epnp
from orb_slam2_2021_tpu_torch.convert import samples_from_reference
from orb_slam2_2021_tpu_torch.frontend.frame import build_stereo_frame_from_u8
from orb_slam2_2021_tpu_torch.frontend.matchers import match_bruteforce_desc
from orb_slam2_2021_tpu_torch.solvers import epnp as tepnp

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def scene():
    """(xw, uv, sigma2, valid) of matched features, and the true pose."""
    cfg = synthetic_config(width=320, height=240)
    world = SyntheticStereoWorld(cfg, seed=3)
    gt = forward_trajectory(4, step=0.12)
    frames = []
    for R, t in (gt[0], gt[3]):
        pair = np.clip(np.stack(world.render(R, t)), 0, 255).astype(np.uint8)
        frames.append(build_stereo_frame_from_u8(torch.from_numpy(pair), cfg))
    f0, f1 = frames
    depth = f0.depth.numpy()
    xy0 = f0.kp.xy.numpy()
    ok0 = f0.kp.valid & (f0.depth > 0)
    best, accept, _ = match_bruteforce_desc(f1.kp.desc, f1.kp.valid, f1.kp.angle,
                                            f0.kp.desc, ok0, f0.kp.angle)
    accept, best = accept.numpy(), best.numpy().astype(np.int64)
    n = f1.kp.capacity
    fidx = np.nonzero(accept)[0]
    b = best[fidx]
    z = depth[b]
    xw = np.zeros((n, 3), np.float32)
    xw[fidx] = np.stack([(xy0[b, 0] - cfg.cx) * z / cfg.fx, (xy0[b, 1] - cfg.cy) * z / cfg.fy, z], 1)
    uv = np.zeros((n, 2), np.float32)
    uv[fidx] = f1.kp.xy.numpy()[fidx]
    s2 = np.ones(n, np.float32)
    s2[fidx] = (cfg.orb.scale_factor ** (2 * f1.kp.octave.numpy()[fidx])).astype(np.float32)
    valid = np.zeros(n, bool)
    valid[fidx] = True
    # camera 1 in camera 0's frame: T_c1_c0 = T_c1_w T_w_c0
    T = [np.eye(4), np.eye(4)]
    for T_, (R, t) in zip(T, (gt[0], gt[3])):
        T_[:3, :3], T_[:3, 3] = R, t
    T10 = np.linalg.inv(T[1]) @ T[0]
    return cfg, (xw, uv, s2, valid), T10


def _reference_samples(key, valid, m, n_hyps):
    probs = jnp.asarray(valid, jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    idx = jax.vmap(lambda k: jax.random.choice(k, len(valid), shape=(m,), replace=False, p=probs))(
        jax.random.split(key, n_hyps))
    return samples_from_reference(np.asarray(idx), "cpu")


def _angle_deg(R, R_true):
    return float(np.degrees(np.arccos(np.clip((np.trace(R.T @ R_true) - 1.0) / 2.0, -1.0, 1.0))))


@pytest.mark.parametrize("seed", [17, 21, 40])
def test_epnp_ransac_with_reference_samples(scene, seed, monkeypatch):
    """At the reference's float32 eigenproblems: inlier mask identical
    (measured: identical on all three keys); R within 1e-4 and t within 1 cm
    (measured 3e-5 and 6.1 mm: the final DLT refit's 12x12 float32 normal
    equations leave the translation that loose; the motion-only refine that
    follows in relocalization removes it). At the port's own float64
    eigenproblems: the same inlier mask, and a pose as close to the truth
    as the reference's within 0.2 degrees and 10 cm (measured within 0.11
    degrees and 6.6 cm; on this scene the raw RANSAC pose of the reference
    itself lies 0.33-0.86 degrees and 13-26 cm from the truth)."""
    cfg, args, T10 = scene
    assert args[3].sum() > 150
    key = jax.random.PRNGKey(seed)
    idx = _reference_samples(key, args[3], tepnp.MIN_SAMPLE, 256)
    jR, jt, jinl, jn = j_epnp(key, *map(jnp.asarray, args), cfg.fx, cfg.fy, cfg.cx, cfg.cy,
                              n_hyps=256)
    jR, jt, jinl = np.asarray(jR), np.asarray(jt), np.asarray(jinl)
    targs = [torch.from_numpy(a) for a in args]
    with monkeypatch.context() as mp:
        mp.setattr(tepnp, "EIG_DTYPE", torch.float32)
        R, t, inl, n = tepnp.epnp_ransac(idx, *targs, cfg.fx, cfg.fy, cfg.cx, cfg.cy)
    assert np.array_equal(inl.numpy(), jinl) and int(n) == int(jn)
    assert int(n) > 0.8 * args[3].sum()
    assert np.abs(R.numpy() - jR).max() < 1e-4, "R: tolerance 1e-4"
    assert np.abs(t.numpy() - jt).max() < 1e-2, "t: tolerance 1 cm"
    # the frames are 0.36 m apart along the optical axis
    assert abs(np.linalg.norm(t.numpy()) - np.linalg.norm(T10[:3, 3])) < 0.2

    R, t, inl, n = tepnp.epnp_ransac(idx, *targs, cfg.fx, cfg.fy, cfg.cx, cfg.cy)
    assert np.array_equal(inl.numpy(), jinl)
    R_true, t_true = T10[:3, :3], T10[:3, 3]
    assert _angle_deg(R.numpy(), R_true) < _angle_deg(jR, R_true) + 0.2, "R: margin 0.2 degrees"
    assert np.linalg.norm(t.numpy() - t_true) < np.linalg.norm(jt - t_true) + 0.1, "t: margin 10 cm"


def test_planar_and_degenerate_samples(scene, monkeypatch):
    """Each candidate solver against the reference on 40 weighted matches,
    both at float32 eigenproblems (R within 1e-4, t within 1 mm; on a
    6-point minimal set the float32 DLT is ill-conditioned and differs by up
    to 6e-3 in R, which only moves which hypotheses score best), and a
    non-finite sample rejected with a finite pose instead of failing the
    decomposition, at both precisions."""
    from orb_slam2_2021_tpu.solvers import epnp as jepnp

    cfg, (xw, uv, s2, valid), _ = scene
    sel = np.nonzero(valid)[0][:40]
    xn = (uv[sel, 0] - cfg.cx) / cfg.fx
    yn = (uv[sel, 1] - cfg.cy) / cfg.fy
    w = (1.0 / np.sqrt(s2[sel])).astype(np.float32)
    monkeypatch.setattr(tepnp, "EIG_DTYPE", torch.float32)
    for name in ("_dlt_pose_n", "_homography_pose"):
        jR, jt, jok = getattr(jepnp, name)(*map(jnp.asarray, (xw[sel], xn, yn, w)))
        R, t, ok = getattr(tepnp, name)(*map(torch.from_numpy, (xw[sel], xn, yn, w)))
        assert bool(ok) == bool(jok)
        assert np.abs(R.numpy() - np.asarray(jR)).max() < 1e-4, name
        assert np.abs(t.numpy() - np.asarray(jt)).max() < 1e-3, name
    bad = xw[sel].copy()
    bad[0] = np.nan
    for eig_dtype in (torch.float32, torch.float64):
        monkeypatch.setattr(tepnp, "EIG_DTYPE", eig_dtype)
        R, t, ok = tepnp._dlt_pose_n(*map(torch.from_numpy, (bad, xn, yn, w)))
        assert not bool(ok) and torch.isfinite(R).all() and torch.isfinite(t).all()
        R, t, ok = tepnp._homography_pose(*map(torch.from_numpy, (bad, xn, yn, w)))
        assert not bool(ok) and torch.isfinite(R).all()
