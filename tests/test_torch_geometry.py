"""The port's geometry leftovers held against the JAX package on the CPU, in
float32: `se3_identity`, `se3_from_Rt`, `se3_log` (with its small-angle
branch and rotations near pi), `se3_inverse`, `se3_apply`, `mat44`,
`from_mat44`, `so3.quat_to_rot`, `PinholeCamera.baseline` and
`camera.backproject`. Tolerance 1e-6 absolute (scaled by the values' size
where they exceed 1).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_2021_tpu.geometry import camera as jcam
from orb_slam2_2021_tpu.geometry import se3 as jse3
from orb_slam2_2021_tpu.geometry import so3 as jso3
from orb_slam2_2021_tpu_torch.geometry import camera as tcam
from orb_slam2_2021_tpu_torch.geometry import se3 as tse3
from orb_slam2_2021_tpu_torch.geometry import so3 as tso3

TOL = 1e-6


def _close(port, ref, tol=TOL):
    port = port.numpy() if isinstance(port, torch.Tensor) else np.asarray(port)
    ref = np.asarray(ref)
    assert port.shape == ref.shape and port.dtype == ref.dtype, (port.shape, ref.shape, port.dtype, ref.dtype)
    err = np.abs(port.astype(np.float64) - ref).max() if port.size else 0.0
    assert err <= tol * max(1.0, np.abs(ref).max()), err


def _rotations(rng, n):
    """Rotations from axis-angles: generic, below the small-angle switch,
    zero, and within 1e-3 rad of pi."""
    axes = rng.normal(size=(n, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.concatenate([rng.uniform(0.01, 3.0, n - 8), [0.0, 1e-7, 5e-5, 2e-4],
                             np.pi - np.array([1e-3, 1e-4, 0.05, 0.0])])
    w = (axes * angles[:, None]).astype(np.float32)
    return np.array(jso3.so3_exp(jnp.asarray(w))), w


@pytest.fixture
def poses():
    rng = np.random.default_rng(0)
    R, _ = _rotations(rng, 40)
    t = rng.normal(size=(40, 3)).astype(np.float32)
    return R, t


def test_se3_log_matches_jax(poses):
    R, t = poses
    ref = np.asarray(jse3.se3_log(jnp.asarray(R), jnp.asarray(t)))
    port = tse3.se3_log(torch.from_numpy(R), torch.from_numpy(t))
    _close(port, ref)
    # the round trip through the port's exp
    Rb, tb = tse3.se3_exp(port)
    _close(Rb, R, 1e-5)


def test_se3_log_small_angle_and_near_pi():
    rng = np.random.default_rng(1)
    for angle in (0.0, 1e-9, 3e-5, 9e-5, np.pi - 1e-3, np.pi - 1e-5):
        w = (np.array([0.3, -0.5, 0.8]) / np.linalg.norm([0.3, -0.5, 0.8]) * angle).astype(np.float32)
        R = np.array(jso3.so3_exp(jnp.asarray(w)))[None]
        t = rng.normal(size=(1, 3)).astype(np.float32)
        ref = np.asarray(jse3.se3_log(jnp.asarray(R), jnp.asarray(t)))
        _close(tse3.se3_log(torch.from_numpy(R), torch.from_numpy(t)), ref)


def test_se3_group_helpers_match_jax(poses):
    R, t = poses
    Rt, tt = torch.from_numpy(R), torch.from_numpy(t)
    Rj, tj = jnp.asarray(R), jnp.asarray(t)
    for port, ref in zip(tse3.se3_inverse(Rt, tt), jse3.se3_inverse(Rj, tj)):
        _close(port, ref)
    x = np.random.default_rng(2).normal(size=(40, 3)).astype(np.float32)
    _close(tse3.se3_apply(Rt, tt, torch.from_numpy(x)), jse3.se3_apply(Rj, tj, jnp.asarray(x)))
    # one pose applied to many points (broadcast over the leading dims)
    xs = np.random.default_rng(3).normal(size=(7, 3)).astype(np.float32)
    _close(tse3.se3_apply(Rt[0], tt[0], torch.from_numpy(xs)), jse3.se3_apply(Rj[0], tj[0], jnp.asarray(xs)))
    T = tse3.mat44(Rt, tt)
    _close(T, jse3.mat44(Rj, tj), 0.0)
    _close(tse3.mat44(Rt[3], tt[3]), jse3.mat44(Rj[3], tj[3]), 0.0)
    for port, ref in zip(tse3.from_mat44(T), jse3.from_mat44(jse3.mat44(Rj, tj))):
        _close(port, ref, 0.0)
    for shape in ((), (4,), (2, 3)):
        for port, ref in zip(tse3.se3_identity(shape), jse3.se3_identity(shape)):
            _close(port, ref, 0.0)
    Rf, tf = tse3.se3_from_Rt(R, t)
    assert isinstance(Rf, torch.Tensor) and torch.equal(Rf, Rt) and torch.equal(tf, tt)
    assert tse3.se3_identity((2,), dtype=torch.float64)[0].dtype == torch.float64


def test_quat_to_rot_matches_jax():
    rng = np.random.default_rng(4)
    R, _ = _rotations(rng, 30)
    q = np.array(jso3.rot_to_quat(jnp.asarray(R)))
    q_scaled = (q * rng.uniform(0.5, 2.0, (len(q), 1))).astype(np.float32)  # normalized inside
    for quat in (q, q_scaled, rng.normal(size=(5, 2, 4)).astype(np.float32)):
        _close(tso3.quat_to_rot(torch.from_numpy(quat)), jso3.quat_to_rot(jnp.asarray(quat)))
    # the port's own rot_to_quat round-trips
    _close(tso3.quat_to_rot(tso3.rot_to_quat(torch.from_numpy(R))), R, 1e-5)


def test_camera_baseline_and_backproject_match_jax():
    args = (718.856, 718.856, 607.1928, 185.2157, 386.1448, 1241, 376)
    jc, tc = jcam.PinholeCamera.create(*args), tcam.PinholeCamera.create(*args)
    assert isinstance(tc.baseline, float) and tc.baseline == float(np.asarray(jc.baseline))
    rng = np.random.default_rng(5)
    uv = rng.uniform(0, 1241, (3, 50, 2)).astype(np.float32)
    z = rng.uniform(0.5, 40.0, (3, 50)).astype(np.float32)
    port = tcam.backproject(tc, torch.from_numpy(uv), torch.from_numpy(z))
    _close(port, jcam.backproject(jc, jnp.asarray(uv), jnp.asarray(z)))
    # projection undoes it
    uv_back, _ = tcam.project_mono(tc, port)
    assert np.abs(uv_back.numpy() - uv).max() < 1e-3
