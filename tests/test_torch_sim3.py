"""Sim(3) geometry, Horn alignment, Sim3 RANSAC and the relative Sim3
refine of the PyTorch port, held against the JAX reference on the CPU with
identical numpy inputs made from a seed.

RANSAC: the reference draws its minimal sets with JAX's threefry keys; the
port's solver takes the sets as an input, so the test feeds it exactly the
sets the reference drew and requires the same inlier mask.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orb_slam2_2021_tpu.geometry import sim3 as jsim3
from orb_slam2_2021_tpu.geometry.so3 import so3_log as j_so3_log
from orb_slam2_2021_tpu.solvers.horn_sim3 import horn_align as j_horn, sim3_ransac as j_ransac
from orb_slam2_2021_tpu.optim.sim3_opt import optimize_sim3_relative as j_refine
from orb_slam2_2021_tpu_torch.geometry import sim3 as tsim3
from orb_slam2_2021_tpu_torch.geometry.so3 import so3_exp, so3_log
from orb_slam2_2021_tpu_torch.solvers.horn_sim3 import horn_align, sample_indices, sim3_ransac
from orb_slam2_2021_tpu_torch.optim.sim3_opt import optimize_sim3_relative

torch.set_num_threads(1)
T = torch.from_numpy
FX, FY, CX, CY = 400.0, 400.0, 160.0, 120.0


def _twists(rng, n=64):
    """Seeded twists including theta -> 0, sigma -> 0 and theta near pi."""
    xi = rng.normal(0, 0.6, (n, 7)).astype(np.float32)
    xi[:8, 3:6] *= 1e-7          # theta -> 0
    xi[8:16, 6] *= 1e-7          # sigma -> 0
    xi[16:20, 3:6] = 0.0
    xi[16:20, 6] = 0.0
    ax = rng.normal(size=(4, 3))
    xi[20:24, 3:6] = (3.05 * ax / np.linalg.norm(ax, axis=1, keepdims=True)).astype(np.float32)
    return xi


def _rel(a, b):
    return float(np.max(np.abs(a - b) / (1.0 + np.abs(b))))


def test_so3_log_matches_reference():
    rng = np.random.default_rng(0)
    w = _twists(rng)[:, 3:6]
    R = so3_exp(T(w)).numpy()
    got = so3_log(T(R)).numpy()
    ref = np.asarray(j_so3_log(jnp.asarray(R)))
    assert _rel(got, ref) < 1e-6, "so3_log: tolerance 1e-6 relative"


def test_sim3_maps_match_reference():
    """exp, log, compose, inverse and apply on seeded twists, tolerance 1e-6
    relative (|a - b| / (1 + |b|))."""
    rng = np.random.default_rng(1)
    xi = _twists(rng)
    s, R, t = tsim3.sim3_exp(T(xi))
    js, jR, jt = jsim3.sim3_exp(jnp.asarray(xi))
    for a, b in ((s, js), (R, jR), (t, jt)):
        assert _rel(a.numpy(), np.asarray(b)) < 1e-6, "sim3_exp"
    log = tsim3.sim3_log(s, R, t).numpy()
    jlog = np.asarray(jsim3.sim3_log(js, jR, jt))
    assert _rel(log, jlog) < 1e-6, "sim3_log"
    x = rng.normal(size=(64, 3)).astype(np.float32)
    perm = rng.permutation(64)
    comp = tsim3.sim3_compose(s, R, t, s[perm], R[perm], t[perm])
    jcomp = jsim3.sim3_compose(js, jR, jt, js[perm], jR[perm], jt[perm])
    inv = tsim3.sim3_inverse(s, R, t)
    jinv = jsim3.sim3_inverse(js, jR, jt)
    for a, b in zip(comp + inv, jcomp + jinv):
        assert _rel(a.numpy(), np.asarray(b)) < 1e-6, "compose / inverse"
    app = tsim3.sim3_apply(s, R, t, T(x)).numpy()
    japp = np.asarray(jsim3.sim3_apply(js, jR, jt, jnp.asarray(x)))
    assert _rel(app, japp) < 1e-6, "sim3_apply"
    s0, R0, t0 = tsim3.sim3_identity((3,))
    assert torch.equal(s0, torch.ones(3)) and torch.equal(R0, torch.eye(3).expand(3, 3, 3))


def _matches(rng, n=240, outliers=0.25, noise=0.4, scale=1.0):
    """Matched points in two camera frames related by a known S12, their
    noisy pixels, per-match sigma^2 and a validity mask."""
    ang = np.deg2rad(9.0)
    R12 = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    t12 = np.array([0.4, -0.1, 0.3])
    x2 = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 12, n)], 1)
    x1 = scale * x2 @ R12.T + t12
    bad = rng.random(n) < outliers
    x1[bad] += rng.normal(0, 1.0, (bad.sum(), 3))

    def proj(x):
        return np.stack([FX * x[:, 0] / x[:, 2] + CX, FY * x[:, 1] / x[:, 2] + CY], 1)

    uv1 = proj(x1) + rng.normal(0, noise, (n, 2))
    uv2 = proj(x2) + rng.normal(0, noise, (n, 2))
    s2_1 = 1.2 ** (2 * rng.integers(0, 4, n))
    s2_2 = 1.2 ** (2 * rng.integers(0, 4, n))
    valid = rng.random(n) < 0.95
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return f(x1), f(x2), f(uv1), f(uv2), f(s2_1), f(s2_2), valid


def test_horn_align_matches_reference():
    rng = np.random.default_rng(2)
    x1, x2, *_ = _matches(rng, n=40, outliers=0.0)
    for fix in (True, False):
        s, R, t, ok = horn_align(T(x1), T(x2), fix)
        js, jR, jt = j_horn(jnp.asarray(x1), jnp.asarray(x2), fix)
        assert bool(ok)
        assert abs(float(s) - float(js)) < 1e-5, "s: tolerance 1e-5"
        assert np.abs(R.numpy() - np.asarray(jR)).max() < 1e-5, "R: tolerance 1e-5"
        assert np.abs(t.numpy() - np.asarray(jt)).max() < 1e-4, "t: tolerance 1e-4 m"


def reference_samples(key, valid, m, n_hyps):
    """The minimal sets the reference's RANSAC draws from `key`."""
    probs = jnp.asarray(valid, jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    n = len(valid)
    idx = jax.vmap(lambda k: jax.random.choice(k, n, shape=(m,), replace=False, p=probs))(
        jax.random.split(key, n_hyps))
    return torch.from_numpy(np.asarray(idx).astype(np.int64))


@pytest.mark.parametrize("fix_scale", [True, False])
def test_sim3_ransac_with_reference_samples(fix_scale):
    """Inlier mask identical; s, R within 1e-5, t within 1e-4 m."""
    rng = np.random.default_rng(3)
    args = _matches(rng, scale=1.0 if fix_scale else 1.15)
    key = jax.random.PRNGKey(2000)
    idx = reference_samples(key, args[-1], 3, 128)
    js, jR, jt, jinl, jn = j_ransac(key, *map(jnp.asarray, args), FX, FY, CX, CY,
                                    fix_scale=fix_scale, n_hyps=128)
    s, R, t, inl, n = sim3_ransac(idx, *map(T, args), FX, FY, CX, CY, fix_scale)
    assert np.array_equal(inl.numpy(), np.asarray(jinl)) and int(n) == int(jn) > 100
    assert abs(float(s) - float(js)) < 1e-5
    assert np.abs(R.numpy() - np.asarray(jR)).max() < 1e-5
    assert np.abs(t.numpy() - np.asarray(jt)).max() < 1e-4


def test_sample_indices_are_distinct_valid_and_seeded():
    valid = np.zeros(300, bool)
    valid[::3] = True
    a = sample_indices(valid, 6, 256, torch.Generator().manual_seed(17))
    b = sample_indices(valid, 6, 256, torch.Generator().manual_seed(17))
    assert torch.equal(a, b) and a.shape == (256, 6)
    assert valid[a.numpy()].all()
    assert all(len(set(row)) == 6 for row in a.tolist())


@pytest.mark.parametrize("fix_scale", [True, False])
def test_optimize_sim3_relative_matches_reference(fix_scale):
    """From a perturbed start: inlier mask identical, s and R within 1e-5,
    t within 1e-4 m."""
    rng = np.random.default_rng(4)
    x1, x2, uv1, uv2, s2_1, s2_2, valid = _matches(rng, n=160, scale=1.0 if fix_scale else 1.1)
    ang = np.deg2rad(8.8)
    R0 = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]], np.float32)
    t0 = np.array([0.41, -0.09, 0.31], np.float32)
    s0 = np.float32(1.0 if fix_scale else 1.09)
    args = (x1, x2, uv1, uv2, 1.0 / s2_1, 1.0 / s2_2, valid)
    js, jR, jt, jinl, jn = j_refine(jnp.float32(s0), jnp.asarray(R0), jnp.asarray(t0),
                                    *map(jnp.asarray, args), FX, FY, CX, CY, fix_scale=fix_scale)
    s, R, t, inl, n = optimize_sim3_relative(torch.tensor(s0), T(R0), T(t0), *map(T, args),
                                             FX, FY, CX, CY, fix_scale)
    assert np.array_equal(inl.numpy(), np.asarray(jinl)) and int(n) == int(jn) > 80
    assert abs(float(s) - float(js)) < 1e-5
    assert np.abs(R.numpy() - np.asarray(jR)).max() < 1e-5
    assert np.abs(t.numpy() - np.asarray(jt)).max() < 1e-4
