"""The PyTorch port's monocular two-view bootstrap against the JAX reference
on the CPU, on the three scenes of tests/test_two_view.py (general, planar,
no parallax), with the reference's own minimal sets injected: identical
`ok`, `used_h` and `good`, R within 1e-4, t within 1e-4 (unit norm) and the
good points within 1e-3 of their distance, with the port's eigenproblems in
float64 (its default). With them in float32, the reference's precision, the
decisions must still be identical; R then moves by up to 7.3e-4 on the
general scene (torch's float32 9x9 eigensolver is less accurate there than
the reference's: the port's float64 solve lands within 7.2e-6 of the
reference)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_2021_tpu.solvers.two_view import make_two_view_init
from orb_slam2_2021_tpu_torch.solvers import two_view
from test_two_view import CX, CY, FX, FY, make_pair

torch.set_num_threads(1)

N_HYPS = 256


@jax.jit
def _choice(keys, probs):
    return jax.vmap(lambda k: jax.random.choice(k, probs.shape[0], shape=(8,), replace=False, p=probs))(keys)


def reference_samples(key, valid, n_hyps=N_HYPS):
    """The minimal sets the reference draws inside two_view_init."""
    probs = jnp.asarray(valid, jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    return np.asarray(_choice(jax.random.split(key, n_hyps), probs))


SCENES = {  # name: (make_pair kwargs, PRNG key of the reference's test)
    "general": ({"planar": False}, 0),
    "planar": ({"planar": True}, 1),
    "no_parallax": ({"baseline": 0.0, "noise": 0.1}, 2),
}


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_two_view_matches_reference(scene, monkeypatch):
    kwargs, seed = SCENES[scene]
    p1, p2, valid, *_ = make_pair(np.random.default_rng(0), **kwargs)
    key = jax.random.PRNGKey(seed)
    ref = make_two_view_init(N_HYPS)(key, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(valid),
                                     FX, FY, CX, CY)
    idx = torch.from_numpy(reference_samples(key, valid).astype(np.int64))
    args = (torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(valid), FX, FY, CX, CY)
    got = two_view.two_view_init(idx, *args)
    monkeypatch.setattr(two_view, "EIG_DTYPE", torch.float32)
    got32 = two_view.two_view_init(idx, *args)

    r_ok, r_h, r_good = bool(ref.ok), bool(ref.used_h), np.asarray(ref.good)
    assert (bool(got.ok), bool(got.used_h)) == (r_ok, r_h)
    assert np.array_equal(got.good.numpy(), r_good)
    assert (bool(got32.ok), bool(got32.used_h)) == (r_ok, r_h)
    assert np.array_equal(got32.good.numpy(), r_good)
    if scene == "general":
        assert r_ok and r_good.sum() > 100
    if scene == "planar":
        assert r_h
    if scene == "no_parallax":
        assert not r_ok
    if r_ok:
        assert np.abs(got.R.numpy() - np.asarray(ref.R)).max() < 1e-4, "R: tolerance 1e-4"
        assert np.abs(got.t.numpy() - np.asarray(ref.t)).max() < 1e-4, "t: tolerance 1e-4"
        X, Xr = got.points.numpy()[r_good], np.asarray(ref.points)[r_good]
        rel = np.linalg.norm(X - Xr, axis=1) / np.linalg.norm(Xr, axis=1)
        assert rel.max() < 1e-3, f"points: {rel.max():.2e} of their distance (tolerance 1e-3)"
