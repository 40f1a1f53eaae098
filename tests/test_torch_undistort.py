"""The PyTorch port's keypoint undistortion against the JAX reference on the
CPU: the forward lens model and its fixed-point inverse for a strong
synthetic lens and the freiburg1 lens, within 1e-4 px of the reference; zero
coefficients change nothing; the round trip stays below 0.01 px."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_2021_tpu.config import synthetic_config, tum_rgbd_config
from orb_slam2_2021_tpu.ops.undistort import distort_points as j_distort
from orb_slam2_2021_tpu.ops.undistort import undistort_points as j_undistort
from orb_slam2_2021_tpu_torch.ops.undistort import distort_points, undistort_points

torch.set_num_threads(1)

SYNTH_LENS = (0.25, -0.15, -0.002, 0.001, 0.0)  # tests/test_undistort.py
LENSES = {
    "synthetic": (synthetic_config(width=320, height=240), SYNTH_LENS),
    "freiburg1": (tum_rgbd_config("freiburg1"), tum_rgbd_config("freiburg1").dist_coef),
}


def _grid(cfg, seed):
    """A 24x18 grid across the image plus 200 seeded random points."""
    xs = np.linspace(10, cfg.width - 10, 24)
    ys = np.linspace(10, cfg.height - 10, 18)
    grid = np.stack(np.meshgrid(xs, ys), axis=-1).reshape(-1, 2)
    rng = np.random.default_rng(seed)
    rnd = np.stack([rng.uniform(0, cfg.width, 200), rng.uniform(0, cfg.height, 200)], 1)
    return np.concatenate([grid, rnd]).astype(np.float32)


@pytest.mark.parametrize("lens", sorted(LENSES))
def test_lens_model_matches_reference(lens):
    cfg, dist = LENSES[lens]
    xy = _grid(cfg, 0)
    k = (cfg.fx, cfg.fy, cfg.cx, cfg.cy, dist)
    xd_j = np.array(j_distort(jnp.asarray(xy), *k))
    xd_t = distort_points(torch.from_numpy(xy), *k).numpy()
    assert np.abs(xd_t - xd_j).max() < 1e-4, "distort: tolerance 1e-4 px"
    xu_j = np.asarray(j_undistort(jnp.asarray(xd_j), *k))
    xu_t = undistort_points(torch.from_numpy(xd_j), *k).numpy()
    assert np.abs(xu_t - xu_j).max() < 1e-4, "undistort: tolerance 1e-4 px"
    # the round trip, as the reference's own test
    xu = undistort_points(distort_points(torch.from_numpy(xy), *k), *k).numpy()
    grid = xy[: 24 * 18]
    assert np.abs(xu[: 24 * 18] - grid).max() < 0.01, "round trip: 0.01 px"
    assert np.abs(xd_t - xy).max() > 1.0, "the lens bends"


def test_zero_coefficients_are_a_no_op():
    cfg = synthetic_config(width=320, height=240)
    xy = torch.from_numpy(_grid(cfg, 1))
    k = (cfg.fx, cfg.fy, cfg.cx, cfg.cy, (0.0, 0.0, 0.0, 0.0, 0.0))
    assert torch.allclose(undistort_points(xy, *k), xy, atol=1e-4)
    assert torch.allclose(distort_points(xy, *k), xy, atol=1e-4)
