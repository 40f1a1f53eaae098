"""Occupancy grid of the PyTorch port held against the JAX reference:
`raycast_update` counters on seeded rays (including rays whose samples land
on .5 cell boundaries, where the ray fractions must be the reference's
float32 values bit for bit), rendering, and `GridMapper` over the same
keyframes."""

import numpy as np
import torch

import jax.numpy as jnp

from orb_slam2_2021_tpu.config import GridMapConfig, synthetic_config
from orb_slam2_2021_tpu.gridmap import grid as jgrid
from orb_slam2_2021_tpu_torch.gridmap import grid as tgrid

from test_torch_ba import synthetic_map

torch.set_num_threads(1)


def _rays(rng, n=300, size=64):
    cam = np.array([20.0, 24.0], np.float32)
    pts = rng.uniform(0, size, (n, 2)).astype(np.float32)
    # samples on .5 boundaries: cam + d * i/255 with d = 127.5 or 63.75 ...
    pts[:8] = cam + np.array([[127.5, 0], [0, 127.5], [63.75, 31.875], [-12.75, 25.5],
                              [255, 0], [-20.5, 40.5], [0.5, 0.5], [-127.5, -12.75]], np.float32)
    valid = rng.random(n) < 0.9
    return cam, pts, valid


def test_raycast_update_identical():
    rng = np.random.default_rng(0)
    H, W = 96, 160
    vj = jnp.zeros((H, W), jnp.int32)
    oj = jnp.zeros((H, W), jnp.int32)
    vt = torch.zeros((H, W), dtype=torch.int32)
    ot = torch.zeros((H, W), dtype=torch.int32)
    for _ in range(3):  # accumulate several keyframes' rays
        cam, pts, valid = _rays(rng)
        vj, oj = jgrid.raycast_update(vj, oj, jnp.asarray(cam), jnp.asarray(pts), jnp.asarray(valid))
        tgrid.raycast_update(vt, ot, torch.from_numpy(cam), torch.from_numpy(pts),
                             torch.from_numpy(valid))
    assert np.array_equal(vt.numpy(), np.asarray(vj)), "visit counters: identical"
    assert np.array_equal(ot.numpy(), np.asarray(oj)), "occupied counters: identical"
    assert int(vt.sum()) > 1000
    cfg = GridMapConfig()
    assert np.array_equal(tgrid.render_grid(vt, ot, cfg), jgrid.render_grid(vj, oj, cfg))


def test_ray_fractions_are_the_references():
    assert np.array_equal(tgrid._FRACTIONS, np.asarray(jnp.linspace(0.0, 1.0, tgrid.RAY_STEPS)))


def test_grid_mapper_identical():
    cfg = synthetic_config(width=320, height=240)
    m = synthetic_map(np.random.default_rng(3), cfg, n_kf=4, n_pts=600)
    ref = jgrid.GridMapper(cfg, m)
    port = tgrid.GridMapper(cfg, m, "cpu")
    ref.process_new()
    port.process_new()
    assert port.processed == ref.processed == [0, 1, 2, 3]
    g_r, g_p = ref.occupancy_grid(), port.occupancy_grid()
    assert np.array_equal(g_p.data, g_r.data), "occupancy grid: identical"
    assert (g_p.data == 100).sum() > 50 and (g_p.data == 0).sum() > 100
    assert (g_p.resolution, g_p.origin_x, g_p.origin_z) == (g_r.resolution, g_r.origin_x, g_r.origin_z)
    # a replay (loop closure or reset) rebuilds the same grid
    port.process_new(loop_closed=True)
    assert np.array_equal(port.occupancy_grid().data, g_r.data)
    assert np.array_equal(port.point_cloud(), ref.point_cloud())
