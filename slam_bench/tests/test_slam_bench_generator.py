"""The traffic generator: the same seed gives the same frames, another seed
other frames, and the world is wide enough for the longest window a cell
can have (51 s at the camera's rate, plus warm-up)."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from slam_bench import harness
from slam_bench.gen.world import WallWorld, pixel_rays, render, trajectory
from slam_bench.reference.settings import settings_from_yaml

MAX_SECONDS = 51
CELLS = [w for w in harness.load_json(harness.ROOT + "/BENCHMARK.json")["workloads"]]


def _small(s, scale=0.25):
    """The settings at a quarter of the resolution (same field of view)."""
    return SimpleNamespace(**{**vars(s), "fx": s.fx * scale, "fy": s.fy * scale, "cx": s.cx * scale,
                              "cy": s.cy * scale, "width": int(s.width * scale),
                              "height": int(s.height * scale)})


def _setup(cell_name, n_frames, seed, small=True):
    cell = harness.resolve_cell(cell_name)
    s = settings_from_yaml(cell.yaml_path)
    if small:
        s = _small(s)
    poses = trajectory(cell.traffic, n_frames)
    rays = pixel_rays(s, "cpu", s.dist_coef)
    world = WallWorld(cell.traffic, s, seed, poses, rays, s.bf / s.fx, "cpu")
    return cell, s, poses, rays, world


@pytest.mark.parametrize("cell", [c["name"] for c in CELLS])
def test_same_seed_same_frames(cell):
    c, s, poses, rays, w1 = _setup(cell, 4, 2 ** 31 + 12345)
    _, _, _, _, w2 = _setup(cell, 4, 2 ** 31 + 12345)
    _, _, _, _, w3 = _setup(cell, 4, 7)
    a = render(w1, poses, rays, c.sensor, s.bf / s.fx, s.depth_map_factor)
    b = render(w2, poses, rays, c.sensor, s.bf / s.fx, s.depth_map_factor)
    d = render(w3, poses, rays, c.sensor, s.bf / s.fx, s.depth_map_factor)
    assert np.array_equal(a[0], b[0]) and not np.array_equal(a[0], d[0])
    assert a[0].dtype == np.uint8 and a[0].std() > 20
    if c.sensor == "rgbd":
        assert a[1].dtype == np.uint16 and np.array_equal(a[1], b[1])
        z = a[1].astype(np.float64) / s.depth_map_factor
        assert c.traffic.z_min_m - 0.05 < z.min() and z.max() < c.traffic.z_max_m / np.cos(0.8)


@pytest.mark.parametrize("cell", [c["name"] for c in CELLS])
def test_world_outlasts_the_longest_window(cell):
    """Every ray of the first and last frame of a 51-s window at camera
    rate meets the wall inside the texture and the depth grid, at the
    configuration's own resolution."""
    c = harness.resolve_cell(cell)
    n = c.traffic.warmup_frames + int(np.ceil(MAX_SECONDS * c.camera_hz)) + 2
    c, s, poses, rays, w = _setup(cell, n, 5, small=False)
    for i in (0, n - 1):
        R = torch.from_numpy(poses[i, :3, :3].astype(np.float32))
        for off in ((0.0, s.bf / s.fx) if c.sensor == "stereo" else (0.0,)):
            centre = torch.from_numpy(poses[i, :3, 3].astype(np.float32)) + R[:, 0] * off
            dirs = torch.einsum("ij,hwj->hwi", R, rays)[None]
            lam, _ = w.trace(centre[None], dirs)
            px = centre[0] + lam * dirs[..., 0]
            py = centre[1] + lam * dirs[..., 1]
            tx, ty = (px - w.x0) * w.ppm, (py - w.y0) * w.ppm
            assert float(tx.min()) > 0 and float(tx.max()) < w.tex_w - 2, (i, off)
            assert float(ty.min()) > 0 and float(ty.max()) < w.tex_h - 2, (i, off)
            gh, gw = w.depth_grid.shape
            assert float((px - w.x0).max()) / w.cell < gw - 1 and float((py - w.y0).max()) / w.cell < gh - 1


def test_trajectory_starts_at_the_identity_and_dollies():
    c = harness.resolve_cell("kitti00_stereo.drive")
    T = trajectory(c.traffic, 5)
    assert np.allclose(T[0], np.eye(4))
    assert np.allclose(np.diff(T[:, 0, 3]), c.traffic.step_m) and np.allclose(T[:, 1:3, 3], 0)
    h = harness.resolve_cell("tum_fr1_rgbd.handheld").traffic
    T = trajectory(h, 121)
    yaw = np.degrees(np.arctan2(T[:, 0, 2], T[:, 0, 0]))
    assert yaw.max() == pytest.approx(h.yaw_deg, abs=0.05) and yaw.min() == pytest.approx(-h.yaw_deg, abs=0.05)
