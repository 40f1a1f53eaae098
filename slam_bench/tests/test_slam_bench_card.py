"""Tests of the comparison that need a CUDA card; they skip without one.

The control: the reference put in the program's place and computed in the
nearest precision below the configuration's (TF32 where the package pins
float32 with TF32 off) must fail the frame-build comparison, while the
reference computed twice as stated agrees exactly. At half the KITTI
resolution, on three seeds.

    python -m pytest -q slam_bench/tests/test_slam_bench_card.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from slam_bench import harness
from slam_bench.gen.world import WallWorld, pixel_rays, render, trajectory
from slam_bench.reference import checks
from slam_bench.reference.settings import settings_from_yaml
from slam_bench.faults import half_size_yaml


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the control is a TF32 path, which the CPU does not have")
    return torch.device("cuda")


def _frames(cell, settings, seed, n, dev):
    poses = trajectory(cell.traffic, n)
    rays = pixel_rays(settings, dev, settings.dist_coef)
    world = WallWorld(cell.traffic, settings, seed, poses, rays, settings.bf / settings.fx, dev)
    return render(world, poses, rays, cell.sensor, settings.bf / settings.fx, settings.depth_map_factor)


@pytest.mark.parametrize("cell_name", ["kitti00_stereo.drive", "tum_fr1_rgbd.handheld"])
@pytest.mark.parametrize("seed", [101, 2 ** 31 + 5, 7])
def test_control_fails_the_frame_build_comparison(cuda_device, tmp_path, cell_name, seed):
    cell = harness.resolve_cell(cell_name)
    path = str(tmp_path / "half.yaml")
    half_size_yaml(cell.yaml_path, path)
    cell = dataclasses.replace(cell, yaml_path=path)
    s = settings_from_yaml(path)
    imgs, depth = _frames(cell, s, seed, 3, cuda_device)
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        for j in range(3):
            d = None if depth is None else depth[j]
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
            a = harness.reference_frame(cell.sensor, s, imgs[j], d, cuda_device)
            b = harness.reference_frame(cell.sensor, s, imgs[j], d, cuda_device)
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            c = harness.reference_frame(cell.sensor, s, imgs[j], d, cuda_device)
            assert checks.feature_diff(a, b) == 0.0
            assert checks.feature_diff(c, a) > cell.limits["feat_diff"], j
            assert np.asarray(a["valid"]).sum() > 0
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
