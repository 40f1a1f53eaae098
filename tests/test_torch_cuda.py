"""Tests of the port that need a CUDA card; they skip without one.

This file imports no JAX, so it runs on a machine with a card and no JAX:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(`--noconftest` skips tests/conftest.py, which configures JAX.) The kernels
are held against their plain PyTorch versions, which the other
tests/test_torch_*.py files hold against the JAX reference on the CPU.
"""

import numpy as np
import pytest
import torch

from orb_slam2_2021_tpu.config import synthetic_config
from orb_slam2_2021_tpu.io.synthetic import SyntheticStereoWorld, forward_trajectory
from orb_slam2_2021_tpu_torch.ops import hamming as tham

SHAPES = [(1, 1), (127, 129), (200, 150), (257, 64), (2000, 2000), (4096, 2000), (0, 5)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


def _descs(rng, n, dev):
    words = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32).view(np.int32)
    return torch.from_numpy(words).to(dev)


@pytest.mark.parametrize("n,m", SHAPES)
def test_hamming_kernel_matches_plain(cuda_device, n, m):
    rng = np.random.default_rng(n + 7 * m)
    a, b = _descs(rng, n, cuda_device), _descs(rng, m, cuda_device)
    launches = tham.HAMMING_KERNEL.launches
    out = tham.hamming_matrix(a, b)
    torch.cuda.synchronize()
    assert out.dtype == torch.int16 and tuple(out.shape) == (n, m)
    assert torch.equal(out, tham.hamming_matrix_plain(a, b)), "kernel vs plain: tolerance 0"
    assert tham.HAMMING_KERNEL.launches == launches + (1 if n and m else 0)


def test_hamming_kernel_rejects_misaligned_rows(cuda_device):
    a = torch.zeros(8 * 9 + 1, dtype=torch.int32, device=cuda_device)[1:].view(9, 8)
    with pytest.raises(ValueError):
        tham.hamming_matrix(a, a)


def test_lane_on_cuda_matches_cpu(cuda_device):
    """Six 320x240 frames through the System on the card and on the CPU:
    same tracked flags and keyframe counts, poses within 1 mm / 1e-3."""
    from orb_slam2_2021_tpu_torch.pipeline.system import System

    cfg = synthetic_config(width=320, height=240)
    world = SyntheticStereoWorld(cfg, seed=3)
    gpu = System(cfg, enable_mapping=False, device=cuda_device)
    cpu = System(cfg, enable_mapping=False, device="cpu")
    tham.HAMMING_KERNEL.launches = 0
    for i, (R, t) in enumerate(forward_trajectory(6, step=0.12)):
        left, right = world.render(R, t)
        pg = gpu.track_stereo(left, right, timestamp=0.1 * i)
        pc = cpu.track_stereo(left, right, timestamp=0.1 * i)
        assert (pg is None) == (pc is None) and gpu.map.n_kf == cpu.map.n_kf
        if pg is not None:
            assert np.abs(pg[1] - pc[1]).max() < 1e-3, "t: tolerance 1 mm"
            assert np.abs(pg[0] - pc[0]).max() < 1e-3, "R: tolerance 1e-3"
    assert tham.HAMMING_KERNEL.launches > 0, "the lane ran the Hamming kernel"
