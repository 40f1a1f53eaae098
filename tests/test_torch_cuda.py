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

SHAPES = [(1, 1), (127, 129), (200, 150), (257, 64), (2000, 2000), (4096, 2000), (0, 5),
          (2000, 10 * 2000), (2000, 8 * 2000)]  # the last two: local mapping at KITTI width


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


def test_mapping_hamming_batched_matches_plain(cuda_device):
    """Triangulation's call: one keyframe [N, 8] against T stacked
    keyframes, one launch, viewed as [T, N, M]."""
    from orb_slam2_2021_tpu_torch.pipeline.mapping_steps import _hamming_batched

    rng = np.random.default_rng(5)
    a, b = _descs(rng, 2000, cuda_device), _descs(rng, 10 * 2000, cuda_device).view(10, 2000, 8)
    launches = tham.HAMMING_KERNEL.launches
    out = _hamming_batched(a, b)
    assert tham.HAMMING_KERNEL.launches == launches + 1
    ref = torch.stack([tham.hamming_matrix_plain(a, b[i]) for i in range(10)])
    assert torch.equal(out, ref), "kernel vs plain: tolerance 0"


def test_raycast_update_on_cuda_matches_cpu(cuda_device):
    from orb_slam2_2021_tpu_torch.gridmap.grid import raycast_update

    rng = np.random.default_rng(6)
    counters = {d: [torch.zeros((512, 512), dtype=torch.int32, device=d) for _ in range(2)]
                for d in ("cpu", cuda_device)}
    for _ in range(4):
        cam = torch.from_numpy(rng.uniform(200, 300, 2).astype(np.float32))
        pts = torch.from_numpy(rng.uniform(0, 512, (2048, 2)).astype(np.float32))
        valid = torch.from_numpy(rng.random(2048) < 0.9)
        for d, (visit, occ) in counters.items():
            raycast_update(visit, occ, cam.to(d), pts.to(d), valid.to(d))
    for c, g in zip(counters["cpu"], counters[cuda_device]):
        assert torch.equal(c, g.cpu()), "integer counters: tolerance 0"


def _pq_problem(rng, n_cams=8, n_pts=400, q=4, noise=0.3):
    """Cameras along x looking at a point cloud, PQ layout, perturbed."""
    from orb_slam2_2021_tpu_torch.optim.ba import BAProblem

    C, P, O = n_cams, n_pts, n_pts * q
    t_gt = np.zeros((C, 3), np.float32)
    t_gt[:, 0] = -0.5 * np.arange(C)
    pts = np.stack([rng.uniform(-2, 2 + 0.5 * C, P), rng.uniform(-2, 2, P),
                    rng.uniform(6, 14, P)], 1).astype(np.float32)
    cam = np.stack([rng.choice(C, q, replace=False) for _ in range(P)]).reshape(-1)
    xc = pts.repeat(q, 0) + t_gt[cam]
    u = 400 * xc[:, 0] / xc[:, 2] + 320
    uvr = np.stack([u, 400 * xc[:, 1] / xc[:, 2] + 240, u - 80 / xc[:, 2]], 1)
    uvr = (uvr + rng.normal(0, noise, uvr.shape)).astype(np.float32)
    uvr[rng.random(O) < 0.3, 2] = -1.0
    uvr[rng.choice(O, 20, replace=False), :2] += 30.0
    t0 = t_gt + np.where(np.arange(C)[:, None] >= 2, rng.normal(0, 0.05, (C, 3)), 0).astype(np.float32)
    T = lambda a, dt=None: torch.from_numpy(np.asarray(a, dt))  # noqa: E731
    return BAProblem(
        R=T(np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))), t=T(t0),
        xw=T(pts + rng.normal(0, 0.05, pts.shape).astype(np.float32)),
        obs_cam=T(cam, np.int64), obs_pt=T(np.repeat(np.arange(P), q), np.int64), obs_uvr=T(uvr),
        obs_inv_sigma2=T(np.ones(O, np.float32)), obs_valid=T(np.ones(O, bool)),
        pt_obs=T(np.arange(O).reshape(P, q), np.int64), cam_free=T(np.arange(C) >= 2),
    )


def test_lm_chunk_on_cuda_matches_cpu(cuda_device):
    """5 Huber + 10 plain LM iterations on the card and on the CPU: the same
    inlier mask, states within float32 summation-order noise."""
    from orb_slam2_2021_tpu.config import OptimConfig
    from orb_slam2_2021_tpu_torch.geometry.camera import PinholeCamera
    from orb_slam2_2021_tpu_torch.optim.ba_cg import lm_chunk_pq

    cfg = OptimConfig()
    cam = PinholeCamera.create(400.0, 400.0, 320.0, 240.0, bf=80.0, width=640, height=480)
    prob = _pq_problem(np.random.default_rng(7))
    out = {}
    for d in ("cpu", cuda_device):
        p = type(prob)(*(x.to(d) for x in prob))
        lam = torch.tensor(cfg.lm_lambda_init, device=d)
        R, t, xw, lam, inl = lm_chunk_pq(cam, p, p.R, p.t, p.xw, lam, p.obs_valid.float(),
                                         True, cfg, cfg.local_ba_iters1)
        R, t, xw, lam, inl = lm_chunk_pq(cam, p, R, t, xw, lam, inl.float(), False,
                                         cfg, cfg.local_ba_iters2)
        out[d] = [x.cpu() for x in (R, t, xw, inl)]
    (Rc, tc, xc, ic), (Rg, tg, xg, ig) = out["cpu"], out[cuda_device]
    assert torch.equal(ic, ig), "inlier mask: identical"
    assert (Rc - Rg).abs().max() < 1e-5, "R: tolerance 1e-5"
    assert (tc - tg).abs().max() < 1e-4, "t: tolerance 1e-4 m"
    assert (xc - xg).abs().max() < 1e-3, "xw: tolerance 1 mm"
