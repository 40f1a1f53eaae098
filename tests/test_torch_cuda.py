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


# ---------------------------------------------------------------------------
# place recognition and loop closing: CUDA against the CPU path, with the
# same RANSAC samples on both devices
# ---------------------------------------------------------------------------
def test_vocab_transform_on_cuda_matches_cpu(cuda_device):
    from orb_slam2_2021_tpu_torch.place.bundle import PlaceRecognition

    pr = PlaceRecognition.load_default()
    rng = np.random.default_rng(8)
    desc = _descs(rng, 2000, "cpu")
    valid = torch.from_numpy(rng.random(2000) < 0.95)
    got = pr.transform(desc.to(cuda_device), valid.to(cuda_device)).cpu()
    assert torch.equal(got, pr.transform(desc, valid)), "words: tolerance 0"


def _sim3_matches(rng, n=400):
    ang = np.deg2rad(9.0)
    R12 = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    x2 = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 12, n)], 1)
    x1 = x2 @ R12.T + np.array([0.4, -0.1, 0.3])
    bad = rng.random(n) < 0.25
    x1[bad] += rng.normal(0, 1.0, (bad.sum(), 3))

    def proj(x):
        return np.stack([400 * x[:, 0] / x[:, 2] + 620, 400 * x[:, 1] / x[:, 2] + 188], 1)

    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return (f(x1), f(x2), f(proj(x1) + rng.normal(0, 0.4, (n, 2))), f(proj(x2) + rng.normal(0, 0.4, (n, 2))),
            f(np.ones(n)), f(np.full(n, 1.44)), torch.ones(n, dtype=torch.bool))


def test_sim3_ransac_and_refine_on_cuda_match_cpu(cuda_device):
    """Same 128 minimal sets on both devices: inlier masks identical, s, R
    within 1e-5, t within 1e-4 m, before and after the refine."""
    from orb_slam2_2021_tpu_torch.optim.sim3_opt import optimize_sim3_relative
    from orb_slam2_2021_tpu_torch.solvers.horn_sim3 import sample_indices, sim3_ransac

    args = _sim3_matches(np.random.default_rng(9))
    idx = sample_indices(np.ones(400, bool), 3, 128, torch.Generator().manual_seed(2000))
    out = {}
    for d in ("cpu", cuda_device):
        a = [x.to(d) for x in args]
        s, R, t, inl, n = sim3_ransac(idx.to(d), *a, 400.0, 400.0, 620.0, 188.0, True)
        r = optimize_sim3_relative(s, R, t, a[0], a[1], a[2], a[3], 1.0 / a[4], 1.0 / a[5], a[6],
                                   400.0, 400.0, 620.0, 188.0, True)
        out[d] = [x.cpu() for x in (s, R, t, inl) + r[:4]]
    for i, (c, g) in enumerate(zip(out["cpu"], out[cuda_device])):
        if c.dtype == torch.bool:
            assert torch.equal(c, g), "inlier mask: identical"
        else:
            assert (c - g).abs().max() < (1e-4 if i % 4 == 2 else 1e-5)


def test_epnp_ransac_on_cuda_matches_cpu(cuda_device):
    """Same 256 minimal sets on both devices: inlier masks identical, R
    within 1e-4, t within 1 cm."""
    from orb_slam2_2021_tpu_torch.solvers.epnp import epnp_ransac
    from orb_slam2_2021_tpu_torch.solvers.horn_sim3 import sample_indices

    rng = np.random.default_rng(10)
    n = 2000
    xw = np.stack([rng.uniform(-4, 4, n), rng.uniform(-2, 2, n), rng.uniform(5, 15, n)], 1)
    a = np.deg2rad(4.0)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    xc = xw @ R.T + np.array([0.1, 0.0, -0.3])
    uv = np.stack([700 * xc[:, 0] / xc[:, 2] + 620, 700 * xc[:, 1] / xc[:, 2] + 188], 1)
    uv += rng.normal(0, 0.5, uv.shape)
    bad = rng.random(n) < 0.3
    uv[bad] += rng.uniform(-40, 40, (bad.sum(), 2))
    valid = rng.random(n) < 0.4
    args = [torch.from_numpy(np.asarray(x, np.float32)) for x in (xw, uv, np.ones(n))]
    args.append(torch.from_numpy(valid))
    idx = sample_indices(valid, 6, 256, torch.Generator().manual_seed(21))
    out = {}
    for d in ("cpu", cuda_device):
        res = epnp_ransac(idx.to(d), *[x.to(d) for x in args], 700.0, 700.0, 620.0, 188.0)
        out[d] = [x.cpu() for x in res]
    (Rc, tc, ic, nc), (Rg, tg, ig, ng) = out["cpu"], out[cuda_device]
    assert torch.equal(ic, ig) and int(nc) == int(ng) > 0.5 * valid.sum()
    assert (Rc - Rg).abs().max() < 1e-4 and (tc - tg).abs().max() < 1e-2


def _ring_pose_graph(rng, K=24, K_pad=32, E_pad=256):
    """Keyframes on a circle with accumulated drift; odometry edges, a few
    covisibility edges and one loop edge carrying the true relative pose."""
    from orb_slam2_2021_tpu_torch.geometry.sim3 import sim3_compose, sim3_exp, sim3_inverse
    from orb_slam2_2021_tpu_torch.optim.sim3_opt import PoseGraph

    ang = torch.linspace(0, 2 * np.pi * (K - 1) / K, K)
    xi = torch.zeros(K, 7)
    xi[:, 4] = ang
    xi[:, 0] = 3.0 * torch.cos(ang)
    xi[:, 2] = 3.0 * torch.sin(ang)
    s_gt, R_gt, t_gt = sim3_exp(xi)
    drift = torch.from_numpy(rng.normal(0, 0.01, (K, 7)).astype(np.float32)).cumsum(0)
    drift[:, 6] = 0
    s0, R0, t0 = sim3_compose(*sim3_exp(drift), s_gt, R_gt, t_gt)
    ei = list(range(K - 1)) + list(range(K - 3)) + [K - 1]
    ej = list(range(1, K)) + list(range(3, K)) + [0]
    E = len(ei)
    src = [(s0, R0, t0)] * (E - 1) + [(s_gt, R_gt, t_gt)]
    ms, mR, mt = [], [], []
    for e, (a, b) in enumerate(zip(ei, ej)):
        S = src[e]
        r = sim3_compose(S[0][a], S[1][a], S[2][a], *sim3_inverse(S[0][b], S[1][b], S[2][b]))
        ms.append(r[0]), mR.append(r[1]), mt.append(r[2])

    def pad(x, n, fill):
        out = fill(n)
        out[: len(x)] = x
        return out

    eye = lambda n: torch.eye(3).repeat(n, 1, 1)  # noqa: E731
    return PoseGraph(
        s=pad(s0, K_pad, torch.ones), R=pad(R0, K_pad, eye), t=pad(t0, K_pad, lambda n: torch.zeros(n, 3)),
        edge_i=pad(torch.tensor(ei), E_pad, lambda n: torch.zeros(n, dtype=torch.int64)),
        edge_j=pad(torch.tensor(ej), E_pad, lambda n: torch.zeros(n, dtype=torch.int64)),
        m_s=pad(torch.stack(ms), E_pad, torch.ones), m_R=pad(torch.stack(mR), E_pad, eye),
        m_t=pad(torch.stack(mt), E_pad, lambda n: torch.zeros(n, 3)),
        weight=pad(torch.ones(E), E_pad, torch.zeros),
        fixed=pad(torch.arange(K) == 0, K_pad, lambda n: torch.ones(n, dtype=torch.bool)),
    )


def test_essential_graph_on_cuda_matches_cpu(cuda_device):
    """20 LM x 40 PCG iterations on both devices: R within 1e-4, t within
    1e-3 m; the card repeats its own solve exactly."""
    from orb_slam2_2021_tpu_torch.optim.sim3_opt import essential_graph_solve

    g = _ring_pose_graph(np.random.default_rng(11))
    sc, Rc, tc = essential_graph_solve(g, fix_scale=True)
    gg = type(g)(*(x.to(cuda_device) for x in g))
    first = essential_graph_solve(gg, fix_scale=True)
    again = essential_graph_solve(gg, fix_scale=True)
    assert all(torch.equal(a, b) for a, b in zip(first, again)), "repeatable on the card"
    sg, Rg, tg = (x.cpu() for x in first)
    assert (Rc - Rg).abs().max() < 1e-4 and (tc - tg).abs().max() < 1e-3
    assert (tc - g.t).abs().max() > 0.01, "the solve moved the drifted keyframes"


def test_flat_gba_on_cuda_matches_cpu_and_repeats(cuda_device):
    """Flat-layout global BA iterations (the solver above 128 cameras): the
    card repeats its solve exactly (no float atomics) and agrees with the
    CPU within float32 summation-order noise."""
    from orb_slam2_2021_tpu.config import OptimConfig
    from orb_slam2_2021_tpu_torch.geometry.camera import PinholeCamera
    from orb_slam2_2021_tpu_torch.optim.ba import BAProblem
    from orb_slam2_2021_tpu_torch.optim.ba_cg import flat_index, gba_iteration

    cfg = OptimConfig()
    cam = PinholeCamera.create(400.0, 400.0, 320.0, 240.0, bf=80.0, width=640, height=480)
    prob = _pq_problem(np.random.default_rng(12))
    perm = torch.from_numpy(np.random.default_rng(13).permutation(prob.obs_cam.shape[0]))
    prob = prob._replace(**{f: getattr(prob, f)[perm] for f in
                            ("obs_cam", "obs_pt", "obs_uvr", "obs_inv_sigma2", "obs_valid")})

    def solve(d):
        p = BAProblem(*(x.to(d) for x in prob))
        index = flat_index(p)
        R, t, xw, lam = p.R, p.t, p.xw, torch.tensor(cfg.lm_lambda_init, device=d)
        for _ in range(5):
            R, t, xw, lam, _ = gba_iteration(cam, p, index, R, t, xw, lam, p.obs_valid.float(), True, cfg)
        return [x.cpu() for x in (R, t, xw)]

    cpu, g1, g2 = solve("cpu"), solve(cuda_device), solve(cuda_device)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2)), "repeatable on the card"
    assert (cpu[0] - g1[0]).abs().max() < 1e-5 and (cpu[1] - g1[1]).abs().max() < 1e-4
    assert (cpu[2] - g1[2]).abs().max() < 1e-3
