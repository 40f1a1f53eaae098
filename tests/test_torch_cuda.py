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

from chip_smoke import hamming_inputs  # edge-case descriptors and masks
from chip_smoke import (MAJORITY_SIZES, POSE_CASES, POSE_R_TOL, POSE_T_TOL, SEED_DRAW_CASES,
                        counted_rows, majority_case, pose_inputs, seed_draw_case, seed_draw_uniforms)
from orb_slam2_2021_tpu_torch.config import synthetic_config
from orb_slam2_2021_tpu_torch.io.synthetic import SyntheticStereoWorld, forward_trajectory
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
    tham.HAMMING_KERNEL.launches = tham.HAMMING_BEST2_KERNEL.launches = 0
    for i, (R, t) in enumerate(forward_trajectory(6, step=0.12)):
        left, right = world.render(R, t)
        pg = gpu.track_stereo(left, right, timestamp=0.1 * i)
        pc = cpu.track_stereo(left, right, timestamp=0.1 * i)
        assert (pg is None) == (pc is None) and gpu.map.n_kf == cpu.map.n_kf
        if pg is not None:
            assert np.abs(pg[1] - pc[1]).max() < 1e-3, "t: tolerance 1 mm"
            assert np.abs(pg[0] - pc[0]).max() < 1e-3, "R: tolerance 1e-3"
    assert tham.HAMMING_BEST2_KERNEL.launches > 0, "the lane ran the fused Hamming kernel"
    assert tham.HAMMING_KERNEL.launches == 0, "and never the matrix kernel"


@pytest.mark.parametrize("name", POSE_CASES)
def test_pose_kernel_matches_plain_and_repeats(cuda_device, name):
    """csrc/pose.cu against pose_optimize_plain on the card: identical inlier
    flags and count, R within 1e-5 and t within 1e-4 m (the port-vs-JAX
    test's tolerances: the sums run in another order), the same bits from
    two launches, one counted launch a solve."""
    from orb_slam2_2021_tpu_torch.config import OptimConfig
    from orb_slam2_2021_tpu_torch.optim import pose as P

    cfg = OptimConfig()
    cam, R0, t0, obs = pose_inputs(name, cuda_device)
    launches = P.POSE_KERNEL.launches
    first = P.pose_optimize(cam, R0, t0, obs, cfg)
    second = P.pose_optimize(cam, R0, t0, obs, cfg)
    torch.cuda.synchronize()
    assert P.POSE_KERNEL.launches == launches + 2
    assert all(torch.equal(a, b) for a, b in zip(first, second)), "bit for bit"
    R, t, inl, n_in = first
    Rp, tp, inlp, n_p = P.pose_optimize_plain(cam, R0, t0, obs, cfg)
    assert inl.dtype == torch.bool and n_in.dtype == torch.int64 and n_in.dim() == 0
    assert torch.equal(inl, inlp) and int(n_in) == int(n_p) == int(inl.sum())
    assert float((R - Rp).abs().max()) < POSE_R_TOL, "R: 1e-5"
    assert float((t - tp).abs().max()) < POSE_T_TOL, "t: 1e-4 m"


def test_pose_kernel_refuses_more_than_it_takes(cuda_device):
    from orb_slam2_2021_tpu_torch.config import OptimConfig
    from orb_slam2_2021_tpu_torch.optim import pose as P

    cam, R0, t0, _ = pose_inputs("one", cuda_device)
    n = P.MAX_OBS + 1
    z = torch.zeros(n, 3, device=cuda_device)
    obs = P.PoseObs(z, z.clone(), torch.ones(n, device=cuda_device),
                    torch.ones(n, dtype=torch.bool, device=cuda_device))
    launches = P.POSE_KERNEL.launches
    with pytest.raises(ValueError):
        P.pose_optimize(cam, R0, t0, obs, OptimConfig())
    assert P.POSE_KERNEL.launches == launches


def test_lane_pose_solves_are_one_launch_each(cuda_device, monkeypatch):
    """Six 320x240 frames through the System on the card: every
    `track.pose_opt` span (one a solve) holds one pose-kernel launch, and
    the plain version never runs."""
    from orb_slam2_2021_tpu_torch.io import trace
    from orb_slam2_2021_tpu_torch.optim import pose as P
    from orb_slam2_2021_tpu_torch.pipeline.system import System

    def refuse(*args):
        raise AssertionError("the plain pose solve ran on a CUDA input")

    monkeypatch.setattr(P, "pose_optimize_plain", refuse)
    cfg = synthetic_config(width=320, height=240)
    world = SyntheticStereoWorld(cfg, seed=3)
    sys_ = System(cfg, enable_mapping=False, device=cuda_device)
    launches = P.POSE_KERNEL.launches
    trace.stop()
    trace.start()
    try:
        for i, (R, t) in enumerate(forward_trajectory(6, step=0.12)):
            left, right = world.render(R, t)
            sys_.track_stereo(left, right, timestamp=0.1 * i)
    finally:
        rec = trace.stop()
    solves = len(rec.named("track.pose_opt"))
    assert solves >= 3 * len(rec.named("track.fused_step")) > 0
    assert P.POSE_KERNEL.launches - launches == solves


def test_mapping_hamming_batched_matches_plain(cuda_device):
    """Triangulation's call: one keyframe [N, 8] against T stacked
    keyframes under a [T, N, M] mask, one launch of the fused matcher."""
    rng = np.random.default_rng(5)
    a, b = _descs(rng, 2000, cuda_device), _descs(rng, 10 * 2000, cuda_device).view(10, 2000, 8)
    mask = torch.from_numpy(rng.random((10, 2000, 2000)) < 0.05).to(cuda_device)
    launches = tham.HAMMING_BEST2_KERNEL.launches
    out = tham.hamming_best2(a, b, mask)
    assert tham.HAMMING_BEST2_KERNEL.launches == launches + 1
    for x, y in zip(out, tham.hamming_best2_plain(a, b, mask)):
        assert torch.equal(x, y), "kernel vs plain: tolerance 0"


BEST2_SHAPES = [(1, 1, None), (127, 129, None), (200, 150, None), (300, 1, None), (257, 64, None),
                (2000, 2000, None), (4096, 2000, None), (70, 1, 3), (130, 257, 4), (2000, 2000, 10)]


@pytest.mark.parametrize("n,m,t", BEST2_SHAPES)
def test_hamming_best2_kernel_matches_plain_and_repeats(cuda_device, n, m, t):
    """The fused matcher against its plain version at the edge cases
    (all-masked rows, M == 1, tied duplicate columns, one open column),
    bit for bit, and the same on a second run."""
    rng = np.random.default_rng(n + 3 * m + (t or 0))
    a, b, mask = hamming_inputs(rng, n, m, t, 0.05 if n * m > 10 ** 5 else 0.4, cuda_device)
    launches = tham.HAMMING_BEST2_KERNEL.launches
    got, again = tham.hamming_best2(a, b, mask), tham.hamming_best2(a, b, mask)
    torch.cuda.synchronize()
    assert tham.HAMMING_BEST2_KERNEL.launches == launches + 2
    for x, y, z in zip(got, tham.hamming_best2_plain(a, b, mask), again):
        assert x.dtype == y.dtype and x.shape == y.shape and torch.equal(x, y), "tolerance 0"
        assert torch.equal(x, z), "repeatable run to run"
    if n > 0:
        assert int(got[1][..., 0].max()) == tham.MAX_DIST, "row 0 is all masked"


def test_hamming_best2_ragged_mask_rows(cuda_device):
    """A mask whose rows are not 16-byte aligned (M % 16 != 0) and one that
    starts off a 16-byte boundary take the byte-wise path."""
    rng = np.random.default_rng(9)
    a, b, mask = hamming_inputs(rng, 100, 173, None, 0.3, cuda_device)
    for x, y in zip(tham.hamming_best2(a, b, mask), tham.hamming_best2_plain(a, b, mask)):
        assert torch.equal(x, y)
    m176 = torch.cat([mask, torch.zeros((100, 3), dtype=torch.bool, device=cuda_device)], dim=1)
    buf = torch.zeros(100 * 176 + 1, dtype=torch.bool, device=cuda_device)
    buf[1:] = m176.reshape(-1)
    shifted = buf[1:].view(100, 176)  # contiguous, rows 16-byte multiples, data_ptr % 16 == 1
    b176 = torch.cat([b, b[:3]])
    for x, y in zip(tham.hamming_best2(a, b176, shifted), tham.hamming_best2_plain(a, b176, shifted)):
        assert torch.equal(x, y)


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
    from orb_slam2_2021_tpu_torch.config import OptimConfig
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
    from orb_slam2_2021_tpu_torch.config import OptimConfig
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


def test_async_streams_have_priorities(cuda_device):
    """The lane's stream at the card's highest priority, the mapping and
    global-BA streams at its lowest; none is the default stream."""
    from orb_slam2_2021_tpu_torch.pipeline.streams import DeviceStreams

    low, high = torch.cuda.Stream.priority_range()
    st = DeviceStreams(cuda_device).streams
    assert st["lane"].priority == high and st["mapping"].priority == low and st["gba"].priority == low
    default = torch.cuda.default_stream(cuda_device)
    ids = {s.cuda_stream for s in st.values()}
    assert len(ids) == 3 and default.cuda_stream not in ids


def _kernel_streams(prof, tmp_path, name):
    """The stream ids of the CUDA kernels in a profiler trace."""
    import json

    path = tmp_path / f"{name}.json"
    prof.export_chrome_trace(str(path))
    events = json.load(open(path))["traceEvents"]
    return [e["args"]["stream"] for e in events
            if e.get("cat") == "kernel" and "stream" in e.get("args", {})]


def test_async_drive_launches_nothing_on_the_default_stream(cuda_device, tmp_path):
    """Under the profiler: a kernel launched on the default stream shows
    that stream's id; an async stereo drive (lane, mapping worker) then
    launches every kernel on other streams, and hamming_best2 counts its
    launches on both threads."""
    from torch.profiler import ProfilerActivity, profile

    from orb_slam2_2021_tpu_torch.pipeline.system import System

    with profile(activities=[ProfilerActivity.CUDA]) as probe:
        torch.ones(64, device=cuda_device).add_(1)
        torch.cuda.synchronize()
    default_ids = set(_kernel_streams(probe, tmp_path, "probe"))
    assert default_ids, "the probe kernel was traced"

    cfg = synthetic_config(320, 240)
    world = SyntheticStereoWorld(cfg, seed=3)
    frames = [world.render(R, t) for R, t in forward_trajectory(16, step=0.12)]
    sys_ = System(cfg, async_mode=True, enable_loop_closing=False, device=cuda_device)
    tham.HAMMING_BEST2_KERNEL.reset_counts()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i, (l, r) in enumerate(frames):
            assert sys_.track_stereo(l, r, timestamp=0.1 * i) is not None
        sys_.shutdown()
    streams = _kernel_streams(prof, tmp_path, "drive")
    assert streams and not default_ids & set(streams), "a kernel ran on the default stream"
    by_thread = dict(tham.HAMMING_BEST2_KERNEL.launches_by_thread)
    assert by_thread.get("MainThread", 0) > 0 and by_thread.get("mapping", 0) > 0, by_thread
    assert not sys_.map.check_invariants()


def test_cold_build_from_two_threads_gives_one_library(cuda_device, tmp_path, monkeypatch):
    """Two threads reaching a kernel that is not built yet: one nvcc run,
    one library, the same launcher in both."""
    import threading

    from orb_slam2_2021_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    compiles, real = [], cuda_build._compile
    monkeypatch.setattr(cuda_build, "_compile", lambda *a: (compiles.append(a), real(*a)))
    kernel = cuda_build.CudaKernel("hamming.cu", tham.HAMMING_BEST2_KERNEL.symbol,
                                   tham.HAMMING_BEST2_KERNEL.argtypes)
    barrier, got = threading.Barrier(2), []

    def build():
        barrier.wait()
        got.append(kernel.build())

    threads = [threading.Thread(target=build) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert len(compiles) == 1 and len(got) == 2 and got[0] is got[1]
    assert len([p for p in tmp_path.iterdir() if p.suffix == ".so"]) == 1


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_remap_on_cuda_matches_cpu(cuda_device, dtype):
    """The rectifying gather at KITTI width on the card against the CPU
    path (which tests/test_torch_io.py holds against the reference):
    within 1e-3 on 0-255 values, exactly 0 where no corner is inside."""
    from orb_slam2_2021_tpu_torch.io.rectify import RectifyMaps, remap

    rng = np.random.default_rng(12)
    h, w = 376, 1241
    maps = RectifyMaps(map_y=rng.uniform(-3, h + 2, (h, w)).astype(np.float32),
                       map_x=rng.uniform(-3, w + 2, (h, w)).astype(np.float32))
    img = rng.uniform(0, 255, (h, w)).astype(dtype)
    gpu, cpu = remap(img, maps, device=cuda_device), remap(img, maps, device="cpu")
    assert gpu.device.type == "cuda" and gpu.dtype == torch.float32
    assert float((gpu.cpu() - cpu).abs().max()) <= 1e-3
    outside = torch.from_numpy((maps.map_x <= -1) | (maps.map_x >= w) | (maps.map_y <= -1)
                               | (maps.map_y >= h))
    assert (gpu.cpu()[outside] == 0).all() and (cpu[outside] == 0).all()


def test_sor_on_cuda_matches_cpu(cuda_device):
    """The outlier filter's mean kNN distances on the card against the CPU
    path, far from the origin (the expansion's cancellation): within 1e-4
    relative, at least 99.9% of the keep flags equal, blocks of 7 rows as
    one block."""
    from orb_slam2_2021_tpu_torch.tools.map_processor import (mean_knn_distances,
                                                              statistical_outlier_filter)

    rng = np.random.default_rng(13)
    pts = np.stack([rng.uniform(0, 700, 5000), rng.uniform(-3, 3, 5000),
                    rng.uniform(4, 30, 5000)], 1).astype(np.float32)
    p = torch.from_numpy(pts)
    gpu = mean_knn_distances(p.to(cuda_device), 50)
    cpu = mean_knn_distances(p, 50)
    assert gpu.device.type == "cuda"
    np.testing.assert_allclose(gpu.cpu().numpy(), cpu.numpy(), rtol=1e-4, atol=0)
    assert torch.equal(mean_knn_distances(p.to(cuda_device), 50, block_rows=7), gpu)
    assert (statistical_outlier_filter(pts, device=cuda_device)
            == statistical_outlier_filter(pts, device="cpu")).mean() >= 0.999


def _vocab_rows(rng, sizes, dev):
    """Random descriptors grouped by node (`sizes` rows each) with a few
    repeated rows: (rows [R, 8] int32, group [R], offsets [G + 1])."""
    words = rng.integers(0, 2 ** 32, (int(sum(sizes)), 8), dtype=np.uint32)
    words[: len(words) // 10] = words[0]
    rows = torch.from_numpy(words.view(np.int32)).to(dev)
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)).to(dev)
    group = torch.repeat_interleave(torch.arange(len(sizes), device=dev),
                                    offsets[1:] - offsets[:-1])
    return rows, group, offsets


VOCAB_SIZES = [0, 1, 10, 11, 400, 4096, 4097, 20000]  # empty, small, one and several majority chunks


@pytest.mark.parametrize("k", [1, 10, 16])
def test_vocab_assign_kernel_matches_plain(cuda_device, k):
    from orb_slam2_2021_tpu_torch.ops import vocab_kernels as vk

    rng = np.random.default_rng(30 + k)
    rows, group, _ = _vocab_rows(rng, VOCAB_SIZES, cuda_device)
    centers = rows[torch.from_numpy(rng.integers(0, rows.shape[0], (len(VOCAB_SIZES), k))).to(cuda_device)]
    centers[:, -1] = centers[:, 0]  # a tied duplicate: the first occurrence wins
    launches = vk.VOCAB_ASSIGN_KERNEL.launches
    idx, dist = vk.vocab_assign(rows, group, centers.contiguous())
    torch.cuda.synchronize()
    pidx, pdist = vk.vocab_assign_plain(rows, group, centers.contiguous())
    assert torch.equal(idx, pidx) and torch.equal(dist, pdist), "kernel vs plain: tolerance 0"
    assert vk.VOCAB_ASSIGN_KERNEL.launches == launches + 1


def test_vocab_majority_kernel_matches_plain(cuda_device):
    from orb_slam2_2021_tpu_torch.ops import vocab_kernels as vk

    rng = np.random.default_rng(41)
    rows, _, offsets = _vocab_rows(rng, VOCAB_SIZES, cuda_device)
    for k in (1, 10, 16):
        assign = torch.from_numpy(rng.integers(0, k, rows.shape[0])).to(cuda_device)
        launches = vk.VOCAB_MAJORITY_KERNEL.launches
        centers, sizes = vk.vocab_majority(rows, assign, offsets, k)
        torch.cuda.synchronize()
        pc, ps = vk.vocab_majority_plain(rows, assign, offsets, k)
        assert torch.equal(centers, pc) and torch.equal(sizes, ps), f"k={k}: tolerance 0"
        assert vk.VOCAB_MAJORITY_KERNEL.launches == launches + 3, "the small-node, chunk and pack kernels"


def test_vocab_seed_draw_kernel_matches_plain(cuda_device):
    """numpy's rng.choice pick, bit for bit, with zero-sum nodes and a node
    of 2 M rows (the level-0 chain)."""
    from orb_slam2_2021_tpu_torch.ops import vocab_kernels as vk

    rng = np.random.default_rng(52)
    sizes = [1, 11, 400, 4097, 2_000_000, 30]
    d2 = rng.integers(0, 257, sum(sizes)).astype(np.int32)
    d2[1:12] = 0  # the second node sums to 0
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)).to(cuda_device)
    u = torch.from_numpy(rng.random(len(sizes))).to(cuda_device)
    d2 = torch.from_numpy(d2).to(cuda_device)
    pick, zero = vk.vocab_seed_draw(d2, offsets, u)
    torch.cuda.synchronize()
    ppick, pzero = vk.vocab_seed_draw_plain(d2, offsets, u)
    assert torch.equal(zero, pzero) and zero.tolist() == [False, True, False, False, False, False]
    assert torch.equal(pick, ppick), "kernel vs plain: tolerance 0"


def _hold_seed_draw(vk, d2, offsets, us):
    """The seed-draw kernel against its plain version for each [G] uniform
    vector, exactly, and against itself on a second run."""
    for u in us:
        u = torch.from_numpy(np.ascontiguousarray(u, np.float64)).to(d2.device)
        pick, zero = vk.vocab_seed_draw(d2, offsets, u)
        again = vk.vocab_seed_draw(d2, offsets, u)
        torch.cuda.synchronize()
        ppick, pzero = vk.vocab_seed_draw_plain(d2, offsets, u)
        assert torch.equal(zero, pzero) and torch.equal(pick, ppick), "kernel vs plain: tolerance 0"
        assert torch.equal(pick, again[0]) and torch.equal(zero, again[1]), "two runs differ"


@pytest.mark.parametrize("name", SEED_DRAW_CASES)
def test_vocab_seed_draw_kernel_adversarial(cuda_device, name):
    """The tiled scan and the chain on the host models' adversarial nodes
    (tests/test_torch_vocab_card.py), all in one call, with uniforms on and
    beside the cdf's own values: the tiles launch only where a node has
    more than SEED_CHAIN_MAX rows."""
    from orb_slam2_2021_tpu_torch.ops import vocab_kernels as vk

    rng = np.random.default_rng(70 + SEED_DRAW_CASES.index(name))
    nodes = seed_draw_case(name, rng)
    d2 = torch.from_numpy(np.concatenate(nodes)).to(cuda_device)
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum([len(x) for x in nodes])]).astype(np.int64))
    launches = vk.VOCAB_SEED_DRAW_KERNEL.launches
    _hold_seed_draw(vk, d2, offsets.to(cuda_device), seed_draw_uniforms(nodes, rng))
    per_call = vk.SEED_KERNELS if max(len(x) for x in nodes) > vk.SEED_CHAIN_MAX else 1
    assert vk.VOCAB_SEED_DRAW_KERNEL.launches == launches + 2 * 6 * per_call


def test_vocab_seed_draw_kernel_full_size(cuda_device):
    """One node of 4,000,000 rows (level 0 of the full-size tree) and
    99,907 nodes of about 40 (its level 5: the chain kernel alone, though
    the level holds millions of rows)."""
    from orb_slam2_2021_tpu_torch.ops import vocab_kernels as vk

    rng = np.random.default_rng(71)
    big = rng.binomial(256, 0.45, 4_000_000).astype(np.int32)
    big[rng.integers(0, len(big), 40_000)] = 0
    _hold_seed_draw(vk, torch.from_numpy(big).to(cuda_device),
                    torch.tensor([0, len(big)], dtype=torch.int64, device=cuda_device),
                    seed_draw_uniforms([big], rng))
    sizes = rng.integers(1, 80, 99_907)
    small = rng.integers(0, 257, int(sizes.sum())).astype(np.int32)
    nodes = np.split(small, np.cumsum(sizes)[:-1])
    launches = vk.VOCAB_SEED_DRAW_KERNEL.launches
    _hold_seed_draw(vk, torch.from_numpy(small).to(cuda_device),
                    torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)).to(cuda_device),
                    seed_draw_uniforms(nodes, rng)[:3])
    assert vk.VOCAB_SEED_DRAW_KERNEL.launches == launches + 2 * 3, "one kernel a call"


def _hold_majority(vk, rows, assign, offsets, k):
    centers, sizes = vk.vocab_majority(rows, assign, offsets, k)
    again = vk.vocab_majority(rows, assign, offsets, k)
    torch.cuda.synchronize()
    pc, ps = vk.vocab_majority_plain(*counted_rows(rows, assign, offsets, k), k)
    assert torch.equal(centers, pc) and torch.equal(sizes, ps), f"k={k}: tolerance 0"
    assert torch.equal(centers, again[0]) and torch.equal(sizes, again[1]), "two runs differ"


@pytest.mark.parametrize("k", [1, 10, 16])
def test_vocab_majority_kernel_adversarial(cuda_device, k):
    """The bit-transposed count against the plain version:
    nodes that end inside a k-word, a group, a chunk; empty clusters; rows in
    no cluster; runs of repeated rows."""
    from orb_slam2_2021_tpu_torch.ops import vocab_kernels as vk

    rows, assign, offsets = majority_case(np.random.default_rng(80 + k), k)
    _hold_majority(vk, torch.from_numpy(rows.view(np.int32)).to(cuda_device),
                   torch.from_numpy(assign).to(cuda_device), torch.from_numpy(offsets).to(cuda_device), k)
    assert sum(MAJORITY_SIZES) == rows.shape[0]


def test_vocab_majority_kernel_full_size(cuda_device):
    """One node of 4,000,000 rows and 99,907 nodes of about 40, k = 10."""
    from orb_slam2_2021_tpu_torch.ops import vocab_kernels as vk

    rng = np.random.default_rng(81)
    for sizes in ([4_000_000], rng.integers(1, 80, 99_907)):
        rows, assign, offsets = majority_case(rng, 10, sizes)
        _hold_majority(vk, torch.from_numpy(rows.view(np.int32)).to(cuda_device),
                       torch.from_numpy(assign).to(cuda_device), torch.from_numpy(offsets).to(cuda_device), 10)


def test_vocab_tree_on_cuda_matches_cpu(cuda_device):
    """k=10, L=4 on the card against the CPU path (which
    tests/test_torch_vocab_card.py holds against the reference), on random
    rows beside repeated ones (zero-sum seeds and empty clusters)."""
    from orb_slam2_2021_tpu_torch.ops import vocab_kernels as vk
    from orb_slam2_2021_tpu_torch.place.vocab import train_vocabulary

    rng = np.random.default_rng(60)
    words = rng.integers(0, 2 ** 32, (20000, 8), dtype=np.uint32)
    words[rng.integers(0, 20000, 3000)] = words[:6][rng.integers(0, 6, 3000)]
    for kern in vk.KERNELS:
        kern.reset_counts()
    card_stats, cpu_stats = {}, {}
    card = train_vocabulary(words, k=10, L=4, seed=3, device=cuda_device, stats=card_stats)
    assert all(kern.launches > 0 for kern in vk.KERNELS)
    cpu = train_vocabulary(words, k=10, L=4, seed=3, device="cpu", stats=cpu_stats)
    assert np.array_equal(card.node_desc, cpu.node_desc) and np.array_equal(card.word_idf, cpu.word_idf)
    assert [r["passes"] for r in card_stats["levels"]] == [r["passes"] for r in cpu_stats["levels"]]


def test_recorder_spans_hold_their_launches_on_the_profiler_clock(cuda_device):
    """Known launches inside io/trace.py spans, each span 1 ms of host time
    on either side of its launches and 2 ms from the next, under
    torch.profiler (CUDA activity): every launch's runtime event, on the
    recorder's converted clock, falls inside the span that made it."""
    import threading
    import time

    from orb_slam2_2021_tpu_torch.io import trace

    launch_calls = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
    x = torch.ones(4096, device=cuda_device)
    x.add_(1)
    torch.cuda.synchronize()
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    trace.stop()
    trace.start()
    try:
        for i in range(8):
            time.sleep(0.002)
            with trace.span("launches", key=i):
                time.sleep(0.001)
                for _ in range(i + 1):
                    x.add_(1)
                time.sleep(0.001)
    finally:
        rec = trace.stop()
        torch.cuda.synchronize()
        prof.stop()
    low = threading.get_ident() & 0xFFFFFFFF
    mine = {threading.get_native_id(), low - (1 << 32) if low >= 1 << 31 else low}
    launches = sorted(e.start_ns() for e in prof.profiler.kineto_results.events()
                      if e.name() in launch_calls and e.device_resource_id() in mine)
    spans = sorted((rec.to_profiler_ns(s.t0), rec.to_profiler_ns(s.t1), s.key) for s in rec.named("launches"))
    assert len(spans) == 8 and len(launches) == sum(range(1, 9))
    assert rec.offset_err_ns < 100_000, rec.offset_err_ns
    for a, b, k in spans:
        assert sum(a <= t < b for t in launches) == k + 1, (k, a, b)
    assert all(any(a <= t < b for a, b, _ in spans) for t in launches)
