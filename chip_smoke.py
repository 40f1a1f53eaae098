"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero before the result lines are printed):
  1. require a CUDA card; print its name and power limit (nvidia-smi);
  2. build the hand-written kernels from csrc/ with nvcc, print build time;
  3. hold both Hamming launchers (hamming_matrix, hamming_best2) against
     their plain PyTorch versions on the card, exactly, at the tracking
     lane's shapes, the ragged shapes and M == 1, with edge-case masks (an
     all-masked row, an all-open row with tied duplicate columns, a row open
     at one column); check the fused one repeats bit for bit; time both at
     4096x2000 beside their bounds, plain versions and yardsticks;
  4. check the lane on a small input against the port's CPU path, which the
     tests/test_torch_*.py suite holds against the JAX reference;
  5. drive System(kitti_stereo_config(), enable_mapping=False) over frames
     rendered by SyntheticStereoWorld at KITTI width, counting hamming_best2's
     launches (and hamming_matrix's, which must be 0) on that drive, and
     check tracking, keyframes, ATE and devices;
  6. the Hamming checks of phase 3 at the shapes local mapping gives the
     fused launcher (one keyframe against T = 10 and 8 stacked keyframes;
     the matrix at 2000 x T*2000), timed at T = 10;
  7. check the System with local mapping and the occupancy grid on, CUDA
     against the CPU path, on a 320x240 sequence;
  8. drive System(kitti_stereo_config(), enable_mapping=True,
     enable_loop_closing=False) over the first 40 frames of the bench's
     cylinder-world orbit at KITTI width, counting hamming_best2's launches
     from the mapping units apart from the lane's, and check tracking,
     keyframes, local BA solves, triangulated points, the grid and ATE;
  9. hold the loop-closing numerics on the card against the CPU path, with
     the same RANSAC samples on both devices: the vocabulary descent on the
     packaged 10^6-word tree (exact), Sim3 RANSAC and its refine, EPnP RANSAC
     (inlier flags as a rate) and the essential-graph solve; time each on
     the card;
 10. build a map with the port's CPU path at 320x240, save it, boot a CUDA
     and a CPU System from the file and relocalize one frame on both: same
     keyframe, poses within tolerance;
 11. drive System(kitti_stereo_config(), device="cuda") at the reference's
     defaults (packaged vocabulary, mapping and loop closing on, sync) over
     the whole 144-frame orbit, counting hamming_best2's launches per path
     (mapping units, loop closing); check tracking, the loop (pair and frame
     against the reference's), global BA, the grid replay and ATE; then save
     the map, boot from it on the card and relocalize a mid-orbit frame; and
     run the Hamming checks at the shapes loop closing gave the fused
     launcher.

Nothing of the JAX package is imported. The second-to-last line is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 30
STEP = 0.14          # m per frame: the bench's KITTI-width forward dolly
WORLD_SEED = 7700
SHAPES = [(2000, 2000), (4096, 2000), (1, 1), (127, 129), (200, 150), (257, 64), (0, 7)]
# local mapping at KITTI width: triangulation matches one keyframe's 2000
# features against 10 neighbours, forward fusion 2000 points against 8
MAPPING_SHAPES = [(2000, 2000, 10), (2000, 2000, 8)]  # (N, M, T)
N_ORBIT = 144        # the bench's 630-degree orbit (bench.py)
N_MAP_FRAMES = 40    # its first frames, for the mapping-on drive
# the JAX reference's synchronous drive of the same orbit closes one loop at
# frame 84, keyframe 9 against keyframe 0 (485 matched map points)
REF_LOOP_FRAME, REF_LOOP_PAIR = 84, (9, 0)
RELOC_FRAME = 60     # a mid-orbit frame relocalized against the saved map
SMALL_MAP_FRAMES = 20
# CUDA vs CPU with mapping on at 320x240: measured 1.02e-4 (pose) and 0.0024
# (map points) on an H100 80GB HBM3 at 700 W, see PERF.md
SMALL_MAP_POSE_TOL = 1e-3     # m and rotation entries
SMALL_MAP_POINTS_TOL = 0.02   # relative difference of live map-point counts


def log(msg):
    print(msg, flush=True)


def card_info() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters=50, warm=5):
    """Mean device time of one call, by CUDA events over `iters` calls
    after `warm` warm-up calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=50, warm=5):
    """Mean device time of one call: CUDA events around `iters` calls queued
    behind a sleep kernel, so the card runs them back to back and the host's
    launch cost stays hidden."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (2 * iters * one + 1e-3)))  # ~2 GHz SM clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# published peaks of one H100 SXM at 700 W (NVIDIA data sheet): the bounds
# below are the larger of bytes over the memory rate and int8 operations over
# the tensor cores' dense rate
H100_BYTES_PER_S = 3.35e12
H100_INT8_OPS_PER_S = 1979e12
LANE_MASK_DENSITY = 0.02     # open share of a lane matcher's candidate mask
MAPPING_MASK_DENSITY = 0.05  # of an epipolar or projection-window mask


def _bound(n_bytes, n_ops):
    """(bound in ms, "bytes" or "operations")."""
    t_bytes = 1e3 * n_bytes / H100_BYTES_PER_S
    t_ops = 1e3 * n_ops / H100_INT8_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def matrix_bound(n, m):
    """hamming_matrix: both packed inputs read once, the int16 matrix written
    once; 2*256 int8 operations per entry."""
    return _bound((n + m) * 32 + n * m * 2, 2 * n * m * 256)


def best2_bound(n, m, t):
    """hamming_best2: packed inputs and the bool mask read once, 20 bytes of
    results per row written once; 2*256 int8 operations per entry."""
    return _bound(n * 32 + t * m * 32 + t * n * m + t * n * 20, 2 * t * n * m * 256)


def _bits(rng, shape, p):
    """Packed words whose bits are set with probability p."""
    bits = rng.random((*shape, 32)) < p
    return np.packbits(bits, axis=-1, bitorder="little").view(np.uint32)[..., 0]


def hamming_inputs(rng, n, m, t, density, dev):
    """Descriptors and mask for one call. b holds near-copies of a's rows
    (small distances) and duplicated columns (ties: the first occurrence must
    win); the mask is open with probability `density`, and three rows are
    edge cases: row 0 all masked, row 1 all open, row 2 open at one column
    only. t=None gives b [m, 8] and mask [n, m], else b [t, m, 8] and mask
    [t, n, m]."""
    tt = 1 if t is None else t
    a = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (tt, m, 8), dtype=np.uint32)
    k = min(n, m) // 2
    if k:
        b[:, :k] = a[None, :k] ^ _bits(rng, (tt, k, 8), 0.04)
    if m >= 4:
        b[:, m // 2:m // 2 + m // 4] = b[:, :m // 4]
    mask = rng.random((tt, n, m)) < density
    mask[:, 0:1] = False
    mask[:, 1:2] = True
    if n > 2:
        mask[:, 2] = False
        mask[:, 2, min(5, m - 1)] = True
    if t is None:
        b, mask = b[0], mask[0]
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    return f(a.view(np.int32)), f(b.view(np.int32)), f(mask)


def _unfused(H, a, b, mask):
    """The chain the matchers ran before the fused kernel: the matrix
    kernel, where, then best_two."""
    if b.dim() == 2:
        d = H.hamming_matrix(a, b)
    else:
        T, M = b.shape[0], b.shape[1]
        d = H.hamming_matrix(a, b.reshape(T * M, 8)).view(a.shape[0], T, M).permute(1, 0, 2)
    return H.best_two(torch.where(mask, d, torch.full_like(d, H.MAX_DIST)))


def hold_hamming(a, b, mask, label):
    """Both launchers against their plain versions, exactly, and the fused
    one against itself on a second run. Returns the max abs error."""
    from orb_slam2_2021_tpu_torch.ops import hamming as H

    err = 0
    if b.dim() == 2:
        out, ref = H.hamming_matrix(a, b), H.hamming_matrix_plain(a, b)
        torch.cuda.synchronize()
        if out.dtype != torch.int16 or out.shape != ref.shape or not torch.equal(out, ref):
            raise AssertionError(f"hamming_matrix disagrees with its plain version at {label}")
        if out.numel():
            err = int((out.int() - ref.int()).abs().max())
    got = H.hamming_best2(a, b, mask)
    again = H.hamming_best2(a, b, mask)
    ref = H.hamming_best2_plain(a, b, mask)
    torch.cuda.synchronize()
    for name, x, y, z in zip(("best_idx", "best", "second_idx", "second"), got, ref, again):
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y):
            raise AssertionError(f"hamming_best2 {name} disagrees with its plain version at {label}")
        if not torch.equal(x, z):
            raise AssertionError(f"hamming_best2 {name} differs between two runs at {label}")
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    log(f"hamming {label}: hamming_matrix and hamming_best2 == plain (tolerance 0), "
        f"best2 repeatable")
    return err


def time_hamming(a, b, mask, label, iters=50):
    """Each launcher's device time (device_ms) in turns (plain, kernel,
    kernel, plain; better of two), beside its bound and its yardsticks: torch.cdist(p=0) on
    pre-unpacked float bits for the matrix (the port never calls it), the
    unfused chain for the fused launcher."""
    from orb_slam2_2021_tpu_torch.ops import hamming as H

    n = a.shape[0]
    bf = b.reshape(-1, 8)
    T, m = (1, b.shape[0]) if b.dim() == 2 else (b.shape[0], b.shape[1])
    shifts = torch.arange(32, device=a.device, dtype=torch.int32)
    fa = ((a[:, :, None] >> shifts) & 1).reshape(n, 256).float()
    fb = ((bf[:, :, None] >> shifts) & 1).reshape(-1, 256).float()
    few = max(3, iters // 5)

    def turns(kernel, plain, plain_iters):
        p1 = device_ms(plain, iters=plain_iters)
        k1 = device_ms(kernel, iters=iters)
        k2 = device_ms(kernel, iters=iters)
        p2 = device_ms(plain, iters=plain_iters)
        return min(k1, k2), min(p1, p2)

    mat_ms, mat_plain = turns(lambda: H.hamming_matrix(a, bf), lambda: H.hamming_matrix_plain(a, bf), few)
    lib = device_ms(lambda: torch.cdist(fa, fb, p=0), iters=few)
    b2_ms, b2_plain = turns(lambda: H.hamming_best2(a, b, mask),
                            lambda: H.hamming_best2_plain(a, b, mask), few)
    unfused = device_ms(lambda: _unfused(H, a, b, mask), iters=iters)
    mb, mby = matrix_bound(n, T * m)
    bb, bby = best2_bound(n, m, T)
    rows = {
        "hamming_matrix": {"shape": [n, T * m], "ms": mat_ms, "plain_ms": mat_plain, "bound_ms": mb,
                           "bound_by": mby, "library_ms": lib},
        "hamming_best2": {"shape": [T, n, m], "ms": b2_ms, "plain_ms": b2_plain, "bound_ms": bb,
                          "bound_by": bby, "library_ms": None, "unfused_ms": unfused},
    }
    log(f"hamming {label}: matrix {n}x{T * m} {mat_ms:.4f} ms (bound {mb:.4f} ms by {mby}, "
        f"{100 * mb / mat_ms:.0f}%), plain {mat_plain:.4f} ms, torch.cdist(p=0) {lib:.4f} ms; "
        f"best2 T={T} {n}x{m} {b2_ms:.4f} ms (bound {bb:.4f} ms by {bby}, {100 * bb / b2_ms:.0f}%), "
        f"plain {b2_plain:.4f} ms, unfused chain {unfused:.4f} ms "
        f"(device time by CUDA events behind a sleep, mean of {iters}, better of two runs)")
    return rows


def check_hamming(dev):
    """Phase 3: both launchers at the lane's shapes, the ragged shapes and
    M == 1, exactly; both timed at 4096x2000."""
    rng = np.random.default_rng(0)
    max_err, times = 0, {}
    for n, m in SHAPES + [(300, 1)]:
        density = LANE_MASK_DENSITY if n * m > 10 ** 6 else 0.3
        a, b, mask = hamming_inputs(rng, n, m, None, density, dev)
        max_err = max(max_err, hold_hamming(a, b, mask, f"{n}x{m}"))
        if (n, m) == (4096, 2000):
            times["lane"] = time_hamming(a, b, mask, f"{n}x{m} (local-point search)")
    return max_err, times


def check_hamming_mapping_shapes(dev):
    """Phase 6: the launchers at the mapping units' shapes, one keyframe's
    2000 features against T = 10 and 8 stacked keyframes (the matrix at
    2000 x T*2000, the fused launcher at [T, 2000, 2000]), and a small
    batched M == 1 case, exactly; both timed at T = 10."""
    rng = np.random.default_rng(1)
    max_err, times = 0, {}
    for n, m, t in MAPPING_SHAPES + [(70, 1, 3)]:
        a, b, mask = hamming_inputs(rng, n, m, t, MAPPING_MASK_DENSITY, dev)
        max_err = max(max_err, hold_hamming(a, b, mask, f"T={t} {n}x{m}"))
        flat = mask.permute(1, 0, 2).reshape(n, t * m).contiguous()  # the T sets as one
        max_err = max(max_err, hold_hamming(a, b.reshape(t * m, 8), flat, f"{n}x{t * m}"))
        if t == 10:
            times["mapping"] = time_hamming(a, b, mask, f"T={t} {n}x{m} (triangulation)", iters=20)
    return max_err, times


def render_frames(cfg, n_frames, step, seed):
    from orb_slam2_2021_tpu_torch.io.synthetic import SyntheticStereoWorld, forward_trajectory

    world = SyntheticStereoWorld(cfg, seed=seed)
    gt = forward_trajectory(n_frames, step=step)
    frames = []
    for R, t in gt:
        left, right = world.render(R, t)
        frames.append(np.clip(np.stack([left, right]), 0, 255).astype(np.uint8))
    return frames, gt


def check_small_against_cpu(dev):
    """The lane on CUDA vs the port's CPU path (held against JAX by the
    tests) on a 320x240 sequence: same tracked flags and keyframes, poses
    within 1 mm / 1e-3."""
    from orb_slam2_2021_tpu_torch.config import synthetic_config
    from orb_slam2_2021_tpu_torch.pipeline.system import System

    cfg = synthetic_config(width=320, height=240)
    frames, _ = render_frames(cfg, 6, 0.12, 3)
    gpu = System(cfg, enable_mapping=False, device=dev)
    cpu = System(cfg, enable_mapping=False, device="cpu")
    worst = 0.0
    for i, pair in enumerate(frames):
        pg = gpu.track_stereo(pair[0], pair[1], timestamp=0.1 * i)
        pc = cpu.track_stereo(pair[0], pair[1], timestamp=0.1 * i)
        if (pg is None) != (pc is None) or gpu.map.n_kf != cpu.map.n_kf:
            raise AssertionError(f"small sequence frame {i}: CUDA and CPU tracking differ")
        if pg is not None:
            worst = max(worst, float(np.abs(pg[1] - pc[1]).max()), float(np.abs(pg[0] - pc[0]).max()))
    if worst > 1e-3:
        raise AssertionError(f"small sequence: CUDA vs CPU pose difference {worst:.2e} > 1e-3")
    log(f"small 320x240 sequence: CUDA lane agrees with the CPU path (max pose diff {worst:.2e})")


def check_mapping_small_against_cpu(dev):
    """The System with local mapping and the grid on, CUDA vs the port's CPU
    path (held against the JAX System by the tests) on the tests' 320x240
    sequence: same tracked flags, keyframe counts and local-BA solves; poses
    and live map-point counts within the stated tolerances."""
    from orb_slam2_2021_tpu_torch.config import synthetic_config
    from orb_slam2_2021_tpu_torch.pipeline.system import System

    cfg = synthetic_config(width=320, height=240)
    frames, _ = render_frames(cfg, SMALL_MAP_FRAMES, 0.12, 3)
    gpu = System(cfg, enable_mapping=True, enable_loop_closing=False, device=dev)
    cpu = System(cfg, enable_mapping=True, enable_loop_closing=False, device="cpu")
    worst, worst_pts = 0.0, 0.0
    for i, pair in enumerate(frames):
        pg = gpu.track_stereo(pair[0], pair[1], timestamp=0.1 * i)
        pc = cpu.track_stereo(pair[0], pair[1], timestamp=0.1 * i)
        if (pg is None) != (pc is None) or gpu.map.n_kf != cpu.map.n_kf:
            raise AssertionError(f"mapping-on small sequence frame {i}: CUDA and CPU tracking differ")
        if pg is not None:
            worst = max(worst, float(np.abs(pg[1] - pc[1]).max()), float(np.abs(pg[0] - pc[0]).max()))
        n_g, n_c = int(gpu.map.mp_valid.sum()), int(cpu.map.mp_valid.sum())
        worst_pts = max(worst_pts, abs(n_g - n_c) / max(n_c, 1))
    gpu.shutdown()
    cpu.shutdown()
    n_ba = (len(gpu.local_mapper.ba_solve_times), len(cpu.local_mapper.ba_solve_times))
    log(f"mapping-on 320x240 sequence, {SMALL_MAP_FRAMES} frames: {gpu.map.n_kf} keyframes, "
        f"local BA solves {n_ba[0]} (CUDA) / {n_ba[1]} (CPU), max pose diff {worst:.2e} "
        f"(tolerance {SMALL_MAP_POSE_TOL}), max relative map-point count diff {worst_pts:.4f} "
        f"(tolerance {SMALL_MAP_POINTS_TOL})")
    if n_ba[0] != n_ba[1] or n_ba[0] < 1:
        raise AssertionError(f"local BA solves differ or never ran: {n_ba}")
    if worst > SMALL_MAP_POSE_TOL or worst_pts > SMALL_MAP_POINTS_TOL:
        raise AssertionError("mapping-on small sequence: CUDA and CPU disagree beyond tolerance")
    occ = int((gpu.occupancy_grid().data == 100).sum())
    if occ == 0:
        raise AssertionError("mapping-on small sequence: empty occupancy grid")


def _ate(est, gt):
    from orb_slam2_2021_tpu_torch.io.trajectory import ate_rmse

    gt_mats = []
    for R, t in gt[: len(est)]:
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        gt_mats.append(T)
    length = float(sum(np.linalg.norm(gt[i + 1][1] - gt[i][1]) for i in range(len(gt) - 1)))
    return ate_rmse(est, gt_mats), length


def _ate_alignment(est, gt):
    """The rigid map from the estimate's frame to the ground truth's that
    ate_rmse fits (Horn on the camera centres), as a function of a point."""
    e = np.asarray([T[:3, 3] for T in est], np.float64)
    g = np.asarray([t for _, t in gt[: len(est)]], np.float64)
    mu_e, mu_g = e.mean(0), g.mean(0)
    U, _, Vt = np.linalg.svd((e - mu_e).T @ (g - mu_g))
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = Vt.T @ S @ U.T
    return lambda x: R @ (np.asarray(x, np.float64) - mu_e) + mu_g


_WORLD = None


def _render_pair(pose):
    R, t = pose
    return np.clip(np.stack(_WORLD.render(R, t)), 0, 255).astype(np.uint8)


def render_orbit(n_frames=N_ORBIT, workers=4):
    """The bench's world and path at KITTI width: SyntheticCylinderWorld(seed
    7) on orbit_trajectory(144, 630 degrees, r 1.5 m), as uint8 pairs,
    rendered by `workers` forked processes. Call it before anything touches
    the card: the children inherit the world, never a CUDA context."""
    import multiprocessing

    from orb_slam2_2021_tpu_torch.config import kitti_stereo_config
    from orb_slam2_2021_tpu_torch.io.synthetic import SyntheticCylinderWorld, orbit_trajectory

    global _WORLD
    _WORLD = SyntheticCylinderWorld(kitti_stereo_config(), seed=7)
    gt = orbit_trajectory(N_ORBIT, total_deg=630.0, r_orbit=1.5)[:n_frames]
    t0 = time.perf_counter()
    with multiprocessing.get_context("fork").Pool(workers) as pool:
        frames = pool.map(_render_pair, gt, chunksize=4)
    _WORLD = None
    log(f"rendered {len(frames)} cylinder-world frames in {time.perf_counter() - t0:.1f} s "
        f"({workers} processes)")
    return frames, gt


def drive_kitti_mapping(dev, frames, gt):
    """Mapping on at KITTI width over the first N_MAP_FRAMES frames of the
    bench's orbit in the cylinder world; Hamming launches from the mapping
    units are counted apart from the lane's."""
    from orb_slam2_2021_tpu_torch.config import kitti_stereo_config
    from orb_slam2_2021_tpu_torch.ops.hamming import HAMMING_BEST2_KERNEL, HAMMING_KERNEL
    from orb_slam2_2021_tpu_torch.pipeline.system import System

    cfg = kitti_stereo_config()
    frames, gt = frames[:N_MAP_FRAMES], gt[:N_MAP_FRAMES]
    sys_ = System(cfg, enable_mapping=True, enable_loop_closing=False, device=dev)

    lm = sys_.local_mapper
    counts = {"mapping": 0, "keyframes": 0}
    process = lm.process_pending

    def counted_process():
        n0, q = HAMMING_BEST2_KERNEL.launches, len(lm.queue)
        process()
        counts["mapping"] += HAMMING_BEST2_KERNEL.launches - n0
        counts["keyframes"] += q

    lm.process_pending = counted_process
    HAMMING_BEST2_KERNEL.launches = HAMMING_KERNEL.launches = 0
    tracked = 0
    for i, pair in enumerate(frames):
        if sys_.track_stereo(pair[0], pair[1], timestamp=0.1 * i) is not None:
            tracked += 1
    sys_.shutdown()
    launches, matrix_launches = HAMMING_BEST2_KERNEL.launches, HAMMING_KERNEL.launches

    ate, length = _ate(sys_.trajectory_kitti(), gt)
    ms = 1e3 * np.asarray(sys_.frame_times)
    kf_rows = [r for r in sys_.metrics if r["keyframe"]]
    ms_kf = [r["ms_total"] for r in kf_rows]
    ms_map = [r["ms_mapping"] for r in kf_rows]
    ba_ms = [1e3 * s for s, _ in lm.ba_solve_times]
    n_created = int(sys_.map.next_mp)
    n_init = int((sys_.map.mp_first_kf == 0).sum())
    occ = int((sys_.occupancy_grid().data == 100).sum())
    log(f"kitti mapping drive {cfg.width}x{cfg.height}: {tracked}/{N_MAP_FRAMES} tracked, "
        f"{sys_.map.n_kf} live keyframes ({sys_.map.next_kf} created), "
        f"{len(ba_ms)} local BA solves, {sys_.map.next_mp} map points created "
        f"({int(sys_.map.mp_valid.sum())} live), {occ} occupied grid cells, "
        f"ATE {ate:.4f} m over {length:.3f} m")
    log(f"per-frame ms (host clock): median {np.median(ms):.2f}, median over keyframe frames "
        f"{np.median(ms_kf):.2f}, max {ms.max():.2f}")
    log(f"ms_mapping per keyframe frame: {[round(x, 2) for x in ms_map]}")
    log(f"local BA ms per solve (15 LM iterations, ends in the device->host read): "
        f"{[round(x, 2) for x in ba_ms]}")
    log(f"hamming_best2 launches: {launches} in the drive, {counts['mapping']} from the mapping "
        f"units over {counts['keyframes']} keyframes "
        f"({counts['mapping'] / max(counts['keyframes'], 1):.1f} per keyframe); "
        f"hamming_matrix launches: {matrix_launches}")
    if tracked < N_MAP_FRAMES - 2:
        raise AssertionError(f"tracked {tracked}/{N_MAP_FRAMES} frames")
    if sys_.map.next_kf < 4:
        raise AssertionError(f"only {sys_.map.next_kf} keyframes")
    if len(ba_ms) < 2:
        raise AssertionError(f"only {len(ba_ms)} local BA solves")
    if n_created - n_init <= 0:
        raise AssertionError("no map points beyond the initial keyframe's")
    if occ <= 0:
        raise AssertionError("empty occupancy grid")
    if not (np.isfinite(ate) and ate < 0.05 * length):
        raise AssertionError(f"ATE {ate:.4f} m is not below 5% of {length:.3f} m")
    if counts["mapping"] <= 0:
        raise AssertionError("the mapping units never launched hamming_best2")
    if matrix_launches != 0:
        raise AssertionError(f"the mapping drive launched hamming_matrix {matrix_launches} times")
    return {"launches": launches, "mapping_launches": counts["mapping"],
            "keyframes": counts["keyframes"], "matrix_launches": matrix_launches}


def _sim3_matches(rng, n=500):
    """Matched points in two camera frames under a known rigid S12 (25%
    gross outliers) with noisy KITTI-intrinsic pixels."""
    ang = np.deg2rad(9.0)
    R12 = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    x2 = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 12, n)], 1)
    x1 = x2 @ R12.T + np.array([0.4, -0.1, 0.3])
    bad = rng.random(n) < 0.25
    x1[bad] += rng.normal(0, 1.0, (bad.sum(), 3))

    def proj(x):
        return np.stack([718.856 * x[:, 0] / x[:, 2] + 607.19, 718.856 * x[:, 1] / x[:, 2] + 185.22], 1)

    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return (f(x1), f(x2), f(proj(x1) + rng.normal(0, 0.5, (n, 2))),
            f(proj(x2) + rng.normal(0, 0.5, (n, 2))), f(np.ones(n)), f(np.full(n, 1.44)),
            torch.ones(n, dtype=torch.bool))


def _pnp_matches(rng, n=2000):
    """A frame's 2000 feature slots, 40% matched to map points under a known
    pose, 30% of those gross outliers."""
    xw = np.stack([rng.uniform(-4, 4, n), rng.uniform(-2, 2, n), rng.uniform(5, 15, n)], 1)
    a = np.deg2rad(4.0)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    xc = xw @ R.T + np.array([0.1, 0.0, -0.3])
    uv = np.stack([718.856 * xc[:, 0] / xc[:, 2] + 607.19, 718.856 * xc[:, 1] / xc[:, 2] + 185.22], 1)
    uv += rng.normal(0, 0.5, uv.shape)
    bad = rng.random(n) < 0.3
    uv[bad] += rng.uniform(-40, 40, (bad.sum(), 2))
    valid = rng.random(n) < 0.4
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return [f(xw), f(uv), f(np.ones(n)), torch.from_numpy(valid)], valid


def _ring_pose_graph(rng, K=24, K_pad=32, E_pad=256):
    """Keyframes on a circle with accumulated drift, odometry and covisibility
    edges and one loop edge, padded as loop closing pads it."""
    from orb_slam2_2021_tpu_torch.geometry.sim3 import sim3_compose, sim3_exp, sim3_inverse
    from orb_slam2_2021_tpu_torch.optim.sim3_opt import PoseGraph

    ang = torch.linspace(0, 2 * np.pi * (K - 1) / K, K)
    xi = torch.zeros(K, 7)
    xi[:, 4] = ang
    xi[:, 0] = 3.0 * torch.cos(ang)
    xi[:, 2] = 3.0 * torch.sin(ang)
    gt = sim3_exp(xi)
    drift = torch.from_numpy(rng.normal(0, 0.01, (K, 7)).astype(np.float32)).cumsum(0)
    drift[:, 6] = 0
    est = sim3_compose(*sim3_exp(drift), *gt)
    ei = list(range(K - 1)) + list(range(K - 3)) + [K - 1]
    ej = list(range(1, K)) + list(range(3, K)) + [0]
    meas = []
    for e, (a, b) in enumerate(zip(ei, ej)):
        S = gt if e == len(ei) - 1 else est
        meas.append(sim3_compose(S[0][a], S[1][a], S[2][a], *sim3_inverse(S[0][b], S[1][b], S[2][b])))

    def pad(x, n, fill):
        out = fill(n)
        out[: len(x)] = x
        return out

    eye = lambda n: torch.eye(3).repeat(n, 1, 1)  # noqa: E731
    zeros3 = lambda n: torch.zeros(n, 3)  # noqa: E731
    zeros_i = lambda n: torch.zeros(n, dtype=torch.int64)  # noqa: E731
    return PoseGraph(
        s=pad(est[0], K_pad, torch.ones), R=pad(est[1], K_pad, eye), t=pad(est[2], K_pad, zeros3),
        edge_i=pad(torch.tensor(ei), E_pad, zeros_i), edge_j=pad(torch.tensor(ej), E_pad, zeros_i),
        m_s=pad(torch.stack([m[0] for m in meas]), E_pad, torch.ones),
        m_R=pad(torch.stack([m[1] for m in meas]), E_pad, eye),
        m_t=pad(torch.stack([m[2] for m in meas]), E_pad, zeros3),
        weight=pad(torch.ones(len(ei)), E_pad, torch.zeros),
        fixed=pad(torch.arange(K) == 0, K_pad, lambda n: torch.ones(n, dtype=torch.bool)),
    )


def check_loop_numerics(dev):
    """Loop-closing units on the card against the CPU path (held against the
    JAX reference by the tests), the same RANSAC samples on both devices;
    each timed on the card by CUDA events. Returns {unit: ms}."""
    from orb_slam2_2021_tpu_torch.optim.sim3_opt import essential_graph_solve, optimize_sim3_relative
    from orb_slam2_2021_tpu_torch.place.bundle import PlaceRecognition
    from orb_slam2_2021_tpu_torch.solvers.epnp import epnp_ransac
    from orb_slam2_2021_tpu_torch.solvers.horn_sim3 import sample_indices, sim3_ransac

    rng = np.random.default_rng(3)
    ms = {}
    pr = PlaceRecognition.load_default(dev)
    desc = torch.from_numpy(rng.integers(0, 2 ** 32, (2000, 8), dtype=np.uint32).view(np.int32))
    valid = torch.from_numpy(rng.random(2000) < 0.95)
    dd, dv = desc.to(dev), valid.to(dev)
    words = pr.transform(dd, dv)
    if not torch.equal(words.cpu(), pr.transform(desc, valid)):
        raise AssertionError("vocab_transform: CUDA words differ from the CPU path")
    ms["vocab_transform_2000"] = time_ms(lambda: pr.transform(dd, dv), iters=20)
    log(f"vocab_transform, 10^6-word tree, 2000 descriptors: CUDA == CPU (tolerance 0), "
        f"{ms['vocab_transform_2000']:.3f} ms")

    fx, fy, cx, cy = 718.856, 718.856, 607.19, 185.22
    args = _sim3_matches(rng)
    idx = sample_indices(np.ones(500, bool), 3, 128, torch.Generator().manual_seed(2000))
    out = {}
    for d in ("cpu", dev):
        a = [x.to(d) for x in args]
        s, R, t, inl, _ = sim3_ransac(idx.to(d), *a, fx, fy, cx, cy, True)
        sr, Rr, tr, inr, _ = optimize_sim3_relative(s, R, t, *a[:4], 1.0 / a[4], 1.0 / a[5], a[6],
                                                    fx, fy, cx, cy, True)
        out[str(d)] = [x.cpu() for x in (R, t, inl, Rr, tr, inr)]
    c, g = out["cpu"], out[str(dev)]
    dR = max(float((c[0] - g[0]).abs().max()), float((c[3] - g[3]).abs().max()))
    dt = max(float((c[1] - g[1]).abs().max()), float((c[4] - g[4]).abs().max()))
    if not (torch.equal(c[2], g[2]) and torch.equal(c[5], g[5])) or dR > 1e-4 or dt > 1e-3:
        raise AssertionError(f"Sim3 RANSAC/refine: CUDA vs CPU inliers differ or R {dR:.2e} / t {dt:.2e}")
    a = [x.to(dev) for x in args]
    di = idx.to(dev)
    ms["sim3_ransac_128x500"] = time_ms(lambda: sim3_ransac(di, *a, fx, fy, cx, cy, True), iters=10)
    s0, R0, t0 = (x.to(dev) for x in (torch.tensor(1.0), c[0], c[1]))
    ms["sim3_refine_500"] = time_ms(lambda: optimize_sim3_relative(
        s0, R0, t0, *a[:4], 1.0 / a[4], 1.0 / a[5], a[6], fx, fy, cx, cy, True), iters=5, warm=2)
    log(f"Sim3 RANSAC (128 hypotheses, 500 matches) + refine: inlier masks identical, R within "
        f"{dR:.2e}, t within {dt:.2e} m (tolerances 1e-4, 1e-3); {ms['sim3_ransac_128x500']:.3f} ms "
        f"and {ms['sim3_refine_500']:.3f} ms")

    pargs, pvalid = _pnp_matches(rng)
    pidx = sample_indices(pvalid, 6, 256, torch.Generator().manual_seed(21))
    out = {}
    for d in ("cpu", dev):
        out[str(d)] = [x.cpu() for x in epnp_ransac(pidx.to(d), *[x.to(d) for x in pargs], fx, fy, cx, cy)]
    c, g = out["cpu"], out[str(dev)]
    dR, dt = float((c[0] - g[0]).abs().max()), float((c[1] - g[1]).abs().max())
    # the refit's normal equations are float32 products summed in another
    # order by cuBLAS, so a match on the chi2 gate can flip: a rate, not
    # identity
    n_flip = int((c[2] != g[2]).sum())
    if n_flip > max(2, int(0.01 * int(c[3]))) or dR > 1e-3 or dt > 1e-2:
        raise AssertionError(f"EPnP RANSAC: CUDA vs CPU {n_flip} inliers differ, R {dR:.2e} / t {dt:.2e}")
    pa, pi = [x.to(dev) for x in pargs], pidx.to(dev)
    ms["epnp_ransac_256x2000"] = time_ms(lambda: epnp_ransac(pi, *pa, fx, fy, cx, cy), iters=5, warm=2)
    log(f"EPnP RANSAC (256 hypotheses, 2000 slots, {int(c[3])} inliers on the CPU, {int(g[3])} on "
        f"the card): {n_flip} inlier flags differ (tolerance 1% of the inliers), R within {dR:.2e}, "
        f"t within {dt:.2e} m (tolerances 1e-3, 1e-2); {ms['epnp_ransac_256x2000']:.3f} ms")

    gph = _ring_pose_graph(rng)
    sc, Rc, tc = essential_graph_solve(gph, fix_scale=True)
    gg = type(gph)(*(x.to(dev) for x in gph))
    first = essential_graph_solve(gg, fix_scale=True)
    again = essential_graph_solve(gg, fix_scale=True)
    dR = float((Rc - first[1].cpu()).abs().max())
    dt = float((tc - first[2].cpu()).abs().max())
    if not all(torch.equal(x, y) for x, y in zip(first, again)) or dR > 1e-4 or dt > 1e-3:
        raise AssertionError(f"essential graph: not repeatable on the card, or R {dR:.2e} / t {dt:.2e}")
    ms["essential_graph_K32_E256"] = time_ms(lambda: essential_graph_solve(gg, fix_scale=True),
                                             iters=2, warm=1)
    log(f"essential graph (32 vertices, 256 edges, 20 LM x 40 PCG): repeatable on the card, "
        f"R within {dR:.2e}, t within {dt:.2e} m of the CPU path (tolerances 1e-4, 1e-3); "
        f"{ms['essential_graph_K32_E256']:.1f} ms")
    return ms


def check_reloc_small_against_cpu(dev):
    """A map from the port's CPU path at 320x240 (the drive of
    tests/test_persistence.py), saved, booted on CUDA and on the CPU, both
    shown the frame at gt[8]: same keyframe, poses within 1 mm / 1e-3."""
    import tempfile

    from orb_slam2_2021_tpu_torch.config import synthetic_config
    from orb_slam2_2021_tpu_torch.pipeline.system import System

    cfg = synthetic_config(width=320, height=240)
    frames, _ = render_frames(cfg, 28, 0.12, 6)
    t0 = time.perf_counter()
    cpu = System(cfg, device="cpu")
    for i, pair in enumerate(frames):
        cpu.track_stereo(pair[0], pair[1], timestamp=0.1 * i)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.npz")
        cpu.save_map(path)
        log(f"320x240 map on the CPU path: {cpu.map.n_kf} keyframes, "
            f"{int(cpu.map.mp_valid.sum())} map points, {time.perf_counter() - t0:.1f} s")
        booted = {d: System.from_map_file(cfg, path, device=d) for d in ("cpu", dev)}
    res = {}
    for d, s in booted.items():
        landed = {}
        bow = s.tracker._relocalize_bow

        def hooked(*a, s=s, bow=bow, landed=landed):
            ok = bow(*a)
            landed["kf"] = s.tracker.ref_kf if ok else None
            return ok

        s.tracker._relocalize_bow = hooked
        pose = s.track_stereo(frames[8][0], frames[8][1], timestamp=99.0)
        res[d] = (pose, landed.get("kf"), s.tracker.state.name)
    (pc, kc, sc), (pg, kg, sg) = res["cpu"], res[dev]
    if pc is None or pg is None or kc is None or kc != kg or sc != sg or sg != "OK":
        raise AssertionError(f"320x240 relocalization: CUDA {kg} {sg} vs CPU {kc} {sc}")
    worst = max(float(np.abs(pg[1] - pc[1]).max()), float(np.abs(pg[0] - pc[0]).max()))
    log(f"320x240 save/load/relocalize: CUDA and CPU both on keyframe {kg}, state OK, "
        f"max pose diff {worst:.2e} (tolerance 1e-3)")
    if worst > 1e-3:
        raise AssertionError("320x240 relocalization: CUDA and CPU poses differ beyond 1e-3")


def drive_kitti_default(dev, frames, gt):
    """The System at the reference's defaults over the whole orbit at KITTI
    width. Hamming launches are counted per path: all of them over the
    drive, those inside the mapping units, inside loop closing, and per loop
    stage; the loop closer's Hamming shapes are recorded."""
    import tempfile

    from orb_slam2_2021_tpu_torch.config import kitti_stereo_config
    from orb_slam2_2021_tpu_torch.frontend import matchers
    from orb_slam2_2021_tpu_torch.ops.hamming import HAMMING_BEST2_KERNEL, HAMMING_KERNEL, hamming_best2
    from orb_slam2_2021_tpu_torch.pipeline import mapping_steps
    from orb_slam2_2021_tpu_torch.pipeline.system import System

    cfg = kitti_stereo_config()
    sys_ = System(cfg, device=dev)
    lm, lc = sys_.local_mapper, sys_.loop_closer
    if lc is None or sys_.place.voc.L != 6:
        raise AssertionError("the default System has no loop closer or not the 10^6-word vocabulary")
    counts = {"mapping_and_loop": 0, "loop_closing": 0, "compute_sim3": 0, "correct_loop": 0}
    shapes = set()
    loops, replays = [], []

    def counting(fn, key, record_shapes=False):
        def wrapped(*a, **kw):
            n0 = HAMMING_BEST2_KERNEL.launches
            if record_shapes:
                def rec(x, y, mask):  # (N, M, T): T = 0 for a [M, 8] side
                    shapes.add((int(x.shape[0]), int(y.shape[-2]), int(y.shape[0]) if y.dim() == 3 else 0))
                    return hamming_best2(x, y, mask)
                matchers.hamming_best2 = mapping_steps.hamming_best2 = rec
            try:
                return fn(*a, **kw)
            finally:
                matchers.hamming_best2 = mapping_steps.hamming_best2 = hamming_best2
                counts[key] += HAMMING_BEST2_KERNEL.launches - n0
        return wrapped

    correct = lc._correct_loop

    def correct_hook(k, loop_kf, *a):
        loops.append((len(sys_.frame_times), k, loop_kf))
        return correct(k, loop_kf, *a)

    lc._correct_loop = correct_hook
    lm.process_pending = counting(lm.process_pending, "mapping_and_loop")
    lc.process_pending = counting(lc.process_pending, "loop_closing")
    lc._compute_sim3 = counting(lc._compute_sim3, "compute_sim3", record_shapes=True)
    lc._correct_loop = counting(lc._correct_loop, "correct_loop", record_shapes=True)
    process_new = sys_.grid_mapper.process_new

    def grid_hook(loop_closed=False):
        if loop_closed:
            replays.append(len(sys_.frame_times))
        return process_new(loop_closed)

    sys_.grid_mapper.process_new = grid_hook

    HAMMING_BEST2_KERNEL.launches = HAMMING_KERNEL.launches = 0
    tracked = 0
    for i, pair in enumerate(frames):
        if sys_.track_stereo(pair[0], pair[1], timestamp=0.1 * i) is not None:
            tracked += 1
    sys_.shutdown()
    launches, matrix_launches = HAMMING_BEST2_KERNEL.launches, HAMMING_KERNEL.launches

    est = sys_.trajectory_kitti()
    ate, length = _ate(est, gt)
    ms = 1e3 * np.asarray(sys_.frame_times)
    log(f"kitti default-System drive {cfg.width}x{cfg.height}: {tracked}/{len(frames)} tracked, "
        f"{sys_.map.n_kf} live keyframes ({sys_.map.next_kf} created), "
        f"{int(sys_.map.mp_valid.sum())} live map points, {lc.n_loops} loop(s), "
        f"ATE {ate:.4f} m over {length:.3f} m")
    log(f"per-frame ms (host clock): median {np.median(ms):.2f}, max {ms.max():.2f}")
    for frame, k, loop_kf in loops:
        log(f"loop at frame {frame}: keyframe {k} against keyframe {loop_kf} "
            f"(JAX reference on the CPU: frame {REF_LOOP_FRAME}, keyframe {REF_LOOP_PAIR[0]} "
            f"against keyframe {REF_LOOP_PAIR[1]})")
    lt = lc.loop_times
    if loops:
        f0 = loops[0][0]
        log(f"loop frame {f0}: {ms[f0]:.1f} ms in all; compute_sim3 {1e3 * lt['compute_sim3']:.1f} ms, "
            f"correction {1e3 * lt['correct']:.1f} ms, essential graph {1e3 * lt['essential_graph']:.1f} ms, "
            f"global BA {1e3 * lt['global_ba']:.1f} ms ({len(lc.gba_iter_times)} iterations, "
            f"{1e3 * lc.gba_iter_times[0]:.1f} ms each); grid replayed at frames {replays}")
    mapping_units = counts["mapping_and_loop"] - counts["loop_closing"]
    log(f"hamming_best2 launches: {launches} in the drive, {mapping_units} from the mapping units, "
        f"{counts['loop_closing']} from loop closing ({counts['compute_sim3']} in compute_sim3, "
        f"{counts['correct_loop']} in correct_loop); loop-closing shapes (N, M, T) {sorted(shapes)}; "
        f"hamming_matrix launches: {matrix_launches}")
    if tracked < len(frames) - 2:
        raise AssertionError(f"tracked {tracked}/{len(frames)} frames")
    if lc.n_loops < 1 or not loops:
        raise AssertionError("no loop closed")
    if (loops[0][1], loops[0][2]) != REF_LOOP_PAIR or abs(loops[0][0] - REF_LOOP_FRAME) > 5:
        raise AssertionError(f"loop {loops[0]} is not the reference's pair {REF_LOOP_PAIR} "
                             f"near frame {REF_LOOP_FRAME}")
    if len(lc.gba_iter_times) < 1:
        raise AssertionError("global BA never ran")
    if not replays or replays[0] != loops[0][0]:
        raise AssertionError(f"the grid was not replayed on the loop frame: {replays}")
    if not (np.isfinite(ate) and ate < 0.05 * length):
        raise AssertionError(f"ATE {ate:.4f} m is not below 5% of {length:.3f} m")
    if counts["loop_closing"] <= 0 or mapping_units <= 0:
        raise AssertionError("mapping or loop closing never launched hamming_best2")
    if matrix_launches != 0:
        raise AssertionError(f"the default drive launched hamming_matrix {matrix_launches} times")

    # save, boot from the file on the card, relocalize a mid-orbit frame; its
    # camera centre, put in the ground truth's frame by the drive's ATE
    # alignment, must meet the ATE bound
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.npz")
        sys_.save_map(path)
        booted = System.from_map_file(cfg, path, device=dev)
    t0 = time.perf_counter()
    pose = booted.track_stereo(frames[RELOC_FRAME][0], frames[RELOC_FRAME][1], timestamp=99.0)
    t_reloc = time.perf_counter() - t0
    if pose is None or booted.tracker.state.name != "OK":
        raise AssertionError("relocalization against the reloaded KITTI-width map failed")
    c_reloc = -pose[0].T @ pose[1]
    to_gt = _ate_alignment(est, gt)
    err = float(np.linalg.norm(to_gt(c_reloc) - gt[RELOC_FRAME][1]))
    d = float(np.linalg.norm(c_reloc - est[RELOC_FRAME][:3, 3]))
    log(f"reloaded map ({booted.map.n_kf} keyframes): frame {RELOC_FRAME} relocalized on keyframe "
        f"{booted.tracker.ref_kf} in {1e3 * t_reloc:.1f} ms; aligned error {err:.4f} m against the "
        f"ground truth (bound 5% of {length:.3f} m), {d:.4f} m from the drive's own estimate")
    if not err < 0.05 * length:
        raise AssertionError(f"relocalized {err:.3f} m away from the ground truth")
    return {"launches": launches, "mapping_launches": mapping_units,
            "loop_launches": counts["loop_closing"], "shapes": sorted(shapes),
            "matrix_launches": matrix_launches}


def check_hamming_loop_shapes(dev, shapes):
    """Phase 11: both launchers at the two largest shapes loop closing gave
    the fused launcher in the drive, exactly, with a half-open mask (the
    descriptor-only matcher's mask is valid x valid); both timed."""
    rng = np.random.default_rng(2)
    max_err, times = 0, {}
    for n, m, t in sorted(shapes, key=lambda s: s[0] * s[1] * max(s[2], 1))[-2:]:
        a, b, mask = hamming_inputs(rng, n, m, t or None, 0.5, dev)
        label = f"{n}x{m}" + (f" T={t}" if t else "")
        max_err = max(max_err, hold_hamming(a, b, mask, f"{label} (loop-closing shape)"))
        times[f"loop {label}"] = time_hamming(a, b, mask, f"{label} (loop-closing shape)", iters=20)
    return max_err, times


def drive_kitti(dev):
    from orb_slam2_2021_tpu_torch.config import kitti_stereo_config
    from orb_slam2_2021_tpu_torch.io.trajectory import ate_rmse
    from orb_slam2_2021_tpu_torch.frontend.frame import build_stereo_frame_from_u8
    from orb_slam2_2021_tpu_torch.ops.hamming import HAMMING_BEST2_KERNEL, HAMMING_KERNEL
    from orb_slam2_2021_tpu_torch.pipeline.system import System

    cfg = kitti_stereo_config()
    frames, gt = render_frames(cfg, N_FRAMES, STEP, WORLD_SEED)
    sys_ = System(cfg, enable_mapping=False, device=dev)

    # every Frame tensor lives on the card
    frame = build_stereo_frame_from_u8(torch.from_numpy(frames[0]).to(dev), cfg)
    tensors = list(frame.kp) + [frame.u_right, frame.depth, frame.sad_dist]
    if not all(t.device.type == "cuda" for t in tensors):
        raise AssertionError("a Frame tensor is not on the card")
    if frame.kp.capacity != cfg.orb.n_features:
        raise AssertionError("frame capacity differs from n_features")

    HAMMING_BEST2_KERNEL.launches = HAMMING_KERNEL.launches = 0
    tracked = 0
    for i, pair in enumerate(frames):
        if sys_.track_stereo(pair[0], pair[1], timestamp=0.1 * i) is not None:
            tracked += 1
    sys_.shutdown()
    launches, matrix_launches = HAMMING_BEST2_KERNEL.launches, HAMMING_KERNEL.launches

    est = sys_.trajectory_kitti()
    gt_mats = []
    for R, t in gt[: len(est)]:
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        gt_mats.append(T)
    ate = ate_rmse(est, gt_mats)
    length = float(sum(np.linalg.norm(gt[i + 1][1] - gt[i][1]) for i in range(N_FRAMES - 1)))
    ms = 1e3 * np.asarray(sys_.frame_times)
    log(f"kitti drive {cfg.width}x{cfg.height}, {cfg.orb.n_features} features: "
        f"{tracked}/{N_FRAMES} tracked, {sys_.map.n_kf} keyframes, ATE {ate:.4f} m over {length:.3f} m, "
        f"hamming_best2 launches {launches} ({launches / N_FRAMES:.1f} per frame), "
        f"hamming_matrix launches {matrix_launches}")
    log(f"per-frame ms (host clock, each frame ends in a device->host read): median "
        f"{np.median(ms):.2f}, median after the first frame {np.median(ms[1:]):.2f}, "
        f"first {ms[0]:.2f}, max {ms.max():.2f}")
    if tracked < N_FRAMES - 2:
        raise AssertionError(f"tracked {tracked}/{N_FRAMES} frames")
    if sys_.map.n_kf < 2:
        raise AssertionError(f"only {sys_.map.n_kf} keyframes")
    if not (np.isfinite(ate) and ate < 0.05 * length):
        raise AssertionError(f"ATE {ate:.4f} m is not below 5% of {length:.3f} m")
    if launches <= 0:
        raise AssertionError("the lane drive never launched hamming_best2")
    if matrix_launches != 0:
        raise AssertionError(f"the lane drive launched hamming_matrix {matrix_launches} times")
    return {"launches": launches, "matrix_launches": matrix_launches}


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, REPO)
    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    dev = torch.device("cuda:0")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    info = card_info()
    log(info)
    frames, gt = render_orbit()  # forks: before the first CUDA call

    from orb_slam2_2021_tpu_torch.ops.hamming import HAMMING_BEST2_KERNEL, HAMMING_KERNEL

    t0 = time.perf_counter()
    HAMMING_KERNEL.build()
    HAMMING_BEST2_KERNEL.build()  # the same library: one nvcc
    log(f"built {HAMMING_KERNEL.source} in {time.perf_counter() - t0:.2f} s")

    max_err, times = check_hamming(dev)
    check_small_against_cpu(dev)
    lane = drive_kitti(dev)
    err, mapping_times = check_hamming_mapping_shapes(dev)
    max_err = max(max_err, err)
    times.update(mapping_times)
    check_mapping_small_against_cpu(dev)
    mapping = drive_kitti_mapping(dev, frames, gt)
    unit_ms = check_loop_numerics(dev)
    check_reloc_small_against_cpu(dev)
    loop = drive_kitti_default(dev, frames, gt)
    err, loop_times = check_hamming_loop_shapes(dev, loop["shapes"])
    max_err = max(max_err, err)
    times.update(loop_times)

    log(f"plain PyTorch loop-closing units on the card (ms): {json.dumps(unit_ms)}")
    log(f"card: {info}")
    common = {"route": "cuda", "source": "orb_slam2_2021_tpu_torch/csrc/hamming.cu",
              "replaces": "orb_slam2_2021_tpu/ops/hamming_pallas.py:37", "max_abs_err": max_err}
    kernels = []
    for name, launches in (("hamming_best2", {
            "launches": loop["launches"],
            "launches_mapping_units": loop["mapping_launches"],
            "launches_loop_closing": loop["loop_launches"],
            "launches_mapping_drive": mapping["launches"],
            "launches_lane_drive": lane["launches"]}),
            ("hamming_matrix", {  # no main-path caller is left: each drive asserts 0
                "launches": loop["matrix_launches"],
                "launches_mapping_drive": mapping["matrix_launches"],
                "launches_lane_drive": lane["matrix_launches"]})):
        head = times["lane"][name]  # the local-point search's shape, 4096 x 2000
        kernels.append({"name": name, **common, **launches,
                        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                        "shape": head["shape"],
                        "shapes": [{"at": where, **row[name]} for where, row in times.items()]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
