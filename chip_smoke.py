"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero before the result lines are printed):
  1. require a CUDA card; print its name and power limit (nvidia-smi);
  2. build the hand-written kernels from csrc/ with nvcc, print build time;
  3. hold each kernel against its plain PyTorch version on the card, at the
     shapes the tracking lane gives it and at ragged sizes (exact equality),
     and time both with CUDA events;
  4. check the lane on a small input against the port's CPU path, which the
     tests/test_torch_*.py suite holds against the JAX reference;
  5. drive System(kitti_stereo_config(), enable_mapping=False) over frames
     rendered by SyntheticStereoWorld at KITTI width, counting the kernel's
     launches on that drive, and check tracking, keyframes, ATE and devices;
  6. hold the kernel against its plain version at the shapes local mapping
     gives it (one keyframe against 10 and 8 stacked keyframes), exactly;
  7. check the System with local mapping and the occupancy grid on, CUDA
     against the CPU path, on a 320x240 sequence;
  8. drive System(kitti_stereo_config(), enable_mapping=True,
     enable_loop_closing=False) over the bench's cylinder-world orbit at
     KITTI width, counting the kernel's launches from the mapping units
     apart from the lane's, and check tracking, keyframes, local BA solves,
     triangulated points, the grid and ATE.

The second-to-last line is a JSON object describing each kernel; the last
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
MAPPING_SHAPES = [(2000, 10 * 2000), (2000, 8 * 2000)]
N_MAP_FRAMES = 40    # first frames of the bench's 144-frame, 630-degree orbit
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


def time_ms(fn, iters=50):
    """Mean device time of one call, by CUDA events over `iters` calls
    after 5 warm-up calls."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_hamming(dev):
    from orb_slam2_2021_tpu_torch.ops import hamming as H

    rng = np.random.default_rng(0)
    max_err = 0
    times = {}
    for n, m in SHAPES:
        a = torch.from_numpy(rng.integers(-2**31, 2**31, (n, 8), dtype=np.int64).astype(np.int32)).to(dev)
        b = torch.from_numpy(rng.integers(-2**31, 2**31, (m, 8), dtype=np.int64).astype(np.int32)).to(dev)
        if n and m:  # near-duplicates so small distances occur too
            k = min(n, m) // 2
            b[:k] = a[:k] ^ (torch.rand((k, 8), device=dev) < 0.02).to(torch.int32)
        out = H.hamming_matrix(a, b)
        ref = H.hamming_matrix_plain(a, b)
        torch.cuda.synchronize()
        if out.dtype != torch.int16 or tuple(out.shape) != (n, m) or not torch.equal(out, ref):
            raise AssertionError(f"hamming kernel disagrees with plain at {n}x{m}")
        if n and m:
            max_err = max(max_err, int((out.int() - ref.int()).abs().max()))
        if (n, m) in ((2000, 2000), (4096, 2000)):
            # plain, kernel, kernel, plain: compare within one run
            p1 = time_ms(lambda: H.hamming_matrix_plain(a, b))
            k1 = time_ms(lambda: H.hamming_matrix(a, b))
            k2 = time_ms(lambda: H.hamming_matrix(a, b))
            p2 = time_ms(lambda: H.hamming_matrix_plain(a, b))
            times[(n, m)] = (min(k1, k2), min(p1, p2))
        log(f"hamming {n}x{m}: kernel == plain (tolerance 0)")
    for (n, m), (k, p) in times.items():
        log(f"hamming {n}x{m}: kernel {k:.4f} ms, plain {p:.4f} ms "
            f"(CUDA events, mean of 50 after warm-up, better of two runs)")
    return max_err, times


def check_hamming_mapping_shapes(dev):
    """The kernel at the mapping units' shapes, called as they call it (one
    [N, 8] side against T stacked keyframes reshaped to [T*M, 8]): exact
    equality with the plain version, then both timed in turns."""
    from orb_slam2_2021_tpu_torch.ops import hamming as H
    from orb_slam2_2021_tpu_torch.pipeline.mapping_steps import _hamming_batched

    rng = np.random.default_rng(1)
    times = {}
    for n, m in MAPPING_SHAPES:
        a = torch.from_numpy(rng.integers(-2**31, 2**31, (n, 8), dtype=np.int64).astype(np.int32)).to(dev)
        b = torch.from_numpy(rng.integers(-2**31, 2**31, (m, 8), dtype=np.int64).astype(np.int32)).to(dev)
        b[:n] = a ^ (torch.rand((n, 8), device=dev) < 0.02).to(torch.int32)
        out = H.hamming_matrix(a, b)
        ref = H.hamming_matrix_plain(a, b)
        T = m // 2000
        batched = _hamming_batched(a, b.view(T, 2000, 8))
        torch.cuda.synchronize()
        if not torch.equal(out, ref) or not torch.equal(batched, ref.view(n, T, 2000).permute(1, 0, 2)):
            raise AssertionError(f"hamming kernel disagrees with plain at {n}x{m}")
        p1 = time_ms(lambda: H.hamming_matrix_plain(a, b), iters=10)
        k1 = time_ms(lambda: H.hamming_matrix(a, b))
        k2 = time_ms(lambda: H.hamming_matrix(a, b))
        p2 = time_ms(lambda: H.hamming_matrix_plain(a, b), iters=10)
        times[(n, m)] = (min(k1, k2), min(p1, p2))
        log(f"hamming {n}x{m} (mapping shape): kernel == plain (tolerance 0); kernel "
            f"{times[(n, m)][0]:.4f} ms, plain {times[(n, m)][1]:.4f} ms (CUDA events, better of two runs)")
    return times


def render_frames(cfg, n_frames, step, seed):
    from orb_slam2_2021_tpu.io.synthetic import SyntheticStereoWorld, forward_trajectory

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
    from orb_slam2_2021_tpu.config import synthetic_config
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
    from orb_slam2_2021_tpu.config import synthetic_config
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
    from orb_slam2_2021_tpu.io.trajectory import ate_rmse

    gt_mats = []
    for R, t in gt[: len(est)]:
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        gt_mats.append(T)
    length = float(sum(np.linalg.norm(gt[i + 1][1] - gt[i][1]) for i in range(len(gt) - 1)))
    return ate_rmse(est, gt_mats), length


def drive_kitti_mapping(dev):
    """Mapping on at KITTI width over the first N_MAP_FRAMES frames of the
    bench's orbit in the cylinder world; Hamming launches from the mapping
    units are counted apart from the lane's."""
    from orb_slam2_2021_tpu.config import kitti_stereo_config
    from orb_slam2_2021_tpu.io.synthetic import SyntheticCylinderWorld, orbit_trajectory
    from orb_slam2_2021_tpu_torch.ops.hamming import HAMMING_KERNEL
    from orb_slam2_2021_tpu_torch.pipeline.system import System

    cfg = kitti_stereo_config()
    world = SyntheticCylinderWorld(cfg, seed=7)
    gt = orbit_trajectory(144, total_deg=630.0, r_orbit=1.5)[:N_MAP_FRAMES]
    t0 = time.perf_counter()
    frames = [np.clip(np.stack(world.render(R, t)), 0, 255).astype(np.uint8) for R, t in gt]
    log(f"rendered {len(frames)} cylinder-world frames in {time.perf_counter() - t0:.1f} s")
    sys_ = System(cfg, enable_mapping=True, enable_loop_closing=False, device=dev)

    lm = sys_.local_mapper
    counts = {"mapping": 0, "keyframes": 0}
    process = lm.process_pending

    def counted_process():
        n0, q = HAMMING_KERNEL.launches, len(lm.queue)
        process()
        counts["mapping"] += HAMMING_KERNEL.launches - n0
        counts["keyframes"] += q

    lm.process_pending = counted_process
    HAMMING_KERNEL.launches = 0
    tracked = 0
    for i, pair in enumerate(frames):
        if sys_.track_stereo(pair[0], pair[1], timestamp=0.1 * i) is not None:
            tracked += 1
    sys_.shutdown()
    launches = HAMMING_KERNEL.launches

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
    log(f"hamming launches: {launches} in the drive, {counts['mapping']} from the mapping units "
        f"over {counts['keyframes']} keyframes "
        f"({counts['mapping'] / max(counts['keyframes'], 1):.1f} per keyframe)")
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
        raise AssertionError("the mapping units never launched the Hamming kernel")
    return {"launches": launches, "mapping_launches": counts["mapping"],
            "keyframes": counts["keyframes"]}


def drive_kitti(dev):
    from orb_slam2_2021_tpu.config import kitti_stereo_config
    from orb_slam2_2021_tpu.io.trajectory import ate_rmse
    from orb_slam2_2021_tpu_torch.frontend.frame import build_stereo_frame_from_u8
    from orb_slam2_2021_tpu_torch.ops.hamming import HAMMING_KERNEL
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

    HAMMING_KERNEL.launches = 0
    tracked = 0
    for i, pair in enumerate(frames):
        if sys_.track_stereo(pair[0], pair[1], timestamp=0.1 * i) is not None:
            tracked += 1
    sys_.shutdown()
    launches = HAMMING_KERNEL.launches

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
        f"hamming launches {launches}")
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
        raise AssertionError("the drive never launched the Hamming kernel")
    return launches


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    sys.path.insert(0, REPO)
    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    dev = torch.device("cuda:0")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    info = card_info()
    log(info)

    from orb_slam2_2021_tpu_torch.ops.hamming import HAMMING_KERNEL

    t0 = time.perf_counter()
    HAMMING_KERNEL.build()
    log(f"built {HAMMING_KERNEL.source} in {time.perf_counter() - t0:.2f} s")

    max_err, times = check_hamming(dev)
    check_small_against_cpu(dev)
    launches = drive_kitti(dev)
    times.update(check_hamming_mapping_shapes(dev))
    check_mapping_small_against_cpu(dev)
    mapping = drive_kitti_mapping(dev)

    k_ms, p_ms = times[(4096, 2000)]
    log(f"card: {info}")
    print(json.dumps({"kernels": [{
        "name": "hamming_matrix",
        "route": "cuda",
        "source": "orb_slam2_2021_tpu_torch/csrc/hamming.cu",
        "replaces": "orb_slam2_2021_tpu/ops/hamming_pallas.py:37",
        "launches": mapping["launches"],
        "launches_mapping_units": mapping["mapping_launches"],
        "launches_lane_mapping_off": launches,
        "max_abs_err": max_err,
        "ms": k_ms,
        "plain_ms": p_ms,
        "shape": [4096, 2000],
        "shapes": [{"shape": [n, m], "ms": k, "plain_ms": p} for (n, m), (k, p) in times.items()],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
