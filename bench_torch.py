"""Benchmark of the PyTorch/CUDA port, end to end: the counterpart of
bench.py's headline for `orb_slam2_2021_tpu_torch`.

    python3 bench_torch.py [--device cuda|cpu]

Drives System(kitti_stereo_config(), async_mode=True) (tracking lane,
mapping worker with loop closing and the grid, global BA thread, each on its
own CUDA stream) with a one-frame prefetch (`track_stereo_prefetch`: frame
i+1's upload and build are enqueued between frame i's fused track step and
its readback) over bench.py's sequence: SyntheticCylinderWorld(seed 7) on
orbit_trajectory(144 frames, 630 degrees, r 1.5 m) at KITTI width, the first
12 frames untimed. Prints one JSON line, {"metric": "e2e_stereo_slam_fps",
...}, as bench.py does. `extra` opens with bench.py's front-end microloop
(`frontend_fps`: the stereo frame build and the motion-only track step,
`frontend_step`, timed over 30 steps back to back; -1 under BENCH_LEAN=1),
its ms a step and its kernel launches a step (profiler, on a card), then
what the port measures of the drives (bench.py's speed-of-light probes are
JAX code and have no counterpart here). A second drive over bench.py's
scenario B (never-trained grating textures, out and back, no large loop)
fills `scenario_novel_texture` unless BENCH_LEAN=1. BENCH_SMALL=1 runs 40
frames at 320x240 (a quick check, e.g. with --device cpu); BENCH_METRICS
names the per-frame metrics file (bench_torch_metrics.ndjson).

Nothing of the JAX package is imported.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
WARMUP_FRAMES = 12   # untimed: initialization and the first keyframes
N_FRAMES = 144       # bench.py's orbit: a full circuit plus 270 degrees of revisit
SMALL = os.environ.get("BENCH_SMALL", "") == "1"
LEAN = os.environ.get("BENCH_LEAN", "") == "1"
FRONTEND_STEPS = 30     # bench.py's time_device(n=30)
FRONTEND_RADIUS = 7.0   # px, the microloop's projection-search radius


def _stage(msg):
    print(f"[bench_torch +{time.perf_counter() - _T0:.1f}s] {msg}", file=sys.stderr, flush=True)


_T0 = time.perf_counter()


def drive(sys_, frames, warmup_frames, hook=None):
    """Prefetch-pipelined drive over uint8 (left, right) pairs: returns the
    frames per second over the frames after the first `warmup_frames`.
    `hook(i)`, if given, runs before frame i; its time counts as the
    frame's."""
    nxt = sys_.prefetch_stereo(frames[0][0], frames[0][1])
    t_start = time.perf_counter()
    for i in range(len(frames)):
        if i == warmup_frames:
            t_start = time.perf_counter()
        if hook is not None:
            hook(i)
        cur, nxt = nxt, None
        _, nxt = sys_.track_stereo_prefetch(cur, frames[i + 1] if i + 1 < len(frames) else None,
                                            timestamp=i * 0.1)
    return (len(frames) - warmup_frames) / (time.perf_counter() - t_start)


def frontend_step(cfg, device):
    """bench.py's front-end microloop step (`_frontend_fps`) on the port:
    `build_stereo_frame`, then `motion_track_step` (`match_last_frame`,
    which launches hamming_best2 on a card, and `pose_optimize`), on the
    reference's inputs: default_rng(0) uniform noise for the left image and
    its 8-px roll for the right, N random landmarks 15 m ahead with random
    descriptors (octave 0, angle 0, all valid), the identity pose and a
    radius of 7 px. Returns (step, inputs); step(*inputs) gives
    motion_track_step's (R, t, slot, inlier, n_inliers, n_matched)."""
    import torch

    from orb_slam2_2021_tpu_torch import resolve_device
    from orb_slam2_2021_tpu_torch.convert import camera_from_config, desc_from_numpy
    from orb_slam2_2021_tpu_torch.frontend.frame import build_stereo_frame
    from orb_slam2_2021_tpu_torch.pipeline.track_steps import motion_track_step

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    left = rng.uniform(0, 255, (cfg.height, cfg.width)).astype(np.float32)
    right = np.roll(left, -8, axis=1)
    n = cfg.orb.n_features
    last_xw = torch.from_numpy(rng.uniform(-10, 10, (n, 3)).astype(np.float32)
                               + np.float32([0, 0, 15.0])).to(dev)
    last_desc = desc_from_numpy(rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32), dev)
    last_oct = torch.zeros(n, dtype=torch.int32, device=dev)
    last_ang = torch.zeros(n, dtype=torch.float32, device=dev)
    last_valid = torch.ones(n, dtype=torch.bool, device=dev)
    R0 = torch.eye(3, dtype=torch.float32, device=dev)
    t0 = torch.zeros(3, dtype=torch.float32, device=dev)
    cam = camera_from_config(cfg)

    def step(image_left, image_right):
        frame = build_stereo_frame(image_left, image_right, cfg)
        return motion_track_step(cam, frame.kp, frame.u_right, R0, t0, last_xw, last_desc,
                                 last_oct, last_ang, last_valid, FRONTEND_RADIUS, cfg)

    return step, (torch.from_numpy(left).to(dev), torch.from_numpy(right).to(dev))


def frontend_extra(cfg, device, lean, steps=FRONTEND_STEPS):
    """The microloop's entries of `extra`: `frontend_fps` and
    `frontend_ms_per_step` over `steps` steps enqueued back to back after a
    warm-up step and fenced once at the end (torch.cuda.synchronize, no
    readback inside the loop), and `frontend_launches_per_step`, the kernels
    of one more step (torch.profiler; None on the CPU). All -1 when
    `lean`."""
    if lean:
        return {"frontend_fps": -1.0, "frontend_ms_per_step": -1.0, "frontend_launches_per_step": -1}
    import torch

    step, inputs = frontend_step(cfg, device)
    on_card = inputs[0].device.type == "cuda"
    fence = torch.cuda.synchronize if on_card else (lambda: None)
    step(*inputs)
    fence()
    t0 = time.perf_counter()
    for _ in range(steps):
        step(*inputs)
    fence()
    dt = (time.perf_counter() - t0) / steps
    launches = None
    if on_card:
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            step(*inputs)
            fence()
        launches = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    return {"frontend_fps": round(1.0 / dt, 2), "frontend_ms_per_step": round(1e3 * dt, 3),
            "frontend_launches_per_step": launches}


def grating_texture(rng, h, w):
    """bench.py's scenario-B texture (tests/test_place_novel_family.py):
    curved sinusoidal fringes, a family the vocabulary was not trained on."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.zeros((h, w), np.float32)
    for _ in range(4):
        fx, fy = rng.uniform(0.02, 0.12, 2)
        phase = rng.uniform(0, 2 * np.pi)
        warp = rng.uniform(0.5, 3.0)
        out += np.sin(fx * xs + fy * ys + warp * np.sin(0.01 * ys * xs / max(h, w)) + phase)
    out = (out - out.min()) / max(out.max() - out.min(), 1e-6)
    return (40 + 175 * out).astype(np.float32)


_WORLD = None


def _render(pose):
    R, t = pose
    return np.clip(np.stack(_WORLD.render(R, t)), 0, 255).astype(np.uint8)


def render_pairs(world, poses, workers=None):
    """uint8 pairs of `world` at `poses`, rendered by forked processes, one
    per core up to 8 (call it before anything touches the card)."""
    workers = workers or min(8, os.cpu_count() or 1)
    global _WORLD
    _WORLD = world
    try:
        with multiprocessing.get_context("fork").Pool(workers) as pool:
            return pool.map(_render, poses, chunksize=4)
    finally:
        _WORLD = None


def orbit_frames(cfg, n_frames):
    """bench.py's headline sequence: (uint8 pairs, ground-truth poses)."""
    from orb_slam2_2021_tpu_torch.io.synthetic import SyntheticCylinderWorld, orbit_trajectory

    gt = orbit_trajectory(n_frames, total_deg=630.0, r_orbit=1.5)
    return render_pairs(SyntheticCylinderWorld(cfg, seed=7), gt), gt


def novel_frames(cfg, n_frames):
    """bench.py's scenario B: an out-and-back lateral dolly along a wall of
    grating texture."""
    from orb_slam2_2021_tpu_torch.io.synthetic import SyntheticStereoWorld, forward_trajectory

    half = n_frames // 2
    out = forward_trajectory(half, step=0.14)
    gt = out + out[::-1][1: n_frames - half + 1]
    world = SyntheticStereoWorld(cfg, seed=7700)
    world.texture = grating_texture(np.random.default_rng(7700), world.tex_h, world.tex_w)
    return render_pairs(world, gt), gt


def ate_and_length(est, gt):
    from orb_slam2_2021_tpu_torch.io.trajectory import ate_rmse

    mats = []
    for R, t in gt:
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        mats.append(T)
    length = float(np.linalg.norm(np.diff([T[:3, 3] for T in mats], axis=0), axis=1).sum())
    return float(ate_rmse(est, mats[: len(est)])), length


def lost_frames(sys_):
    return [r["frame_id"] for r in sys_.metrics if r.get("state") == "LOST"]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    from orb_slam2_2021_tpu_torch.config import kitti_stereo_config, synthetic_config

    if SMALL:
        cfg, n_frames = synthetic_config(width=320, height=240), 40
    else:
        cfg, n_frames = kitti_stereo_config(), N_FRAMES
    _stage("render")
    frames, gt = orbit_frames(cfg, n_frames)
    novel = None if SMALL or LEAN else novel_frames(cfg, 96)

    import torch

    from orb_slam2_2021_tpu_torch.pipeline.system import System

    if torch.device(args.device).type == "cuda":
        from orb_slam2_2021_tpu_torch.ops.cuda_build import build_all
        from orb_slam2_2021_tpu_torch.ops.hamming import HAMMING_BEST2_KERNEL
        from orb_slam2_2021_tpu_torch.optim.pose import POSE_KERNEL

        build_all([HAMMING_BEST2_KERNEL, POSE_KERNEL])  # nvcc before the timed region
    _stage("frontend microloop")
    frontend = frontend_extra(cfg, args.device, LEAN)
    _stage("headline drive")
    sys_ = System(cfg, async_mode=True, device=args.device)
    e2e_fps = drive(sys_, frames, WARMUP_FRAMES)
    sys_.shutdown()
    sys_.save_metrics_ndjson(os.environ.get("BENCH_METRICS", "bench_torch_metrics.ndjson"))

    scenario_b = {}
    if novel is not None:
        _stage("scenario B")
        sys_b = System(cfg, async_mode=True, device=args.device)
        fps_b = drive(sys_b, novel[0], 8)
        sys_b.shutdown()
        ate_b, _ = ate_and_length(sys_b.trajectory_kitti(), novel[1])
        scenario_b = {"fps": round(fps_b, 2), "ate_rmse_m": round(ate_b, 4),
                      "n_loops": int(sys_b.loop_closer.n_loops), "n_keyframes": int(sys_b.map.n_kf),
                      "n_lost_frames": len(lost_frames(sys_b))}
    _stage("done")
    print(json.dumps(result_line(e2e_fps, sys_, gt, frontend, scenario_b, args.device)))


def result_line(e2e_fps, sys_, gt, frontend, scenario_b, device):
    """The line bench_torch.py prints: the headline drive's fps and what
    its System measured, `frontend` (frontend_extra's entries) first in
    `extra`, as bench.py orders it, and `scenario_b`."""
    import torch

    ate, traj_len = ate_and_length(sys_.trajectory_kitti(), gt)
    ba = sys_.local_mapper.ba_solve_times
    ba_ms_iter = (1e3 * sum(d for d, _ in ba[1:]) / max(sum(n for _, n in ba[1:]), 1)
                  if len(ba) > 1 else -1.0)
    gba = [r for r in sys_.loop_closer.gba_runs if r["iters"]] if sys_.loop_closer else []
    gba_ms_iter = (1e3 * sum(r["seconds"] for r in gba) / sum(r["iters"] for r in gba)
                   if gba else -1.0)
    lost = lost_frames(sys_)
    lost_spans = []
    for f in lost:
        if lost_spans and f == lost_spans[-1][1] + 1:
            lost_spans[-1][1] = f
        else:
            lost_spans.append([f, f])
    timed = sys_.metrics[WARMUP_FRAMES:]
    budget = {f"lane.{k}": round(float(np.mean([r[k] for r in timed])), 2)
              for k in ("ms_extract", "ms_track", "ms_mapping")} if timed else {}
    return {
        "metric": "e2e_stereo_slam_fps",
        "value": round(e2e_fps, 2),
        "unit": "frames/s",
        "vs_baseline": round(e2e_fps / 10.0, 2),
        "extra": {
            **frontend,
            "ate_rmse_m": round(ate, 4),
            "trajectory_len_m": round(traj_len, 2),
            "local_ba_ms_per_iter": round(ba_ms_iter, 3),
            "gba_ms_per_iter": round(gba_ms_iter, 3),
            "n_keyframes": int(sys_.map.n_kf),
            "n_map_points": int(sys_.map.mp_valid.sum()),
            "n_loops": int(sys_.loop_closer.n_loops) if sys_.loop_closer else 0,
            "n_frames": len(sys_.metrics),
            "n_lost_frames": len(lost),
            "lost_spans": lost_spans,
            "median_frame_ms": round(1e3 * float(np.median(sys_.frame_times[WARMUP_FRAMES:])), 2),
            "scenario_novel_texture": scenario_b,
            "frame_budget": budget,
            "device": torch.cuda.get_device_name(0) if torch.device(device).type == "cuda" else "cpu",
        },
    }


if __name__ == "__main__":
    main()
