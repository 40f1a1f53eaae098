"""The live System across two torch.distributed processes (counterpart of
scripts/dist_live_2proc.py).

Rank 0 (the leader) runs the System at its defaults (mapping and loop
closing on, synchronous) over the cylinder-world orbit, with a
`parallel.gba_service.GbaClient` in its loop closer; rank 1 runs a
`GbaServer`. When a closed loop starts its global BA, the map's problem is
shipped to rank 1 and solved landmark-sharded over both ranks, and rank 0
writes the result back. One card: both ranks share it under gloo; with two
cards each rank takes one and the group uses NCCL.

    python scripts/torch_dist_live_2proc.py [--device cuda|cpu] [--config synthetic|kitti]
        [--frames N] [--frames-file F.npz] [--no-ref] [--out DIR]

The parent renders the frames (or reads `--frames-file`: uint8 `frames`
[N, 2, H, W], `gt_R` [N, 3, 3], `gt_t` [N, 3]), runs a single-process
drive of the same System first (unless --no-ref), then the two ranks, and
checks: a loop closed, the server solved at least one problem, the leader
wrote a global BA back, at least N-2 frames tracked, and the ATE within
2.5x the single-process drive's (without it: below 5% of the path). It
prints one JSON line (`ok` and each role's summary) and exits 1 when a
check fails. The defaults (320x240, 128 frames of a 560-degree orbit) are
the reference script's.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

RANK_TIMEOUT_S = 1800.0


def _config(name):
    from orb_slam2_2021_tpu_torch.config import kitti_stereo_config, synthetic_config

    return kitti_stereo_config() if name == "kitti" else synthetic_config(width=320, height=240)


def render(cfg_name, n_frames, path):
    """The orbit's uint8 pairs and ground truth, saved to `path`: at KITTI
    size the bench's (630 degrees, seed 7), else the reference script's
    (560 degrees, seed 3)."""
    import bench_torch
    from orb_slam2_2021_tpu_torch.io.synthetic import SyntheticCylinderWorld, orbit_trajectory

    cfg = _config(cfg_name)
    if cfg_name == "kitti":
        frames, gt = bench_torch.orbit_frames(cfg, n_frames)
    else:
        gt = orbit_trajectory(n_frames, total_deg=560.0, r_orbit=1.5)
        frames = bench_torch.render_pairs(SyntheticCylinderWorld(cfg, seed=3), gt)
    np.savez(path, frames=np.asarray(frames, np.uint8), gt_R=np.asarray([R for R, _ in gt]),
             gt_t=np.asarray([t for _, t in gt]))


def drive(sys_, frames_file):
    """Track every frame; returns the drive's summary."""
    from orb_slam2_2021_tpu_torch.io.trajectory import ate_rmse
    from orb_slam2_2021_tpu_torch.ops.hamming import HAMMING_BEST2_KERNEL, HAMMING_KERNEL

    z = np.load(frames_file)
    frames, gt_R, gt_t = z["frames"], z["gt_R"], z["gt_t"]
    lc = sys_.loop_closer
    loops = []
    correct = lc._correct_loop

    def correct_hook(k, loop_kf, *a):
        loops.append([len(sys_.frame_times), int(k), int(loop_kf)])
        return correct(k, loop_kf, *a)

    lc._correct_loop = correct_hook
    HAMMING_BEST2_KERNEL.reset_counts()
    HAMMING_KERNEL.reset_counts()
    n_ok = 0
    for i, pair in enumerate(frames):
        if sys_.track_stereo(pair[0], pair[1], timestamp=0.1 * i) is not None:
            n_ok += 1
    sys_.shutdown()
    est = sys_.trajectory_kitti()
    mats = []
    for R, t in zip(gt_R, gt_t):
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        mats.append(T)
    length = float(np.linalg.norm(np.diff(gt_t, axis=0), axis=1).sum())
    return {
        "n_ok": n_ok, "n_frames": len(frames), "n_kf": int(sys_.map.n_kf),
        "ate": float(ate_rmse(est, mats[: len(est)])), "length": length,
        "loops": loops, "gba_runs": lc.gba_runs, "gba_iter_ms": [1e3 * s / n for r in lc.gba_runs for n, s in r.get("chunks", ())],
        "ms_median": float(1e3 * np.median(sys_.frame_times)),
        "hamming_best2_launches": HAMMING_BEST2_KERNEL.launches,
        "hamming_matrix_launches": HAMMING_KERNEL.launches,
    }


def role(name, args):
    import torch

    from orb_slam2_2021_tpu_torch.convert import camera_from_config
    from orb_slam2_2021_tpu_torch.parallel.gba_service import GbaClient, GbaServer
    from orb_slam2_2021_tpu_torch.parallel.multihost import finish_process, init_process
    from orb_slam2_2021_tpu_torch.pipeline.system import System

    cfg = _config(args.config)
    if name == "ref":
        out = drive(System(cfg, device=args.device), args.frames_file)
    else:
        rank = 0 if name == "leader" else 1
        group, dev = init_process(f"file://{os.path.join(args.out, 'rendezvous')}", 2, rank,
                                  device=args.device)
        work = os.path.join(args.out, "work")
        if name == "leader":
            client = GbaClient(group, cfg.optim, camera_from_config(cfg), work, dev)
            out = drive(System(cfg, device=dev, dist_gba=client), args.frames_file)
            client.shutdown()
        else:
            out = {"solved": GbaServer(group, cfg.optim, camera_from_config(cfg), work,
                                       dev).serve_forever()}
        out["backend"] = torch.distributed.get_backend(group)
        finish_process(group)
    with open(os.path.join(args.out, f"out_{name}.json"), "w") as f:
        json.dump(out, f)


def _run(roles, args):
    """Run the roles as processes at once; their logs go to OUT/<role>.log."""
    logs = [open(os.path.join(args.out, f"{r}.log"), "w") for r in roles]
    cmd = [sys.executable, "-u", os.path.abspath(__file__), "--device", args.device, "--config",
           args.config, "--frames-file", args.frames_file, "--out", args.out, "--role"]
    procs = [subprocess.Popen(cmd + [r], stdout=lf, stderr=subprocess.STDOUT) for r, lf in zip(roles, logs)]
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        for p in procs:
            try:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for lf in logs:
            lf.close()
    for r in roles:
        if not os.path.exists(os.path.join(args.out, f"out_{r}.json")):
            with open(os.path.join(args.out, f"{r}.log")) as f:
                raise RuntimeError(f"{r} produced no result:\n{f.read()[-3000:]}")


def parent(args):
    args.out = args.out or tempfile.mkdtemp(prefix="torch_dist_live_")
    os.makedirs(os.path.join(args.out, "work"), exist_ok=True)
    if args.frames_file is None:
        args.frames_file = os.path.join(args.out, "frames.npz")
        render(args.config, args.frames, args.frames_file)
    if not args.no_ref:
        _run(["ref"], args)
    _run(["leader", "server"], args)
    res = {}
    for r in ("ref", "leader", "server"):
        p = os.path.join(args.out, f"out_{r}.json")
        if os.path.exists(p):
            with open(p) as f:
                res[r] = json.load(f)
    lead, srv = res["leader"], res["server"]
    bound = 2.5 * res["ref"]["ate"] if "ref" in res else 0.05 * lead["length"]
    ok = (len(lead["loops"]) >= 1 and srv["solved"] >= 1
          and any(g["outcome"] == "written" for g in lead["gba_runs"])
          and lead["n_ok"] >= lead["n_frames"] - 2 and lead["ate"] < bound)
    print(json.dumps({"ok": bool(ok), "ate_bound": bound, **res}))
    return 0 if ok else 1


def main():
    ap = argparse.ArgumentParser(description="the live System with its global BA on two ranks")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", choices=("synthetic", "kitti"), default="synthetic")
    ap.add_argument("--frames", type=int, default=128)
    ap.add_argument("--frames-file", default=None)
    ap.add_argument("--no-ref", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--role", choices=("ref", "leader", "server"), default=None)
    args = ap.parse_args()
    if args.role is None:
        sys.exit(parent(args))
    role(args.role, args)


if __name__ == "__main__":
    main()
