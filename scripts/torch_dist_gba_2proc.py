"""Two-process global-BA bring-up over torch.distributed (counterpart of
scripts/dist_gba_2proc.py).

Parent mode (no --proc): spawns two ranks of itself (file rendezvous in the
output directory), waits (bounded), and checks that both solved the same
landmark-sharded global-BA problem: the replicated cameras agree bit for
bit, the cost fell and agrees across ranks, each rank holds a different
half of the points, and a checkpoint rank 0 wrote is restored and verified
by rank 1 after a barrier. Prints one JSON line; exit 1 when a check fails.

Child mode (--proc R): builds the same seeded corridor problem as the other
rank (parallel/corridor.py, 300 keyframes, 100,000 points), packs it for
two shards, uploads only its own, runs one warm iteration and then N_ITERS
(parallel/multihost.run_dist_gba), and writes its cameras' hash, its
shard's hash, the costs and the timings.

    python scripts/torch_dist_gba_2proc.py [--device cuda|cpu] [--out DIR]

One card: both ranks share it under gloo; a card each: NCCL.
"""

import argparse
import hashlib
import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

N_PROC = 2
N_ITERS = 6
RANK_TIMEOUT_S = 900.0


def build_problem():
    """The seeded corridor problem, packed for N_PROC shards (the same on
    every rank)."""
    from orb_slam2_2021_tpu_torch.config import kitti_stereo_config
    from orb_slam2_2021_tpu_torch.convert import camera_from_config
    from orb_slam2_2021_tpu_torch.optim.assemble import global_problem_shapes
    from orb_slam2_2021_tpu_torch.parallel.corridor import corridor_problem
    from orb_slam2_2021_tpu_torch.parallel.dist_ba import shard_ba_problem

    cfg = kitti_stereo_config()
    cam = camera_from_config(cfg)
    C_pad, P_pad, O_pad = global_problem_shapes(300, 100000, 117000)
    prob, *_ = corridor_problem(cam, 300, 100000, 117000, seed=42, C_pad=C_pad, P_pad=P_pad,
                                O_pad=O_pad)
    return cfg, cam, shard_ba_problem(prob, N_PROC)


def child(rank: int, device: str, out_dir: str):
    import torch.distributed as dist

    from orb_slam2_2021_tpu_torch.parallel.multihost import finish_process, init_process, run_dist_gba

    t0 = time.time()
    group, dev = init_process(f"file://{os.path.join(out_dir, 'rendezvous')}", N_PROC, rank, device)
    cfg, cam, packed = build_problem()
    t_setup = time.time() - t0
    run_dist_gba(group, cfg.optim, cam, packed, 1, dev)  # warm: allocations, first launches
    t1 = time.time()
    R, t, xw, costs = run_dist_gba(group, cfg.optim, cam, packed, N_ITERS, dev)
    t_solve = time.time() - t1
    out = {
        "proc": rank, "backend": dist.get_backend(group), "device": str(dev),
        "cam_hash": hashlib.sha256(R.tobytes() + t.tobytes()).hexdigest()[:16],
        "shard_hash": hashlib.sha256(xw.tobytes()).hexdigest()[:16],
        "costs": costs, "t_setup_s": t_setup, "t_solve_s": t_solve,
    }
    # checkpoint across the process boundary: rank 0 writes (to a temporary
    # name that keeps the .npz suffix np.savez would add, then renames),
    # the barrier orders it before rank 1 reads
    ckpt = os.path.join(out_dir, "ckpt_proc0.npz")
    if rank == 0:
        tmp = ckpt[: -len(".npz")] + ".tmp.npz"
        np.savez(tmp, R=R, t=t, xw=xw)
        os.rename(tmp, ckpt)
    dist.barrier(group)
    if rank == 1:
        with np.load(ckpt) as z:
            out["ckpt_cam_match"] = bool(np.array_equal(z["R"], R) and np.array_equal(z["t"], t))
    with open(os.path.join(out_dir, f"out_{rank}.json"), "w") as f:
        json.dump(out, f)
    finish_process(group)


def parent(device: str, out_dir: str) -> int:
    out_dir = out_dir or tempfile.mkdtemp(prefix="torch_dist_gba_")
    os.makedirs(out_dir, exist_ok=True)
    for name in [f"out_{i}.json" for i in range(N_PROC)] + ["ckpt_proc0.npz", "rendezvous"]:
        if os.path.exists(os.path.join(out_dir, name)):
            os.remove(os.path.join(out_dir, name))
    from orb_slam2_2021_tpu_torch.parallel.multihost import run_processes

    try:
        run_processes([[sys.executable, os.path.abspath(__file__), "--proc", str(i), "--device", device,
                        "--out", out_dir] for i in range(N_PROC)], RANK_TIMEOUT_S)
    except RuntimeError as e:
        print(json.dumps({"ok": False, "reason": str(e)[-4000:]}))
        return 1
    results = []
    for i in range(N_PROC):
        with open(os.path.join(out_dir, f"out_{i}.json")) as f:
            results.append(json.load(f))
    r0, r1 = results
    checks = {
        "cam_agree": r0["cam_hash"] == r1["cam_hash"],
        "cost_decreased": r0["costs"][-1] < r0["costs"][0],
        "costs_agree": all(abs(a - b) <= 1e-6 * max(abs(a), 1.0) for a, b in zip(r0["costs"], r1["costs"])),
        "shards_disjoint": r0["shard_hash"] != r1["shard_hash"],
        "ckpt_roundtrip": bool(r1.get("ckpt_cam_match")),
    }
    ok = all(checks.values())
    print(json.dumps({"ok": ok, "checks": checks, "costs": r0["costs"], "backend": r0["backend"],
                      "device": r0["device"], "t_solve_s": [r0["t_solve_s"], r1["t_solve_s"]],
                      "ms_per_iteration": [1e3 * r["t_solve_s"] / N_ITERS for r in results]}))
    return 0 if ok else 1


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--proc", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.proc is None:
        sys.exit(parent(args.device, args.out))
    child(args.proc, args.device, args.out)
