"""Rank programs of the port's multi-process tests (tests/test_torch_dist.py):
each rank joins a gloo group on the CPU through a file rendezvous, reads the
numpy inputs its parent wrote, runs the port's sharded solvers and writes
what it got. Imports nothing of JAX.

    python tests/torch_dist_ranks.py RANK WORLD RENDEZVOUS_FILE IN.npz OUT_DIR

`spawn_ranks` starts WORLD of them and waits for all (each wait bounded), so
a hang fails the caller instead of stalling the suite.
"""

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_TIMEOUT_S = 120.0


def spawn_ranks(world: int, rendezvous: str, inp: str, out_dir: str):
    """Run WORLD rank processes; raise with their output if one fails or
    outlives JOIN_TIMEOUT_S."""
    from orb_slam2_2021_tpu_torch.parallel.multihost import run_processes

    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    run_processes([[sys.executable, os.path.abspath(__file__), str(r), str(world), rendezvous, inp,
                    out_dir] for r in range(world)], JOIN_TIMEOUT_S, env)


def _problem(z, prefix):
    from orb_slam2_2021_tpu_torch.optim.ba import BAProblem

    return BAProblem(*(z[prefix + f] for f in BAProblem._fields))


def main(rank: int, world: int, rendezvous: str, inp: str, out_dir: str):
    import torch

    from orb_slam2_2021_tpu_torch.config import OptimConfig
    from orb_slam2_2021_tpu_torch.geometry.camera import PinholeCamera
    from orb_slam2_2021_tpu_torch.optim import ba
    from orb_slam2_2021_tpu_torch.optim.ba_cg import flat_index
    from orb_slam2_2021_tpu_torch.parallel import dist_ba, gba_service
    from orb_slam2_2021_tpu_torch.parallel.multihost import finish_process, init_process

    torch.set_num_threads(1)
    ba.EIG_DTYPE = torch.float32  # the reference's precision, as the parity tests set it
    group, dev = init_process(f"file://{rendezvous}", world, rank, device="cpu")
    z = np.load(inp)
    cam = PinholeCamera.create(*(float(v) for v in z["cam"][:5]), int(z["cam"][5]), int(z["cam"][6]))
    out = {}

    # the two-phase dense BA on this rank's landmark shard
    cfg = OptimConfig(local_ba_iters1=int(z["iters"][0]), local_ba_iters2=int(z["iters"][1]))
    dense = _problem(z, "dense_")
    R, t, xw, inl = dist_ba.make_dist_ba(cfg, group)(cam, dist_ba.upload_shard(dense, rank, world, dev))
    out.update(dense_R=R, dense_t=t, dense_xw=dist_ba.gather_rows(xw, group),
               dense_inlier=dist_ba.gather_rows(inl, group))

    # three host-stepped global-BA iterations on the shard
    gcfg = OptimConfig(cg_iters=int(z["cg_iters"]))
    flat = _problem(z, "gba_")
    shard = dist_ba.upload_shard(flat, rank, world, dev)
    step = dist_ba.make_dist_gba_iteration(gcfg, cam, group)
    index = flat_index(shard)
    R, t, xw, lam = shard.R, shard.t, shard.xw, torch.tensor(gcfg.lm_lambda_init)
    costs = []
    for _ in range(3):
        R, t, xw, lam, cost = step(shard, index, R, t, xw, lam, shard.obs_valid.float(), True)
        costs.append(cost)
    out.update(gba_R=R, gba_t=t, gba_xw=dist_ba.gather_rows(xw, group), gba_lam=lam,
               gba_costs=torch.stack(costs))

    # the lockstep service: one solve of 4 iterations (2 chunks), then one
    # the leader stops at its second chunk
    work = os.path.join(out_dir, "work")
    if rank == 0:
        client = gba_service.GbaClient(group, gcfg, cam, work, dev)
        R, t, xw = client.solve(flat, 4)
        checks = []

        def stop_at_chunk_1():
            checks.append(len(checks))
            return len(checks) > 1

        times = []
        stopped = client.solve(flat, 4, should_stop=stop_at_chunk_1, iter_times=times)
        client.shutdown()
        out.update(svc_R=R, svc_t=t, svc_xw=xw, svc_stopped=np.array(stopped is None),
                   svc_stop_iters=np.array(len(times)))
    else:
        out.update(svc_solved=np.array(gba_service.GbaServer(group, gcfg, cam, work, dev).serve_forever()))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"),
             **{k: (v.numpy() if isinstance(v, torch.Tensor) else v) for k, v in out.items()})
    finish_process(group)


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), *sys.argv[3:6])
