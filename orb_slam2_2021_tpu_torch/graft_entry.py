"""Driver entry points of the port (counterpart of __graft_entry__.py).

- entry(device): the flagship per-frame device work, the stereo frame build
  (ORB extraction of both eyes, stereo matching) at KITTI size, as a
  callable and its inputs.
- dryrun_multichip(n, device): n rank processes in one group, each running
  one landmark-sharded BA step, a data-parallel ORB extraction of its own
  image, and then rank 0 running LoopClosing._run_global_ba over a small
  real map with the group wired in (a GbaClient) while the other ranks
  serve it (GbaServer); after the group is destroyed each rank lists what
  still holds it (`group_holders`, empty when nothing does).

    python -m orb_slam2_2021_tpu_torch.graft_entry [--ranks N] [--device cuda|cpu]

runs both and prints one JSON line. On one card the ranks share it under
gloo; with a card per rank they use NCCL.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np
import torch

from .parallel.multihost import run_processes

RANK_TIMEOUT_S = 600.0


def entry(device="cuda"):
    """(fn, (images,)): fn builds the stereo Frame of a [2, H, W] uint8 pair
    at kitti_stereo_config()'s size."""
    from . import resolve_device
    from .config import kitti_stereo_config
    from .frontend.frame import build_stereo_frame_from_u8

    cfg = kitti_stereo_config()
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.integers(0, 256, (2, cfg.height, cfg.width), dtype=np.uint8)).to(dev)
    return (lambda im: build_stereo_frame_from_u8(im, cfg)), (images,)


def _small_map(cfg, rng):
    """Six keyframes along x, 80 points each, bound to their projections
    (the reference's dry-run map)."""
    from .mapping.map_store import MapStore

    m = MapStore(cfg)
    N = cfg.orb.n_features
    n_pts = 80
    for k in range(6):
        t_cw = np.array([-0.3 * k, 0, 0], np.float32)
        xc = np.stack([rng.uniform(-2, 2, n_pts), rng.uniform(-1.5, 1.5, n_pts),
                       rng.uniform(4, 8, n_pts)], axis=1).astype(np.float32)
        xy = np.zeros((N, 2), np.float32)
        xy[:n_pts, 0] = cfg.fx * xc[:, 0] / xc[:, 2] + cfg.cx
        xy[:n_pts, 1] = cfg.fy * xc[:, 1] / xc[:, 2] + cfg.cy
        bind = np.full(N, -1, np.int64)
        bind[:n_pts] = m.add_map_points_batch(xc - t_cw, np.zeros((n_pts, 8), np.uint32), k)
        m.add_keyframe(np.eye(3, dtype=np.float32), t_cw, xy, np.full(N, -1.0, np.float32),
                       np.full(N, -1.0, np.float32), np.zeros(N, np.int32), np.zeros(N, np.float32),
                       np.zeros((N, 8), np.uint32), np.arange(N) < n_pts, bind)
    return m


def _rank_main(rank: int, world: int, rendezvous: str, work_dir: str, device: str) -> dict:
    import torch.distributed as dist

    from .config import OptimConfig, synthetic_config
    from .convert import camera_from_config
    from .frontend.features import extract_orb_batched
    from .parallel.corridor import corridor_problem
    from .parallel.dist_ba import gather_rows, make_dist_ba, shard_ba_problem, upload_shard
    from .parallel.gba_service import GbaClient, GbaServer
    from .parallel.multihost import finish_process, init_process

    torch.set_num_threads(1)
    group, dev = init_process(f"file://{rendezvous}", world, rank, device=device)
    out = {"rank": rank, "device": str(dev), "backend": dist.get_backend(group)}

    # one landmark-sharded BA step (one Huber and one plain iteration)
    cfg = synthetic_config()
    cam = camera_from_config(cfg)
    n_pts = max(16 * world, 64)
    n_pts = -(-n_pts // world) * world
    prob, *_ = corridor_problem(cam, 6, n_pts, 3 * n_pts, seed=0, window=4)
    R, t, xw, inl = make_dist_ba(OptimConfig(local_ba_iters1=1, local_ba_iters2=1), group)(
        cam, upload_shard(shard_ba_problem(prob, world), rank, world, dev))
    xw = gather_rows(xw, group)
    if not (torch.isfinite(R).all() and torch.isfinite(t).all() and torch.isfinite(xw).all()):
        raise RuntimeError("the distributed BA step gave non-finite values")
    out["ba_points"] = int(xw.shape[0])

    # data-parallel extraction: one image per rank
    small = synthetic_config(width=128, height=96)
    img = np.random.default_rng(1 + rank).uniform(0, 255, (1, 96, 128)).astype(np.float32)
    kp, _ = extract_orb_batched(torch.from_numpy(img).to(dev), small.orb)
    n_kp = kp.valid.sum().to(torch.float32).reshape(1)
    dist.all_reduce(n_kp, group=group)
    out["keypoints_all_ranks"] = int(n_kp.item())

    # global BA of a small real map through the group
    cfg_map = synthetic_config(max_keyframes=16, max_map_points=2048)
    cfg_map = cfg_map.replace(optim=OptimConfig(global_ba_iters=2, cg_iters=8))
    if rank == 0:
        from .pipeline.loop_closing import LoopClosing
        from .place.kf_database import KeyFrameDatabase
        from .place.vocab import BinaryVocabulary

        m = _small_map(cfg_map, np.random.default_rng(2))
        voc = BinaryVocabulary(2, 2, np.zeros((7, 8), np.uint32), np.ones(4, np.float32))
        lc = LoopClosing(cfg_map, m, KeyFrameDatabase(voc), dev)
        lc.dist_gba = GbaClient(group, cfg_map.optim, lc.cam, work_dir, dev)
        lc._run_global_ba()
        lc.dist_gba.shutdown()
        if lc.gba_runs[-1]["outcome"] != "written" or not np.isfinite(m.mp_pos[: m.next_mp]).all():
            raise RuntimeError(f"global BA through the group: {lc.gba_runs}")
        out["gba"] = lc.gba_runs[-1]["outcome"]
        del lc
    else:
        out["gba_served"] = GbaServer(group, cfg_map.optim, camera_from_config(cfg_map), work_dir,
                                      dev).serve_forever()
    finish_process(group)
    del group
    out["group_holders"] = _group_holders()
    return out


def _group_holders() -> list:
    """Type names of the objects the garbage collector tracks that still
    hold the process group: a GbaClient or GbaServer, or anything that
    refers to a ProcessGroup. No collection runs before this, so garbage
    that a cycle keeps (which the interpreter would destroy at exit) counts
    too."""
    import gc

    import torch.distributed as dist

    from .parallel.gba_service import GbaClient, GbaServer

    return [type(o).__name__ for o in gc.get_objects()
            if type(o) in (GbaClient, GbaServer)
            or any(issubclass(type(r), dist.ProcessGroup) for r in gc.get_referents(o))]


def dryrun_multichip(n_devices: int, device="cuda") -> list:
    """Run the n-rank dry run; returns each rank's summary. Raises if a rank
    fails or outlives RANK_TIMEOUT_S."""
    pkg_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=pkg_root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    with tempfile.TemporaryDirectory() as tmp:
        logs = run_processes(
            [[sys.executable, "-m", "orb_slam2_2021_tpu_torch.graft_entry", "--rank", str(r),
              "--ranks", str(n_devices), "--rendezvous", os.path.join(tmp, "rendezvous"),
              "--work", os.path.join(tmp, "work"), "--device", str(device)]
             for r in range(n_devices)], RANK_TIMEOUT_S, env)
    return [json.loads(l.strip().splitlines()[-1]) for l in logs]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rendezvous", help=argparse.SUPPRESS)
    ap.add_argument("--work", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        print(json.dumps(_rank_main(args.rank, args.ranks, args.rendezvous, args.work, args.device)))
        return
    fn, inputs = entry(args.device)
    frame = fn(*inputs)
    n_valid = int(frame.kp.valid.sum())
    ranks = dryrun_multichip(args.ranks, args.device)
    print(json.dumps({"ok": n_valid > 0, "frame_keypoints": n_valid, "ranks": ranks}))


if __name__ == "__main__":
    main()
