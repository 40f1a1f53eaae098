"""Process bring-up and per-rank placement for the multi-GPU global BA
(counterpart of orb_slam2_2021_tpu/parallel/multihost.py).

Each rank is one process with one device. `init_process` joins the group
(NCCL when every rank has a card of its own, gloo otherwise: the CPU tests,
or several ranks sharing one card, where gloo stages the CUDA tensors
through the host); every rank builds the same host problem, packs it with
`dist_ba.shard_ba_problem` and uploads only its own shard
(`shard_problem_global`); `run_dist_gba` drives the sharded LM iteration.
Nothing here reads a cluster description: the caller gives the rendezvous
(`tcp://host:port` or `file://path`), the world size and the rank;
`run_processes` starts the ranks as processes on one host.
"""

from __future__ import annotations

import subprocess
import tempfile
import time
from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..optim.ba_cg import flat_index
from .dist_ba import make_dist_gba_iteration, upload_shard


def init_process(init_method: str, world_size: int, rank: int, device="cuda",
                 backend: Optional[str] = None):
    """Join the process group as `rank` of `world_size`. Returns (group,
    device); an indexless "cuda" means card rank mod the card count."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % max(torch.cuda.device_count(), 1))
    if backend is None:
        own_cards = dev.type == "cuda" and torch.cuda.device_count() >= world_size
        backend = "nccl" if own_cards else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    return dist.group.WORLD, dev


def finish_process(group):
    """Leave the group: wait for every rank, then destroy it, so it is torn
    down now rather than while the interpreter exits. The group's other
    holders drop it by themselves first (`GbaClient.shutdown`, the end of
    `GbaServer.serve_forever`); no reference cycle may hold it."""
    dist.barrier(group)
    dist.destroy_process_group()


def shard_problem_global(prob_np, group, device):
    """This rank's shard of a shard_ba_problem-packed host problem, on
    `device`."""
    return upload_shard(prob_np, dist.get_rank(group), dist.get_world_size(group), device)


def run_dist_gba(group, cfg_optim, cam, prob_np, n_iters: int, device, lam0: float = 1e-4):
    """n_iters of the landmark-sharded global-BA LM iteration (Huber) on a
    shard_ba_problem-packed host problem. Returns host numpy (R, t, the
    rank's xw rows, costs); R and t are the same on every rank."""
    shard = shard_problem_global(prob_np, group, device)
    index = flat_index(shard)
    step = make_dist_gba_iteration(cfg_optim, cam, group)
    R, t, xw = shard.R, shard.t, shard.xw
    lam = torch.tensor(lam0, dtype=torch.float32, device=shard.R.device)
    active = shard.obs_valid.to(torch.float32)
    costs = []
    for _ in range(n_iters):
        R, t, xw, lam, cost = step(shard, index, R, t, xw, lam, active, True)
        costs.append(cost)
    costs = torch.stack(costs).cpu().numpy().astype(np.float64).tolist()
    return R.cpu().numpy(), t.cpu().numpy(), xw.cpu().numpy(), costs


def run_processes(cmds: Sequence[Sequence[str]], timeout: float, env=None) -> List[str]:
    """Run the commands (one rank each) at once and wait for all of them,
    `timeout` seconds at most in all; returns their outputs. When one fails,
    or the time runs out (every process is then killed), raises
    RuntimeError with the end of each output. The outputs go to files, so a
    rank that writes much never blocks on a full pipe."""
    logs = [tempfile.TemporaryFile("w+") for _ in cmds]
    procs = [subprocess.Popen(c, env=env, stdout=f, stderr=subprocess.STDOUT) for c, f in zip(cmds, logs)]
    deadline = time.monotonic() + timeout
    timed_out = False
    try:
        for p in procs:
            try:
                p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                timed_out = True
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = []
    for f in logs:
        f.seek(0)
        outs.append(f.read())
        f.close()
    if timed_out or any(p.returncode != 0 for p in procs):
        why = f"outlived {timeout} s" if timed_out else "failed"
        raise RuntimeError(f"a rank {why}:\n" + "\n----\n".join(o[-3000:] for o in outs))
    return outs
