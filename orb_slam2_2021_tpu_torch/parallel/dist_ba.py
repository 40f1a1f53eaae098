"""Landmark-sharded bundle adjustment over a torch.distributed process group
(counterpart of orb_slam2_2021_tpu/parallel/dist_ba.py).

Layout, as in the reference: the points and all their observations are
split into `world` contiguous shards, rank r keeping shard r; the cameras
are replicated. Each rank eliminates its own landmark blocks; the
camera-side sums (the reduced system and its right-hand side, the PCG
products' corrections, the costs) are all-reduced over the group inside the
solvers (`optim/ba.py`, `optim/ba_cg.py`), and every rank computes the same
camera update.

Process model. The reference has two multi-device paths: one process
driving the n devices of a mesh (`shard_map`, `System(mesh=...)`), and
several processes forming one mesh that the live System reaches through
`gba_service.py`. In torch.distributed every rank is a process, so the port
folds the two into one path: the System runs in rank 0 and hands its global
BA to a `gba_service.GbaClient`, ranks 1..n-1 serve it (`GbaServer`), and a
group of size 1 runs the sharded step in process.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.distributed as dist

from ..optim.assemble import upload_problem
from ..optim.ba import BAProblem, ba_solve
from ..optim.ba_cg import gba_iteration


def shard_ba_problem(prob: BAProblem, n_dev: int) -> BAProblem:
    """Re-pad a host (numpy) BAProblem so each of n_dev shards holds P/n_dev
    points and all of their observations: the observations of shard d are
    moved to the d-th block of O/n_dev slots and pt_obs is rewritten to the
    new positions; padding slots are invalid and point inside their shard.
    Returns a numpy BAProblem."""
    R = np.asarray(prob.R)
    xw = np.asarray(prob.xw)
    P_ = xw.shape[0]
    Q = prob.pt_obs.shape[1]
    if P_ % n_dev:
        raise ValueError(f"{P_} points do not split into {n_dev} shards: pad them first")
    P_loc = P_ // n_dev

    obs_cam = np.asarray(prob.obs_cam)
    obs_pt = np.asarray(prob.obs_pt)
    obs_uvr = np.asarray(prob.obs_uvr)
    obs_is2 = np.asarray(prob.obs_inv_sigma2)
    obs_valid = np.asarray(prob.obs_valid)
    pt_obs = np.asarray(prob.pt_obs)

    # the largest shard's observation count, rounded up to 128, for all
    owner = obs_pt // P_loc
    O_loc = 0
    for d in range(n_dev):
        O_loc = max(O_loc, int((obs_valid & (owner == d)).sum()))
    O_loc = max(O_loc, Q)
    O_loc = ((O_loc + 127) // 128) * 128

    n_cam = np.zeros(n_dev * O_loc, np.int32)
    n_pt = np.repeat(np.arange(n_dev, dtype=np.int32) * P_loc, O_loc)
    n_uvr = np.full((n_dev * O_loc, 3), -1.0, np.float32)
    n_is2 = np.ones(n_dev * O_loc, np.float32)
    n_valid = np.zeros(n_dev * O_loc, bool)
    n_pt_obs = np.full((P_, Q), -1, np.int32)

    # stable sort of the valid observations by shard; the rank inside a
    # shard is the local slot
    vi = np.nonzero(obs_valid)[0]
    order = vi[np.argsort(owner[vi], kind="stable")]
    own_sorted = owner[order]
    shard_start = np.searchsorted(own_sorted, np.arange(n_dev))
    rank = np.arange(len(order)) - shard_start[own_sorted]
    pos = own_sorted * O_loc + rank
    remap = np.full(len(obs_cam), -1, np.int64)
    remap[order] = pos
    n_cam[pos] = obs_cam[order]
    n_pt[pos] = obs_pt[order]
    n_uvr[pos] = obs_uvr[order]
    n_is2[pos] = obs_is2[order]
    n_valid[pos] = True
    po_ok = pt_obs >= 0
    n_pt_obs[po_ok] = remap[pt_obs[po_ok]]

    return BAProblem(
        R=R, t=np.asarray(prob.t), xw=xw, obs_cam=n_cam, obs_pt=n_pt, obs_uvr=n_uvr,
        obs_inv_sigma2=n_is2, obs_valid=n_valid, pt_obs=n_pt_obs,
        cam_free=np.asarray(prob.cam_free),
    )


def local_shard(prob: BAProblem, rank: int, world: int) -> BAProblem:
    """Rank `rank`'s slice of a shard_ba_problem output (numpy): its points
    and observations, with obs_pt and pt_obs shifted into the slice's own
    numbering; the cameras whole."""
    P_loc = prob.xw.shape[0] // world
    O_loc = prob.obs_cam.shape[0] // world
    ps, os_ = slice(rank * P_loc, (rank + 1) * P_loc), slice(rank * O_loc, (rank + 1) * O_loc)
    po = prob.pt_obs[ps]
    return prob._replace(
        xw=prob.xw[ps], obs_cam=prob.obs_cam[os_], obs_pt=prob.obs_pt[os_] - rank * P_loc,
        obs_uvr=prob.obs_uvr[os_], obs_inv_sigma2=prob.obs_inv_sigma2[os_],
        obs_valid=prob.obs_valid[os_], pt_obs=np.where(po >= 0, po - rank * O_loc, -1),
    )


def upload_shard(prob: BAProblem, rank: int, world: int, device) -> BAProblem:
    """Rank `rank`'s slice of a shard_ba_problem output on `device`: the
    one upload each rank makes."""
    return upload_problem(local_shard(prob, rank, world), device)


def _world(group) -> int:
    return dist.get_world_size(group) if group is not None else 1


def gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Concatenate every rank's x along dim 0, in rank order, on every rank
    (the reference's all-gather of a sharded output to replicated)."""
    if group is None:
        return x
    parts = [torch.empty_like(x) for _ in range(_world(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def make_dist_ba(cfg, group, iters1=None, iters2=None):
    """The two-phase BA (`ba_solve`) on this rank's shard (`upload_shard`),
    camera sums all-reduced over `group`: (cam, shard) -> (R, t, xw of the
    shard, inlier flags of the shard's observations)."""
    return functools.partial(
        ba_solve, cfg=cfg, group=group,
        iters_phase1=cfg.local_ba_iters1 if iters1 is None else iters1,
        iters_phase2=cfg.local_ba_iters2 if iters2 is None else iters2)


def make_dist_gba_iteration(cfg, cam, group):
    """One host-steppable global-BA LM iteration on this rank's shard:
    (shard, index, R, t, xw, lam, active, use_huber) -> (R, t, xw, lam,
    cost), with `index` the shard's own `flat_index` and xw the shard's
    points. The host drives the iterations, so a stop request is honoured
    between them."""
    def step(shard, index, R, t, xw, lam, active, use_huber):
        return gba_iteration(cam, shard, index, R, t, xw, lam, active, use_huber, cfg, group)

    return step
