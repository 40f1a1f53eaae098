"""Cross-process global BA for the live System (counterpart of
orb_slam2_2021_tpu/parallel/gba_service.py).

The System runs in rank 0 (the leader); when a closed loop starts a global
BA, its LoopClosing hands the assembled problem to a `GbaClient`, which
writes it to a shared work directory, and every `GbaServer` rank (the
followers) loads it and solves in lockstep with the leader: landmarks
sharded over the ranks, camera sums all-reduced (`dist_ba.py`).

Protocol, as in the reference:
- problems travel through the work directory by atomic rename; the numbers
  of the solve travel by the group's collectives, not by these files;
- before each chunk of LM iterations the leader writes a `go` or `stop`
  marker, and a follower waits for it before entering the chunk, so no
  follower enters a collective the leader has left (the stop request of a
  newer loop, mbStopGBA, is honoured between chunks without a deadlock);
- at the end the points are all-gathered, so every rank, the leader
  included, holds the whole solution.
Only the thread that runs the global BA issues collectives, on the stream
that is current there (the "gba" stream in async mode).
"""

from __future__ import annotations

import json
import os
import time
from typing import Callable, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..optim.ba import BAProblem
from ..optim.ba_cg import flat_index
from .dist_ba import gather_rows, make_dist_gba_iteration, upload_shard

CHUNK_ITERS = 2  # LM iterations between stop checks
MARKER_TIMEOUT_S = 300.0


def _write_marker(path: str, payload: dict):
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.rename(tmp, path)


def _wait_for(path: str, timeout: float, poll: float = 0.005) -> bool:
    t0 = time.monotonic()
    while not os.path.exists(path):
        if time.monotonic() - t0 > timeout:
            return False
        time.sleep(poll)
    return True


class _LockstepGBA:
    """The chunked LM driver that leader and followers share; only who
    writes the markers and who waits for them differs."""

    def __init__(self, group, cfg_optim, cam, work_dir: str, device):
        self.group = group
        self.cfg_optim = cfg_optim
        self.cam = cam
        self.work_dir = work_dir
        self.device = torch.device(device)
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        self._step = make_dist_gba_iteration(cfg_optim, cam, group)

    def close(self):
        """Drop every reference to the group (its own and the iteration's
        closure); no collective may follow."""
        self.group = self._step = None

    def run(self, idx: int, prob_np: BAProblem, n_iters: int, leader: bool,
            should_stop: Optional[Callable[[], bool]] = None,
            iter_times: Optional[List[float]] = None):
        """Solve problem `idx` (packed by shard_ba_problem for this group's
        size). Returns host numpy (R, t, xw), the same whole arrays on every
        rank, or None when the leader stopped it."""
        shard = upload_shard(prob_np, self.rank, self.world, self.device)
        index = flat_index(shard)
        R, t, xw = shard.R, shard.t, shard.xw
        lam = torch.tensor(self.cfg_optim.lm_lambda_init, dtype=torch.float32, device=self.device)
        active = shard.obs_valid.to(torch.float32)
        done = chunk = 0
        while done < n_iters:
            marker = os.path.join(self.work_dir, f"chunk_{idx}_{chunk}.json")
            if leader:
                stop = bool(should_stop and should_stop())
                _write_marker(marker, {"stop": stop})
            else:
                if not _wait_for(marker, MARKER_TIMEOUT_S):
                    raise TimeoutError(f"no chunk marker {marker}")
                with open(marker) as f:
                    stop = bool(json.load(f)["stop"])
            if stop:
                return None
            k = min(CHUNK_ITERS, n_iters - done)
            t0 = time.perf_counter()
            for _ in range(k):
                R, t, xw, lam, _ = self._step(shard, index, R, t, xw, lam, active, True)
            if self.device.type == "cuda":
                torch.cuda.current_stream(self.device).synchronize()
            if iter_times is not None:
                iter_times.extend([(time.perf_counter() - t0) / k] * k)
            done += k
            chunk += 1
        xw_full = gather_rows(xw, self.group)
        return R.cpu().numpy(), t.cpu().numpy(), xw_full.cpu().numpy()


def _problem_path(work_dir: str, idx: int) -> str:
    return os.path.join(work_dir, f"problem_{idx}.npz")


def _save_problem(path: str, prob_np: BAProblem, n_iters: int):
    # np.savez appends ".npz" to a name without it: the temporary name keeps
    # the suffix so the rename finds the file it wrote
    tmp = path + ".tmp.npz"
    np.savez(tmp, n_iters=np.int64(n_iters), **{f: np.asarray(v) for f, v in zip(prob_np._fields, prob_np)})
    os.rename(tmp, path)


def _load_problem(path: str):
    with np.load(path) as z:
        return BAProblem(*(z[f] for f in BAProblem._fields)), int(z["n_iters"])


class GbaClient(_LockstepGBA):
    """The leader, owned by the System's LoopClosing (rank 0): `solve`
    ships a problem and drives the lockstep iterations."""

    def __init__(self, group, cfg_optim, cam, work_dir: str, device):
        super().__init__(group, cfg_optim, cam, work_dir, device)
        os.makedirs(work_dir, exist_ok=True)
        self._idx = 0

    def solve(self, prob_np: BAProblem, n_iters: int,
              should_stop: Optional[Callable[[], bool]] = None,
              iter_times: Optional[List[float]] = None):
        idx = self._idx
        self._idx += 1
        if self.world > 1:
            _save_problem(_problem_path(self.work_dir, idx), prob_np, n_iters)
        return self.run(idx, prob_np, n_iters, leader=True, should_stop=should_stop,
                        iter_times=iter_times)

    def shutdown(self):
        """Tell the servers to return, and drop the group: the client
        solves nothing more, and a System that still holds it must not keep
        the process group alive past its destruction."""
        _write_marker(os.path.join(self.work_dir, "shutdown.json"), {})
        self.close()


class GbaServer(_LockstepGBA):
    """A follower rank: solves each shipped problem with the leader until
    the leader posts shutdown. `serve_forever` then drops the group and
    returns the number solved (stopped ones included)."""

    def serve_forever(self, poll: float = 0.01) -> int:
        idx = 0
        shut = os.path.join(self.work_dir, "shutdown.json")
        while True:
            p = _problem_path(self.work_dir, idx)
            if os.path.exists(p):
                prob_np, n_iters = _load_problem(p)
                self.run(idx, prob_np, n_iters, leader=False)
                idx += 1
                continue
            if os.path.exists(shut):
                self.close()
                return idx
            time.sleep(poll)
