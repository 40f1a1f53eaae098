"""Profile the PyTorch port's local-mapping units on one CUDA card.

    python3 scripts/torch_profile_mapping.py [--frames 40] [--out profile.json]

Drives System(kitti_stereo_config(), enable_mapping=True,
enable_loop_closing=False) over the first frames of the bench's cylinder-world
orbit, then, on the final map and its last keyframe, times each mapping unit
again: triangulation against the covisible neighbours, one forward and one
backward fuse unit, the same two at the production widths (10 and 8 stacked
keyframes), the local BA solve, one LM iteration and one grid update.
For each unit: the host-clock time of a call that ends in
torch.cuda.synchronize() (median of repeats), and from torch.profiler the
number of kernels it launched and their summed device time. Prints a JSON
summary. Needs a CUDA card; exits nonzero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_info() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def host_ms(fn, repeats=5):
    """Median host-clock ms of fn() followed by a device synchronize."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(out))


def profile(fn):
    """(kernel launches, summed device ms) of one call of fn."""
    from torch.profiler import ProfilerActivity, profile as tprofile

    torch.cuda.synchronize()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return len(kernels), sum(e.device_time for e in kernels) / 1e3


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--out", default=None, help="also write the summary JSON to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_mapping: no CUDA device")
    sys.path.insert(0, REPO)
    from orb_slam2_2021_tpu.config import kitti_stereo_config
    from orb_slam2_2021_tpu.io.synthetic import SyntheticCylinderWorld, orbit_trajectory
    from orb_slam2_2021_tpu_torch.convert import to_host
    from orb_slam2_2021_tpu_torch.optim.assemble import upload_problem
    from orb_slam2_2021_tpu_torch.optim.ba_cg import _cam_onehot, _cg_lm_step_rcs
    from orb_slam2_2021_tpu_torch.pipeline.mapping_steps import fuse_project, triangulate_pair
    from orb_slam2_2021_tpu_torch.pipeline.system import System

    info = card_info()
    dev = torch.device("cuda:0")
    cfg = kitti_stereo_config()
    world = SyntheticCylinderWorld(cfg, seed=7)
    gt = orbit_trajectory(144, total_deg=630.0, r_orbit=1.5)[: args.frames]
    frames = [np.clip(np.stack(world.render(R, t)), 0, 255).astype(np.uint8) for R, t in gt]
    sys_ = System(cfg, enable_mapping=True, enable_loop_closing=False, device=dev)
    for i, pair in enumerate(frames):
        sys_.track_stereo(pair[0], pair[1], timestamp=0.1 * i)
    sys_.shutdown()
    lm, m = sys_.local_mapper, sys_.map
    k = int(np.nonzero(m.kf_valid)[0][-1])
    units = {}

    def unit(name, fn, repeats=5, **shape):
        n, dev_ms = profile(fn)
        ms = host_ms(fn, repeats)
        units[name] = {"host_ms": ms, "launches": n, "device_ms": dev_ms,
                       "busy_share": dev_ms / ms if ms else None, **shape}
        print(f"{name}: host {ms:.3f} ms, {n} kernel launches, device {dev_ms:.3f} ms "
              f"(busy {100 * dev_ms / ms:.1f}%) {shape}", flush=True)

    tri = lm._snapshot_triangulation(k)
    if tri is not None:
        _, view1, views2 = tri
        unit("triangulate_pair", lambda: to_host(*triangulate_pair(lm.cam, view1, views2, cfg)[:3]),
             T=int(views2.xy.shape[0]), N=int(view1.xy.shape[0]))
    fuse = lm._snapshot_fuse(k)
    if fuse is not None:
        chunks, _, pts, back, _ = fuse
        if chunks:
            views = chunks[0][1]
            unit("fuse_forward", lambda: to_host(*fuse_project(lm.cam, views, *pts, cfg)[:2]),
                 T=int(views.xy.shape[0]), P=int(pts[0].shape[0]))
        if back:
            _, bpts, bview = back[0]
            unit("fuse_backward", lambda: to_host(*fuse_project(lm.cam, bview, *bpts, cfg)[:2]),
                 T=1, P=int(bpts[0].shape[0]))
    # the production shapes of a longer drive: one keyframe against 10
    # neighbours, a forward-fuse unit of 8 targets (live keyframes repeated)
    others = [int(x) for x in np.nonzero(m.kf_valid)[0] if x != k]
    if others and tri is not None:
        views10 = lm._kf_views((others * 10)[:10], unbound_only=True)
        unit("triangulate_pair_T10",
             lambda: to_host(*triangulate_pair(lm.cam, view1, views10, cfg)[:3]), T=10, N=int(view1.xy.shape[0]))
    if others and fuse is not None and chunks:
        views8 = lm._kf_views((others * 8)[:8], unbound_only=False)
        unit("fuse_forward_T8", lambda: to_host(*fuse_project(lm.cam, views8, *pts, cfg)[:2]),
             T=8, P=int(pts[0].shape[0]))
    window = lm._local_ba_window(k)
    if window is not None:
        prob = upload_problem(window[0], dev)
        C, P, O = prob.R.shape[0], prob.xw.shape[0], prob.obs_cam.shape[0]
        unit("local_ba_solve", lambda: to_host(*lm._solve_ba_abortable(prob)), repeats=3,
             C=C, P=P, Q=O // P, cameras=len(window[1]), points=len(window[3]))
        onehot = _cam_onehot(prob)
        lam = torch.tensor(cfg.optim.lm_lambda_init, device=dev)
        active = prob.obs_valid.float()
        unit("lm_step", lambda: _cg_lm_step_rcs(lm.cam, prob, onehot, prob.R, prob.t, prob.xw,
                                                active, lam, True, cfg.optim, cfg.optim.cg_iters),
             C=C, P=P, Q=O // P)
    gm = sys_.grid_mapper
    unit("grid_update_kf", lambda: gm.update_kf(k), rays=cfg.gridmap.max_points_per_kf)

    kf_rows = [r for r in sys_.metrics if r["keyframe"]]
    summary = {
        "card": info,
        "frames": args.frames,
        "keyframes_created": int(m.next_kf),
        "local_ba_solves_ms": [1e3 * s for s, _ in lm.ba_solve_times],
        "ms_mapping_keyframes": [r["ms_mapping"] for r in kf_rows],
        "ms_total_median": float(np.median([r["ms_total"] for r in sys_.metrics])),
        "units": units,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    print(info)


if __name__ == "__main__":
    main()
