"""Profile the PyTorch port's loop-closing stages on one CUDA card.

    python3 scripts/torch_profile_loop.py [--frames 90] [--out profile.json]

Drives System(kitti_stereo_config()) at the reference's defaults over the
first frames of the bench's cylinder-world orbit (its loop closes at frame
84) with torch.profiler recording each loop-closing stage as it runs:
`_compute_sim3`, `_optimize_essential_graph` and `_run_global_ba`; then
times the plain-PyTorch units on chip_smoke.py's synthetic inputs:
the vocabulary descent, Sim3 RANSAC and its refine, EPnP RANSAC and the
essential-graph solve. For each: kernels launched and their summed device
time (profiler), and the host-clock time of the call (the profiled call for
the stages, the median of unprofiled repeats for the units). Prints a JSON
summary. Needs a CUDA card; exits nonzero without one.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=90)
    ap.add_argument("--out", default=None, help="also write the summary JSON to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_profile_loop: no CUDA device")
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import chip_smoke as cs
    from torch_profile_mapping import card_info, host_ms, profile

    from orb_slam2_2021_tpu_torch.config import kitti_stereo_config
    from orb_slam2_2021_tpu_torch.optim.sim3_opt import essential_graph_solve, optimize_sim3_relative
    from orb_slam2_2021_tpu_torch.pipeline.system import System
    from orb_slam2_2021_tpu_torch.place.bundle import PlaceRecognition
    from orb_slam2_2021_tpu_torch.solvers.epnp import epnp_ransac
    from orb_slam2_2021_tpu_torch.solvers.horn_sim3 import sample_indices, sim3_ransac

    info = card_info()
    dev = torch.device("cuda:0")
    cfg = kitti_stereo_config()
    frames, _ = cs.render_orbit(args.frames)
    sys_ = System(cfg, device=dev)
    lc = sys_.loop_closer
    stages = {}

    def profiled(name, fn):
        def wrapped(*a, **kw):
            out = {}
            t0 = time.perf_counter()
            n, dev_ms = profile(lambda: out.setdefault("r", fn(*a, **kw)))
            stages.setdefault(name, []).append(
                {"host_ms_profiled": 1e3 * (time.perf_counter() - t0), "launches": n, "device_ms": dev_ms})
            return out["r"]
        return wrapped

    lc._optimize_essential_graph = profiled("essential_graph", lc._optimize_essential_graph)
    lc._run_global_ba = profiled("global_ba", lc._run_global_ba)
    lc._compute_sim3 = profiled("compute_sim3", lc._compute_sim3)
    for i, pair in enumerate(frames):
        sys_.track_stereo(pair[0], pair[1], timestamp=0.1 * i)
    sys_.shutdown()
    for name, rows in stages.items():
        print(f"{name}: {rows}", flush=True)

    units = {}

    def unit(name, fn, repeats=5, **shape):
        n, dev_ms = profile(fn)
        ms = host_ms(fn, repeats)
        units[name] = {"host_ms": ms, "launches": n, "device_ms": dev_ms,
                       "busy_share": dev_ms / ms if ms else None, **shape}
        print(f"{name}: host {ms:.3f} ms, {n} kernel launches, device {dev_ms:.3f} ms "
              f"(busy {100 * dev_ms / ms:.1f}%) {shape}", flush=True)

    rng = np.random.default_rng(3)
    pr = PlaceRecognition.load_default(dev)
    desc = torch.from_numpy(rng.integers(0, 2 ** 32, (2000, 8), dtype=np.uint32).view(np.int32)).to(dev)
    valid = torch.ones(2000, dtype=torch.bool, device=dev)
    unit("vocab_transform", lambda: pr.transform(desc, valid), N=2000, L=pr.voc.L)
    fx, fy, cx, cy = cfg.fx, cfg.fy, cfg.cx, cfg.cy
    a = [x.to(dev) for x in cs._sim3_matches(rng)]
    idx = sample_indices(np.ones(500, bool), 3, 128, torch.Generator().manual_seed(2000)).to(dev)
    unit("sim3_ransac", lambda: sim3_ransac(idx, *a, fx, fy, cx, cy, True), H=128, N=500)
    s, R, t, _, _ = sim3_ransac(idx, *a, fx, fy, cx, cy, True)
    unit("sim3_refine", lambda: optimize_sim3_relative(
        s, R, t, *a[:4], 1.0 / a[4], 1.0 / a[5], a[6], fx, fy, cx, cy, True), repeats=3, N=500)
    pargs, pvalid = cs._pnp_matches(rng)
    pa = [x.to(dev) for x in pargs]
    pidx = sample_indices(pvalid, 6, 256, torch.Generator().manual_seed(21)).to(dev)
    unit("epnp_ransac", lambda: epnp_ransac(pidx, *pa, fx, fy, cx, cy), repeats=3, H=256, N=2000)
    g = cs._ring_pose_graph(rng)
    g = type(g)(*(x.to(dev) for x in g))
    unit("essential_graph_solve", lambda: essential_graph_solve(g, fix_scale=True), repeats=2,
         K=32, E=256)

    summary = {"card": info, "frames": args.frames, "loops": lc.n_loops,
               "loop_times_s": lc.loop_times, "stages": stages, "units": units}
    if args.out:
        with open(args.out, "w") as f:
            json.dump(summary, f, indent=1)
    print(json.dumps(summary))
    print(info)


if __name__ == "__main__":
    main()
