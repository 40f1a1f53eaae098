"""Scale proof of the PyTorch/CUDA port: the twin of scripts/scale_1500kf.py
on the port's types.

    python scripts/torch_scale_1500kf.py [n_kf] [--device cuda|cpu] [--out PATH]

Grows the reference script's corridor map (default 1,500 keyframes asked
for; 1,442 live at the end, 487,577 points, 570,794 observations, about
KITTI 00, as the reference script gives them on this tree: the 487,556
points of SCALE_1500KF.json were recorded before the reference's
add_keyframe began re-validating bindings of culled points) through the
port's production map paths, drawing from default_rng(0) in the
reference's order call by call, so the map is the reference's bit for bit:
MapStore.add_map_points_batch, add_keyframe (with
its covisibility update), covisible_keyframes, erase_keyframe (mTcp and the
KeyFrameDatabase erase callback), KeyFrameDatabase add and
detect_loop_candidates, local_map_snapshot. Then, at full size, on the
device: one global-BA assembly, its upload, the flat index and three
gba_iteration steps; and LoopClosing._optimize_essential_graph over every
keyframe (essential_graph_solve on the device, the host write-back of every
point).

Records the reference's cost curves (a row every 100 keyframes) and times,
and what the card adds: the GBA upload and each iteration's ms by CUDA
events, the robust cost before and after; the essential graph's solve ms by
CUDA events, its kernel launches (torch.profiler, one more solve of the same
graph), its vertex and edge counts, the bytes of its two dense [E, K]
incidence matrices, its edge cost before and after, and the host seconds of
the write-back; the peak device memory. Prints one JSON object and writes it
to PATH if given (never to SCALE_1500KF.json, the reference's CPU record).
Runs on the card by default and raises without one; `--device cpu` runs on
the CPU, where device times are host-clock times and launches are not
counted. Nothing of the JAX package is imported.
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
OBS_PER_KF = 400          # bound features per keyframe
NEW_PER_KF = 340          # fresh points per keyframe (the rest re-observed)
GBA_ITERS = 3


def grow(cfg, m, kfdb, n_words: int, n_kf_target: int, log=print):
    """The reference script's map growth (scale_1500kf.py:51-129) on the
    map store `m` and keyframe database `kfdb` (either package's: the calls
    and the draws from default_rng(0) are the reference's, in its order).
    Returns the curve rows, one every 100 keyframes."""
    rng = np.random.default_rng(0)
    n_feat = cfg.orb.n_features
    word_pool = rng.integers(0, n_words, 4000)
    curves = []
    live_points = []          # ids of recent points for re-observation
    t_all = time.perf_counter()
    for i in range(n_kf_target):
        x = 0.5 * i
        R = np.eye(3, dtype=np.float32)
        t = np.array([-x, 0, 0], np.float32)

        # new points ahead of the camera
        pos = rng.uniform(-4, 4, (NEW_PER_KF, 3)).astype(np.float32)
        pos[:, 0] += x
        pos[:, 2] = rng.uniform(4, 30, NEW_PER_KF)
        desc = rng.integers(0, 2 ** 32, (NEW_PER_KF, 8), dtype=np.uint32)
        t0 = time.perf_counter()
        new_ids = m.add_map_points_batch(pos, desc, first_kf=m.next_kf)
        t_addmp = time.perf_counter() - t0

        # bindings: fresh points and re-observations of recent ones
        n_re = OBS_PER_KF - NEW_PER_KF
        re_ids = (np.asarray(live_points[-8 * NEW_PER_KF:], np.int64)
                  if live_points else np.zeros(0, np.int64))
        re_sel = rng.choice(re_ids, n_re, replace=False) if len(re_ids) >= n_re else re_ids
        bind = np.full(n_feat, -1, np.int64)
        slots = rng.choice(n_feat, len(new_ids) + len(re_sel), replace=False)
        bind[slots[: len(new_ids)]] = new_ids
        bind[slots[len(new_ids):]] = re_sel
        live_points.extend(int(v) for v in new_ids)
        if len(live_points) > 16 * NEW_PER_KF:
            live_points = live_points[-16 * NEW_PER_KF:]

        xy = rng.uniform(0, [cfg.width, cfg.height], (n_feat, 2)).astype(np.float32)
        ur = rng.uniform(0, cfg.width, n_feat).astype(np.float32)
        depth = rng.uniform(4, 30, n_feat).astype(np.float32)
        octv = rng.integers(0, cfg.orb.n_levels, n_feat).astype(np.int32)
        ang = rng.uniform(0, 360, n_feat).astype(np.float32)
        fdesc = rng.integers(0, 2 ** 32, (n_feat, 8), dtype=np.uint32)
        valid = np.ones(n_feat, bool)

        t0 = time.perf_counter()
        k = m.add_keyframe(R, t, xy, ur, depth, octv, ang, fdesc, valid, bind,
                           frame_id=i, timestamp=0.1 * i)
        t_addkf = time.perf_counter() - t0

        # retrieval index: structured word sets (neighbours share words)
        words = np.concatenate([word_pool[(i * 60 + np.arange(180)) % len(word_pool)],
                                rng.integers(0, n_words, 120)])
        t0 = time.perf_counter()
        kfdb.add(k, words.astype(np.int64))
        t_kfdb_add = time.perf_counter() - t0

        # periodic work at the real cadences, on the recording iterations
        t_covis = t_query = t_cull = t_snap = 0.0
        if i % 10 == 9:
            t0 = time.perf_counter()
            m.covisible_keyframes(k)
            t_covis = time.perf_counter() - t0
            t0 = time.perf_counter()
            connected = set(int(v) for v in m.covisible_keyframes(k))
            kfdb.detect_loop_candidates(k, 0.01, connected, lambda x: m.covisible_keyframes(x, 10))
            t_query = time.perf_counter() - t0
            t0 = time.perf_counter()
            m.local_map_snapshot(np.asarray([k], np.int64), cfg.tracking.local_points_cap)
            t_snap = time.perf_counter() - t0
        if i % 25 == 24 and i > 50:
            # cull a mid-age keyframe (erase, mTcp, the database's erase)
            victim = k - 10
            if m.kf_valid[victim]:
                t0 = time.perf_counter()
                m.erase_keyframe(victim)
                t_cull = time.perf_counter() - t0

        if i % 100 == 99:
            rec = {"n_kf": int(m.n_kf), "n_mp": int(m.mp_valid.sum()),
                   "ms_add_kf": 1e3 * t_addkf, "ms_add_points": 1e3 * t_addmp,
                   "ms_kfdb_add": 1e3 * t_kfdb_add, "ms_covis_query": 1e3 * t_covis,
                   "ms_loop_candidates": 1e3 * t_query, "ms_snapshot": 1e3 * t_snap,
                   "ms_kf_cull": 1e3 * t_cull, "elapsed_s": time.perf_counter() - t_all}
            curves.append(rec)
            log({k_: (round(v, 2) if isinstance(v, float) else v) for k_, v in rec.items()})
    return curves


def _timed(fn, dev):
    """(result, ms of one call): CUDA events on a card, the host clock on
    the CPU."""
    if dev.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(dev)
        start.record()
        out = fn()
        end.record()
        torch.cuda.synchronize(dev)
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, 1e3 * (time.perf_counter() - t0)


def _launches(fn, dev):
    """Kernels one call launches (torch.profiler, device activity only: the
    host operators' events of a 94k-launch solve take minutes to process);
    None on the CPU, where `fn` is not called."""
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize(dev)
    return sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)


def global_ba(cfg, m, dev, log=print) -> dict:
    """One all-keyframe global-BA assembly (the first keyframe fixed), its
    upload and flat index, and GBA_ITERS Huber gba_iteration steps from the
    map's state; the map is not written. Returns the times, the costs
    (robust cost before and after, and each iteration's candidate cost),
    the final damping and poses, and the problem's sizes."""
    from orb_slam2_2021_tpu_torch.convert import camera_from_config
    from orb_slam2_2021_tpu_torch.optim.assemble import (assemble_ba_problem, global_problem_shapes,
                                                         upload_problem)
    from orb_slam2_2021_tpu_torch.optim.ba import _delta2, _residual_chi2, _total_cost
    from orb_slam2_2021_tpu_torch.optim.ba_cg import flat_index, gba_iteration

    kfs = np.nonzero(m.kf_valid)[0]
    mp = np.nonzero(m.mp_valid)[0]
    mp = mp[m.mp_obs_n[mp] > 0]
    n_obs = int(np.count_nonzero(m.mp_obs_kf[mp] >= 0))
    t0 = time.perf_counter()
    C_pad, P_pad, O_pad = global_problem_shapes(len(kfs), len(mp), n_obs)
    prob_np, _, _, _ = assemble_ba_problem(m, kfs, kfs != kfs[0], mp, C_pad, P_pad, O_pad)
    t_assemble = time.perf_counter() - t0
    t0 = time.perf_counter()
    prob = upload_problem(prob_np, dev)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_upload = time.perf_counter() - t0
    index, ms_index = _timed(lambda: flat_index(prob), dev)
    log(f"GBA problem: C={len(kfs)} P={len(mp)} O={n_obs} (padded {C_pad}/{P_pad}/{O_pad}), "
        f"assembled in {t_assemble:.2f} s, uploaded in {t_upload:.2f} s, flat index {ms_index:.1f} ms")

    cam = camera_from_config(cfg)
    active = prob.obs_valid.to(torch.float32)

    def cost(R, t, xw):
        chi2, _ = _residual_chi2(cam, prob, R, t, xw)
        return float(_total_cost(chi2, active, _delta2(prob, chi2, cfg.optim), True))

    R, t, xw = prob.R, prob.t, prob.xw
    lam = torch.tensor(cfg.optim.lm_lambda_init, dtype=torch.float32, device=dev)
    cost_before = cost(R, t, xw)
    iter_ms, iter_s, costs = [], [], []
    for it in range(GBA_ITERS):
        t0 = time.perf_counter()
        (R, t, xw, lam, c), ms = _timed(
            lambda: gba_iteration(cam, prob, index, R, t, xw, lam, active, True, cfg.optim), dev)
        iter_s.append(time.perf_counter() - t0)
        iter_ms.append(ms)
        costs.append(float(c))
        log(f"GBA iter {it}: {ms:.2f} ms  cost={costs[-1]:.3e}")
    cost_after = cost(R, t, xw)
    onehot_bytes = index.onehot.numel() * index.onehot.element_size()
    return {"C": int(len(kfs)), "P": int(len(mp)), "O": n_obs, "C_pad": C_pad, "P_pad": P_pad,
            "O_pad": O_pad, "assemble_s": t_assemble, "upload_s": t_upload,
            "flat_index_ms": ms_index, "iter_ms": iter_ms, "iter_s": iter_s, "costs": costs,
            "cost_before": cost_before, "cost_after": cost_after, "lam": float(lam),
            "onehot_bytes": int(onehot_bytes), "R": R.cpu().numpy(), "t": t.cpu().numpy()}


def _edge_cost(g, s, R, t) -> float:
    """The pose graph's weighted squared Sim3 edge residuals at (s, R, t)."""
    from orb_slam2_2021_tpu_torch.optim.sim3_opt import _edge_residual

    zero = torch.zeros((g.edge_i.shape[0], 7), dtype=s.dtype, device=s.device)
    r = _edge_residual(zero, zero, s[g.edge_i], R[g.edge_i], t[g.edge_i], s[g.edge_j], R[g.edge_j],
                       t[g.edge_j], g.m_s, g.m_R, g.m_t)
    return float(torch.sum(torch.sum(r * r, dim=-1) * g.weight))


def essential_graph(cfg, m, kfdb, dev, log=print) -> dict:
    """LoopClosing._optimize_essential_graph over every keyframe, with a
    loop edge from the last keyframe to the first (fixed), as the reference
    script runs it; writes the corrected poses and points into `m`.
    Returns the host seconds of the call and of the write-back after the
    solve, the solve's ms (CUDA events), its launches, the graph's sizes
    and incidence bytes, and its edge cost before and after."""
    from orb_slam2_2021_tpu_torch.pipeline import loop_closing

    lc = loop_closing.LoopClosing(cfg, m, kfdb, dev)
    kfs = np.nonzero(m.kf_valid)[0]
    seen = {}
    solve = loop_closing.essential_graph_solve

    def recorded(g, fix_scale, *a, **kw):
        (out, ms) = _timed(lambda: solve(g, fix_scale, *a, **kw), dev)
        seen.update(graph=g, fix_scale=fix_scale, out=out, ms=ms, returned=time.perf_counter())
        return out

    t0 = time.perf_counter()
    lc.loop_edges.setdefault(int(kfs[-1]), set()).add(int(kfs[0]))
    loop_closing.essential_graph_solve = recorded
    try:
        lc._optimize_essential_graph(
            int(kfs[-1]), int(kfs[0]),
            {int(kfs[-1]): (1.0, m.kf_R[kfs[-1]].copy(), m.kf_t[kfs[-1]].copy())}, {}, {})
    finally:
        loop_closing.essential_graph_solve = solve
    t_end = time.perf_counter()
    g = seen["graph"]
    K_pad, E_pad = int(g.s.shape[0]), int(g.edge_i.shape[0])
    E = int((g.weight > 0).sum())
    inc_bytes = 2 * E_pad * K_pad * g.s.element_size()
    t_count = time.perf_counter()
    launches = _launches(lambda: solve(g, seen["fix_scale"]), dev)
    t_count = time.perf_counter() - t_count
    out = {"s": t_end - t0, "solve_ms": seen["ms"], "writeback_s": t_end - seen["returned"],
           "launches": launches, "launch_count_s": t_count, "K": int(len(kfs)), "K_pad": K_pad, "E": E, "E_pad": E_pad,
           "incidence_bytes": int(inc_bytes), "cost_before": _edge_cost(g, g.s, g.R, g.t),
           "cost_after": _edge_cost(g, *seen["out"]), "n_points": int(m.mp_valid.sum())}
    log(f"essential graph over {len(kfs)} KFs: {out['s']:.2f} s, solve {out['solve_ms']:.1f} ms, "
        f"{launches} launches, E={E} (padded {E_pad}) x K_pad={K_pad}, incidence "
        f"{inc_bytes / 1e6:.1f} MB, write-back {out['writeback_s']:.2f} s, edge cost "
        f"{out['cost_before']:.3e} -> {out['cost_after']:.3e}")
    return out


def run(n_kf_target: int = 1500, device="cuda", log=print) -> dict:
    """The whole scale proof on `device`; returns the record (numbers only)."""
    from orb_slam2_2021_tpu_torch import resolve_device
    from orb_slam2_2021_tpu_torch.config import kitti_stereo_config
    from orb_slam2_2021_tpu_torch.mapping.map_store import MapStore
    from orb_slam2_2021_tpu_torch.place.bundle import PlaceRecognition

    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    cfg = kitti_stereo_config()
    m = MapStore(cfg)
    place = PlaceRecognition.load_default(dev)
    kfdb = place.kfdb
    m.on_kf_erased = kfdb.erase
    t_all = time.perf_counter()
    curves = grow(cfg, m, kfdb, place.voc.n_words, n_kf_target, log)
    t_grow = time.perf_counter() - t_all
    gba = global_ba(cfg, m, dev, log)
    gba.pop("R"), gba.pop("t")
    eg = essential_graph(cfg, m, kfdb, dev, log)
    R_ok = bool(np.isfinite(m.kf_R[m.kf_valid]).all() and np.isfinite(m.kf_t[m.kf_valid]).all())
    return {
        "n_kf_final": int(m.n_kf),
        "n_mp_final": int(m.mp_valid.sum()),
        "n_obs_final": gba["O"],
        "curves": curves,
        "grow_s": t_grow,
        "gba_assemble_s": gba["assemble_s"],
        "gba_iter_s": gba["iter_s"],
        "gba": gba,
        "essential_graph_s": eg["s"],
        "essential_graph": eg,
        "poses_finite": R_ok,
        "peak_memory_bytes": int(torch.cuda.max_memory_allocated(dev)) if dev.type == "cuda" else None,
        "total_s": time.perf_counter() - t_all,
        "platform": dev.type,
        "device_name": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_kf", nargs="?", type=int, default=1500)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None, help="also write the JSON record to this file")
    args = ap.parse_args(argv)
    if args.out and os.path.abspath(args.out) == os.path.join(REPO, "SCALE_1500KF.json"):
        raise SystemExit("SCALE_1500KF.json is the reference's record; pass another --out")
    sys.path.insert(0, REPO)
    out = run(args.n_kf, args.device)
    text = json.dumps(out, indent=1)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    print(f"total {out['total_s']:.0f} s on {out['device_name']}")


if __name__ == "__main__":
    main()
