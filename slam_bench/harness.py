"""One run of one cell: set-up, the timed window, the correctness check.

Everything a cell is made of is found by name from `BENCHMARK.json`: the
configuration (`configs/<name>.yaml`, an upstream ORB-SLAM2 settings file,
and `configs/<name>.json`, the sensor, threading, camera rate and what was
assumed), the traffic (`traffic/<name>.json`, whose `generator` names the
module of `gen/` that renders it), the limits of the comparison
(`limits/<cell>.json`) and each per-layer metric (`metrics/<metric>.py`, a
`read(ctx)` that returns a number or None).

The window drives the System entry of the configuration's sensor (`SENSORS`:
`track_stereo`, `track_rgbd` or `track_monocular` of
`orb_slam2_2021_tpu_torch`), in the configuration's `async_mode`, frame by
frame, closed loop and paced as the upstream examples pace: a frame is
handed in when the last call has returned and, if that was early, once the
camera period since the last hand-over has passed.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import math
import os
import subprocess
import sys
import time
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Callable, Optional

import numpy as np

from . import stats
from .reference import checks
from .reference.settings import settings_from_yaml

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "orb_slam2_2021_tpu")


def log(msg: str):
    print(msg, file=sys.stderr, flush=True)


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


@dataclass(frozen=True)
class Sensor:
    """How a sensor's frames reach the System and the reference."""
    track: Callable      # (system, images, depth, i, timestamp) -> pose
    metric_scale: bool   # the trajectory and map are in metres (mono: up to a scale)


SENSORS = {
    "stereo": Sensor(lambda s, im, d, i, ts: s.track_stereo(im[i, 0], im[i, 1], ts), True),
    "rgbd": Sensor(lambda s, im, d, i, ts: s.track_rgbd(im[i], d[i], ts), True),
    "mono": Sensor(lambda s, im, d, i, ts: s.track_monocular(im[i], ts), False),
}


def generator(name: str):
    """The module gen/<name>.py."""
    if not name.isidentifier():
        raise SystemExit(f"bad generator name {name!r}")
    return importlib.import_module(f"{__package__}.gen.{name}")


@dataclass
class Cell:
    """A cell resolved to its files."""
    name: str
    sensor: str
    async_mode: bool
    camera_hz: float
    yaml_path: str
    overrides: dict
    gen: object        # the traffic's generator module
    traffic: object    # its parameters, as gen.params reads the traffic file
    limits: dict
    per_layer: list = field(default_factory=list)     # BENCHMARK.json entries reported in this cell
    units: dict = field(default_factory=dict)         # metric name -> unit


def resolve_cell(workload: str, root: str = ROOT) -> Cell:
    """The cell `workload` of `root`/BENCHMARK.json, from its files."""
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    cfg_file = next(c["file"] for c in bench["configs"] if c["name"] == w["config"])
    meta = load_json(os.path.join(root, cfg_file))
    per_layer = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    traffic = load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json"))
    gen = generator(traffic["generator"])
    if meta["sensor"] not in SENSORS:
        raise SystemExit(f"unknown sensor {meta['sensor']!r}; the harness has {sorted(SENSORS)}")
    return Cell(
        name=workload, sensor=meta["sensor"], async_mode=bool(meta["async_mode"]),
        camera_hz=float(meta["camera_hz"]),
        yaml_path=os.path.join(root, os.path.dirname(cfg_file), meta["settings"]),
        overrides={k: v for k, v in meta.get("assumed", {}).items() if isinstance(v, (int, float))},
        gen=gen, traffic=gen.params(traffic),
        limits=load_json(os.path.join(HERE, "limits", workload + ".json")),
        per_layer=per_layer, units=units)


def metric_reader(name: str):
    """The `read(ctx)` of metrics/<name>.py."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(f"slam_bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def card_facts() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e.__class__.__name__})"


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _frame_arrays(f) -> dict:
    """The features of a Frame as host arrays, for the comparison."""
    return {"xy": f.kp.xy.cpu().numpy(), "octave": f.kp.octave.cpu().numpy(),
            "desc": f.kp.desc.cpu().numpy(), "valid": f.kp.valid.cpu().numpy(),
            "u_right": f.u_right.cpu().numpy(), "depth": f.depth.cpu().numpy()}


def reference_frame(sensor, settings, image, depth_u16, device) -> dict:
    """The reference's frame build from the same host images."""
    import torch

    from .reference import orb

    img = torch.from_numpy(np.ascontiguousarray(image)).to(device).to(torch.float32)
    if sensor == "stereo":
        f = orb.build_stereo_frame(img[0], img[1], settings)
    elif sensor == "rgbd":
        d = torch.from_numpy(np.asarray(depth_u16, np.float32)).to(device)
        f = orb.build_rgbd_frame(img, d, settings, settings.depth_scale)
    else:
        f = orb.build_mono_frame(img, settings)
    return _frame_arrays(f)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, t_process0: float,
             fault: Optional[Callable] = None, tf32: bool = False) -> dict:
    """Set up, drive the window, check; returns the pieces of the result
    line (`metrics` as name -> value) and what the run printed as facts."""
    import torch

    from orb_slam2_2021_tpu_torch.config import config_from_yaml
    from orb_slam2_2021_tpu_torch.pipeline.system import System
    from orb_slam2_2021_tpu_torch.pipeline.tracking import TrackState

    from .tracing import DeviceTrace, Probes

    if tf32:   # the control: TF32 where the package pins float32
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    tr = cell.traffic
    sensor = SENSORS[cell.sensor]
    settings = settings_from_yaml(cell.yaml_path)
    cfg = config_from_yaml(cell.yaml_path, **cell.overrides)
    period = 1.0 / cell.camera_hz

    # traffic: every frame the window could take, rendered on the device
    t_r0 = time.perf_counter()
    n_frames = tr.warmup_frames + int(math.ceil(seconds * cell.camera_hz)) + 2
    poses, imgs, depth, surface = cell.gen.generate(tr, settings, cell.sensor, seed, n_frames, dev)
    if on_card:
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    render_s = time.perf_counter() - t_r0

    probes = Probes(dev, sync=trace, fault=fault)
    probes.install()
    try:
        t_s0 = time.perf_counter()
        sys_ = System(cfg, sensor=cell.sensor, async_mode=cell.async_mode, device=dev)
        system_s = time.perf_counter() - t_s0
        est = {}
        lost_state = TrackState.LOST

        def hand(i):
            probes.frame_index = i
            t0 = time.perf_counter_ns()
            pose = sensor.track(sys_, imgs, depth, i, i * period)
            probes.spans["lane.frame"].append((t0, time.perf_counter_ns()))
            est[i] = pose
            return pose

        def pace(t_hand, t_now, t_stop):
            wake = min(t_hand + period, t_stop)
            if wake > t_now:
                t0 = time.perf_counter_ns()
                time.sleep(wake - t_now)
                probes.spans["lane.pace"].append((t0, time.perf_counter_ns()))

        t_w0 = time.perf_counter()
        for i in range(tr.warmup_frames):
            t_hand = time.perf_counter()
            hand(i)
            pace(t_hand, time.perf_counter(), math.inf)
        if sys_.async_mode:
            sys_.local_mapper.wait_idle(sys_._worker)
        if on_card:
            torch.cuda.synchronize(dev)
        warmup_s = time.perf_counter() - t_w0
        map_at_start = {"keyframes_at_window_start": int(sys_.map.n_kf),
                        "map_points_at_window_start": int(sys_.map.mp_valid.sum())}

        # the window
        dtrace = DeviceTrace() if trace else None
        probes.keep_frames = True
        lm = sys_.local_mapper
        n_ba0 = len(lm.ba_solve_times) if lm is not None else 0
        n_solves0 = len(probes.ba_solves)
        if dtrace is not None:
            dtrace.start()
        setup_s = time.time() - t_process0
        t_start = time.perf_counter()
        t_end = t_start + seconds
        lat, returned, failed, i = [], [], 0, tr.warmup_frames
        while i < n_frames:
            t_hand = time.perf_counter()
            if t_hand >= t_end:
                break
            pose = hand(i)
            t_ret = time.perf_counter()
            lat.append(t_ret - t_hand)
            if t_ret < t_end:
                returned.append(i)
            if pose is None or sys_.tracker.state == lost_state:
                failed += 1
            i += 1
            pace(t_hand, t_ret, t_end)
        t_close = time.perf_counter()
        if dtrace is not None:
            dtrace.stop()
        if tf32:   # the reference below computes as the configuration states
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
        probes.keep_frames = False
        window_ns = (int(t_start * 1e9), int(t_end * 1e9))
        # local BA in the window: each solve's phases (2 complete, 1 cut
        # after the first by a newly inserted keyframe, 0 aborted before
        # it) beside the port's times of those that returned a result
        phases = [n for t, n in probes.ba_solves[n_solves0:] if t < window_ns[1]]
        timed = lm.ba_solve_times[n_ba0:] if lm is not None else []
        ba_window = [s for (s, _), n in zip(timed, [n for n in phases if n > 0]) if n == 2]
        memory_peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

        # the program's outputs, then its state freed
        sys_.shutdown()
        m = sys_.map
        points = m.mp_pos[np.nonzero(m.mp_valid)[0]].astype(np.float64)
        rng = np.random.default_rng(seed)
        sample = sorted(rng.choice(returned, size=min(tr.check_frames, len(returned)), replace=False)
                        .tolist()) if returned else []
        prog_frames = {j: _frame_arrays(probes.frames[j]) for j in sample}
        probes.frames.clear()
        del sys_, m
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
    finally:
        probes.uninstall()

    # per-layer metrics (traced runs): spans and counts inside the window
    per_layer = {}
    reduced = None
    t_c0 = time.perf_counter()
    if trace:
        t0_ns, t1_ns = dtrace.t0, dtrace.t1
        reduced = dtrace.reduce(probes)
        frames_traced = sum(1 for a, b in probes.spans["lane.frame"] if t0_ns <= a and b <= t1_ns)
        ctx = SimpleNamespace(
            frames=frames_traced,
            span_s={k: [(b - a) * 1e-9 for a, b in probes.between(k, t0_ns, t1_ns)]
                    for k in list(probes.spans)},
            kf_inserted=sum(1 for t in probes.kf_inserts if t0_ns <= t < t1_ns),
            ba_solve_s=ba_window,
            k1_calls=[c[1:] for c in probes.k1_calls if t0_ns <= c[0] < t1_ns],
            trace=reduced)
        for m_ in cell.per_layer:
            v = metric_reader(m_["name"])(ctx)
            if v is not None:
                per_layer[m_["name"]] = v

    reduce_s = time.perf_counter() - t_c0

    # the comparison with the plain reference
    t_c0 = time.perf_counter()
    feat = 0.0
    for j in sample:
        ref = reference_frame(cell.sensor, settings, imgs[j], None if depth is None else depth[j], dev)
        feat = max(feat, checks.feature_diff(prog_frames[j], ref))
    if not sample:
        feat = float("inf")
    tracked = sorted(k for k, p in est.items() if p is not None)
    map_err = ate = float("inf")
    if len(tracked) >= 3:
        centres = [-(est[k][0].astype(np.float64).T @ est[k][1].astype(np.float64)) for k in tracked]
        gt = poses[tracked, :3, 3]
        ate = checks.ate_percent(centres, gt, scale=not sensor.metric_scale)
        if not sensor.metric_scale:   # the map in metres, by the trajectory's alignment
            M, t = checks.rigid_align(centres, gt, scale=True)
            points = points @ M.T + t
        map_err = cell.gen.map_error_percent(points, surface)
    numbers = {"feat_diff": feat, "ate_pct": ate, "map_err_pct": map_err}
    check = {k: {"value": v, "limit": cell.limits[k]} for k, v in numbers.items()}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in check.values())
    check_s = time.perf_counter() - t_c0

    window_s = t_end - t_start
    kf_window = sum(1 for t in probes.kf_inserts if window_ns[0] <= t < window_ns[1])
    e2e = {}
    if lat:
        e2e = {"frames_per_s": stats.rate(len(returned), window_s),
               "frame_ms_p50": 1e3 * stats.percentile(lat, 50),
               "frame_ms_p90": 1e3 * stats.percentile(lat, 90),
               "setup_s": setup_s}
    return {
        "correct": correct, "attempted": len(lat), "failed": failed,
        "e2e": e2e, "per_layer": per_layer, "check": check, "trace": reduced,
        "memory_peak": memory_peak,
        "facts": {
            "frames_in_window": len(returned), "p90_samples": len(lat),
            "frames_beyond_p90": len(lat) - int(math.ceil(0.9 * len(lat))) if lat else 0,
            **map_at_start,
            "keyframes_inserted_in_window": kf_window,
            "kf_per_frame": kf_window / len(lat) if lat else 0.0,
            "keyframes_total": len(probes.kf_inserts), "map_points": int(len(points)),
            "local_ba_complete_in_window": phases.count(2),
            "local_ba_cut_after_phase1_in_window": phases.count(1),
            "local_ba_aborted_before_start_in_window": phases.count(0),
            "render_s": render_s, "system_s": system_s, "warmup_s": warmup_s,
            "frames_rendered": n_frames, "check_frames": sample,
            "window_closed_late_s": t_close - t_end,
            "trace_reduce_s": reduce_s, "check_s": check_s,
            "latencies_ms": [round(1e3 * x, 3) for x in lat],
        },
    }
