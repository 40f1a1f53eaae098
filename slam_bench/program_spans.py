"""The port's own spans and counters (orb_slam2_2021_tpu_torch/io/trace.py)
joined with the device trace.

`tracing.DeviceTrace` reduces torch.profiler's raw events to counts; this
module places each raw runtime event (a launch call, with its thread) and
each idle gap of the device inside the innermost program span open on the
thread at that instant. It gives, for a traced window:

- by stage (the innermost span's name) on the lane and on the mapping
  worker: launch calls, host time (each instant counted once, in its
  innermost span) and the share of the device's idle time;
- the share of the lane's launch calls that fell inside a lane span (the
  check that the two clocks agree);
- an idle gap's label refined by the innermost lane and worker spans
  (`refine_label`);
- the per-layer readings `readings` names.

Spans arrive as the recorder's `Span` tuples (or any tuple with the same
fields) already on the profiler's clock: `on_profiler_clock(records)`.
Pure Python and numpy; it imports neither torch nor the port.
"""

from __future__ import annotations

from bisect import bisect_right
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from . import stats

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cuGraphLaunch", "cudaLaunchCooperativeKernel")
NOT_NESTED = ("mapping.queued",)   # an interval between threads, not work of the thread it is on


def on_profiler_clock(records) -> list:
    """The records' spans with their stamps on the profiler's clock."""
    off = records.offset_ns
    return [s._replace(t0=s.t0 + off, t1=s.t1 + off) for s in records.spans]


def is_build(name: str) -> bool:
    return name == "build" or name.startswith("build.")


def is_track(name: str) -> bool:
    return name == "track" or name.startswith("track.")


class Timeline:
    """One thread's spans flattened into segments, each labelled with the
    path of spans open over it (outermost first)."""

    def __init__(self, spans: Iterable):
        spans = sorted((s for s in spans if s.name not in NOT_NESTED), key=lambda s: (s.t0, -s.t1))
        starts, ends, paths = [], [], []
        stack: List = []
        cur = None

        def emit(a, b):
            if stack and b > a:
                starts.append(a)
                ends.append(b)
                paths.append(tuple(x.name for x in stack))

        for s in spans:
            while stack and stack[-1].t1 <= s.t0:
                top = stack[-1]
                emit(cur, top.t1)
                cur = top.t1
                stack.pop()
            if stack:
                emit(cur, s.t0)
            cur = s.t0
            stack.append(s)
        while stack:
            top = stack[-1]
            emit(cur, top.t1)
            cur = top.t1
            stack.pop()
        self.starts = np.asarray(starts, np.int64)
        self.ends = np.asarray(ends, np.int64)
        self.paths = paths

    def path_at(self, t) -> tuple:
        """The spans open at t, outermost first (empty outside every span)."""
        i = bisect_right(self.starts, t) - 1 if len(self.starts) else -1
        return self.paths[i] if i >= 0 and t < self.ends[i] else ()

    def paths_at(self, ts: np.ndarray) -> np.ndarray:
        """Segment index of each t (-1 outside every span)."""
        if not len(self.starts):
            return np.full(len(ts), -1)
        i = np.searchsorted(self.starts, ts, side="right") - 1
        ok = (i >= 0) & (ts < self.ends[np.clip(i, 0, None)])
        return np.where(ok, i, -1)

    def time_by_innermost(self, lo, hi) -> Dict[str, int]:
        """ns of [lo, hi) by innermost span name."""
        out: Dict[str, int] = defaultdict(int)
        a = np.clip(self.starts, lo, hi)
        b = np.clip(self.ends, lo, hi)
        for p, d in zip(self.paths, (b - a).tolist()):
            if d > 0:
                out[p[-1]] += d
        return dict(out)

    def overlap_by_innermost(self, intervals, lo, hi) -> Dict[str, int]:
        """ns of the given (sorted, disjoint) intervals inside [lo, hi) by
        the innermost span open over them ("-" where none is)."""
        out: Dict[str, int] = defaultdict(int)
        for a, b in intervals:
            a, b = max(a, lo), min(b, hi)
            if b <= a:
                continue
            covered = 0
            i = max(int(np.searchsorted(self.ends, a, side="right")), 0)
            while i < len(self.starts) and self.starts[i] < b:
                d = min(b, int(self.ends[i])) - max(a, int(self.starts[i]))
                if d > 0:
                    out[self.paths[i][-1]] += d
                    covered += d
                i += 1
            out["-"] += (b - a) - covered
        return dict(out)


def thread_roles(spans) -> Dict[str, set]:
    """The thread ids (both forms) of the lane (threads with `frame` spans)
    and of the mapping worker (threads with `mapping.kf` spans that are not
    the lane's: in synchronous mode the lane maps inline)."""
    lane = {(s.tid, s.tid32) for s in spans if s.name == "frame"}
    worker = {(s.tid, s.tid32) for s in spans if s.name == "mapping.kf"} - lane
    return {"lane": lane, "worker": worker}


def _ids(pairs) -> set:
    return {x for p in pairs for x in p}


def analyse(spans: Sequence, rows: Iterable, lo: int, hi: int) -> dict:
    """Join the program's spans (profiler clock) with the raw trace rows
    (name, on_device, start_ns, duration_ns, thread) of the window [lo, hi).

    Returns per role ("lane", "worker"): `launches` by innermost span name
    ("-": outside every span), `host_ns` by innermost span name, `idle_ns`
    (the device's idle time) by the lane's / worker's innermost span, plus
    `frames` (lane `frame` spans inside the window), `keyframes` (worker
    `mapping.kf` spans inside it), the lane's launch share inside a lane
    span, `readings` and the idle gaps themselves."""
    roles = thread_roles(spans)
    ids = {r: _ids(v) for r, v in roles.items()}
    by_thread = {r: [s for s in spans if s.tid in {t for t, _ in roles[r]}] for r in roles}
    lines = {r: Timeline(by_thread[r]) for r in roles}
    launches = {r: [] for r in roles}
    busy = []
    for name, on_device, s, d, tid in rows:
        if on_device:
            busy.append((s, s + d))
        elif name in LAUNCH_CALLS and lo <= s < hi:
            for r in roles:
                if tid in ids[r]:
                    launches[r].append(s)
    gaps = stats.idle_gaps(busy, lo, hi)
    out = {"window_ns": hi - lo, "idle_ns_total": sum(b - a for a, b in gaps), "gaps": gaps}
    for r in roles:
        line = lines[r]
        ts = np.asarray(sorted(launches[r]), np.int64)
        seg = line.paths_at(ts)
        by_path: Dict[tuple, int] = defaultdict(int)
        for i, n in zip(*np.unique(seg, return_counts=True)):
            by_path[line.paths[i] if i >= 0 else ()] += int(n)
        by_stage: Dict[str, int] = defaultdict(int)
        groups: Dict[str, int] = defaultdict(int)
        for path, n in by_path.items():
            by_stage[path[-1] if path else "-"] += n
            groups[_group(path)] += n
        out[r] = {"launches": dict(by_stage), "launch_groups": dict(groups), "launch_paths": dict(by_path),
                  "n_launches": int(len(ts)),
                  "host_ns": line.time_by_innermost(lo, hi),
                  "idle_ns": line.overlap_by_innermost(gaps, lo, hi),
                  "launch_times": ts, "timeline": line}
    lane_spans, worker_spans = by_thread["lane"], by_thread["worker"]
    frames = [s for s in lane_spans if s.name == "frame" and lo <= s.t0 and s.t1 <= hi]
    kfs = [s for s in worker_spans if s.name == "mapping.kf" and lo <= s.t0 and s.t1 <= hi]
    out["frames"], out["keyframes"] = len(frames), len(kfs)
    n_lane = out["lane"]["n_launches"]
    out["lane_launch_share_in_spans"] = (1.0 - out["lane"]["launches"].get("-", 0) / n_lane) if n_lane else None
    out["readings"] = readings(out, lane_spans, worker_spans, lo, hi)
    return out


def _group(path: tuple) -> str:
    """The stage group of a launch by the spans open over it: the frame
    build (a `build*` span anywhere on the path), else tracking (a
    `track*` span), else the outermost span, else "-"."""
    if any(is_build(n) for n in path):
        return "build"
    if any(is_track(n) for n in path):
        return "track"
    return path[0] if path else "-"


def _within(spans, name, lo, hi):
    return [s for s in spans if s.name == name and lo <= s.t0 and s.t1 <= hi]


def readings(out: dict, lane_spans, worker_spans, lo: int, hi: int) -> dict:
    """The six per-layer readings the program's spans feed (None where the
    window holds nothing to read)."""
    frames = out["frames"]
    lane = out["lane"]
    res: Dict[str, Optional[float]] = {}
    res["frontend.launch_calls_per_frame"] = (lane["launch_groups"].get("build", 0) / frames
                                              if frames and lane["n_launches"] else None)
    res["tracking.launch_calls_per_frame"] = (lane["launch_groups"].get("track", 0) / frames
                                              if frames and lane["n_launches"] else None)
    rb = _within(lane_spans, "track.readback", lo, hi)
    res["tracking.readback_wait_ms"] = (1e-6 * sum(s.t1 - s.t0 for s in rb) / frames) if frames else None
    lw = _within(lane_spans, "lock.wait", lo, hi)
    res["lane.map_lock_wait_ms"] = (1e-6 * sum(s.t1 - s.t0 for s in lw) / frames) if frames else None
    res["lane.us_per_launch_mapping_ratio"] = _mapping_ratio(lane, lane_spans, worker_spans, lo, hi)
    kfs = out["keyframes"]
    w = out["worker"]
    in_kf = sum(n for path, n in w["launch_paths"].items() if "mapping.kf" in path)
    res["mapping.launch_calls_per_kf"] = in_kf / kfs if kfs and w["n_launches"] else None
    return res


def _mapping_ratio(lane, lane_spans, worker_spans, lo, hi) -> Optional[float]:
    """Host µs per lane launch in the `track` spans that overlap a worker
    `mapping.kf`, over the same in those that overlap none: `track` time
    less its `track.readback` time, over the launches inside it."""
    tracks = _within(lane_spans, "track", lo, hi)
    rb = sorted((s.t0, s.t1) for s in lane_spans if s.name == "track.readback")
    kfs = sorted((s.t0, s.t1) for s in worker_spans if s.name == "mapping.kf")
    ts = lane["launch_times"]
    sums = {True: [0, 0], False: [0, 0]}   # overlapped -> [host ns, launches]
    for s in tracks:
        n = int(np.searchsorted(ts, s.t1, side="left") - np.searchsorted(ts, s.t0, side="left"))
        wait = sum(min(b, s.t1) - max(a, s.t0) for a, b in rb if a < s.t1 and b > s.t0)
        busy = any(a < s.t1 and b > s.t0 for a, b in kfs)
        sums[busy][0] += (s.t1 - s.t0) - wait
        sums[busy][1] += n
    (h1, n1), (h0, n0) = sums[True], sums[False]
    if not (n1 and n0 and h0):
        return None
    return (h1 / n1) / (h0 / n0)


def refine_label(label: str, lane_path: tuple, worker_path: tuple) -> str:
    """An idle gap's label from `tracing.host_state` ("lane.track",
    "lane.build+mapping.kf", ...) with the innermost program span on the
    lane after its lane part and on the worker after its mapping part:
    "lane.track/track.select_local_kfs+mapping.kf/lock.hold"."""
    lane_part, plus, rest = label.partition("+")
    if lane_path:
        lane_part += "/" + lane_path[-1]
    if plus:
        rest += ("/" + worker_path[-1]) if worker_path else ""
        return lane_part + "+" + rest
    return lane_part


def stage_table(out: dict, role: str = "lane") -> List[tuple]:
    """(stage, launches a frame, host ms a frame, share of the idle window)
    for one role, by innermost span, largest idle share first."""
    frames = max(out["frames"], 1)
    r = out[role]
    idle_total = max(out["idle_ns_total"], 1)
    names = set(r["launches"]) | set(r["host_ns"]) | set(r["idle_ns"])
    rows = [(n, r["launches"].get(n, 0) / frames, 1e-6 * r["host_ns"].get(n, 0) / frames,
             r["idle_ns"].get(n, 0) / idle_total) for n in names]
    return sorted(rows, key=lambda x: -x[3])
