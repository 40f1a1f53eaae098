"""Spans, counters and the device trace, taken from the benchmark's side.

`Probes` wraps the port's layer entries for the length of a run, without
editing the port: the frame build the System calls (`build_stereo_frame_from_u8`,
`build_rgbd_frame`, `build_mono_frame`), the tracker
(`Tracking.track_stereo_frame`), local mapping's per-keyframe pipeline
(`LocalMapping._process`), its keyframe queue (`insert_keyframe`) and its
abortable local BA (`_solve_ba_abortable`, whose LM phases it counts), and
the K1 matcher (`ops.hamming.hamming_best2`,
wherever the port imported it), whose shapes it records per call. The
frame-build wrapper also keeps each frame the build produced, which the
correctness check compares with the reference. With `sync` (traced runs
only) a span ends after its stream has finished, so its time is the layer's
device time too.

`DeviceTrace` runs `torch.profiler` over the traced window and reduces it
to counts and sums in one pass over the raw events.
"""

from __future__ import annotations

import ctypes
import threading
import time
from collections import defaultdict

import torch

from . import stats

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx",
                "cudaGraphLaunch", "cuGraphLaunch", "cudaLaunchCooperativeKernel")
K1_KERNEL = "hamming_best2"   # in the names of K1's main kernel and its merge (names may be mangled)
TOP = 10
NAME_CAP = 160


class Probes:
    """Wrappers around the port's layer entries; `install` before the
    System is built, `uninstall` when the run is over."""

    def __init__(self, device, sync: bool = False, fault=None):
        self.device = torch.device(device)
        self.sync = sync and self.device.type == "cuda"
        self.fault = fault            # None, or a callable(kind, value) -> value (tests and controls)
        self.spans = defaultdict(list)  # name -> [(t0_ns, t1_ns)]
        self.k1_calls = []              # (t_ns, n, m, t)
        self.kf_inserts = []            # t_ns of each keyframe queued by the lane
        self.ba_solves = []             # (t_ns, LM phases run) of each abortable local BA
        self._lm_phases = 0
        self.frames = {}                # frame index -> the program's Frame
        self.frame_index = -1           # set by the drive loop before each call
        self.keep_frames = False
        self._undo = []

    def _span(self, name, t0):
        if self.sync:
            torch.cuda.current_stream(self.device).synchronize()
        self.spans[name].append((t0, time.perf_counter_ns()))

    def _patch(self, owner, attr, make):
        orig = getattr(owner, attr)
        setattr(owner, attr, make(orig))
        self._undo.append((owner, attr, orig))

    def install(self):
        from orb_slam2_2021_tpu_torch.frontend import frame as p_frame
        from orb_slam2_2021_tpu_torch.frontend import matchers as p_matchers
        from orb_slam2_2021_tpu_torch.ops import hamming as p_hamming
        from orb_slam2_2021_tpu_torch.pipeline import local_mapping as p_lm
        from orb_slam2_2021_tpu_torch.pipeline import mapping_steps as p_steps
        from orb_slam2_2021_tpu_torch.pipeline import system as p_system
        from orb_slam2_2021_tpu_torch.pipeline import tracking as p_tracking

        def build(orig):
            def wrapped(*a, **k):
                t0 = time.perf_counter_ns()
                f = orig(*a, **k)
                if self.fault is not None:
                    f = self.fault("frame", f)
                self._span("lane.build", t0)
                if self.keep_frames:
                    self.frames[self.frame_index] = f
                return f
            return wrapped

        def track(orig):
            def wrapped(tracker, *a, **k):
                t0 = time.perf_counter_ns()
                if self.fault is not None and self.keep_frames and self.fault("track", None):
                    out = tracker.last_pose          # the tracker's state left unchanged
                else:
                    out = orig(tracker, *a, **k)
                self._span("lane.track", t0)
                return out
            return wrapped

        def process(orig):
            def wrapped(mapper, *a, **k):
                t0 = time.perf_counter_ns()
                try:
                    return orig(mapper, *a, **k)
                finally:
                    self._span("mapping.kf", t0)
            return wrapped

        def insert(orig):
            def wrapped(*a, **k):
                self.kf_inserts.append(time.perf_counter_ns())
                return orig(*a, **k)
            return wrapped

        def solve(orig):
            def wrapped(mapper, *a, **k):
                n0 = self._lm_phases
                out = orig(mapper, *a, **k)
                self.ba_solves.append((time.perf_counter_ns(), self._lm_phases - n0))
                return out
            return wrapped

        def phase(orig):
            def wrapped(*a, **k):
                self._lm_phases += 1
                return orig(*a, **k)
            return wrapped

        def k1(orig):
            def wrapped(a, b, mask):
                self.k1_calls.append((time.perf_counter_ns(), int(a.shape[0]), int(b.shape[-2]),
                                      int(b.shape[0]) if b.dim() == 3 else 1))
                return orig(a, b, mask)
            return wrapped

        self._patch(p_system, "build_stereo_frame_from_u8", build)
        self._patch(p_system, "build_rgbd_frame", build)
        self._patch(p_system, "build_mono_frame", build)
        self._patch(p_tracking.Tracking, "track_stereo_frame", track)
        self._patch(p_lm.LocalMapping, "_process", process)
        self._patch(p_lm.LocalMapping, "insert_keyframe", insert)
        self._patch(p_lm.LocalMapping, "_solve_ba_abortable", solve)
        self._patch(p_lm, "lm_chunk_pq", phase)
        for mod in (p_hamming, p_frame, p_matchers, p_steps):
            self._patch(mod, "hamming_best2", k1)

    def uninstall(self):
        while self._undo:
            owner, attr, orig = self._undo.pop()
            setattr(owner, attr, orig)

    def between(self, name, lo, hi):
        """Spans of `name` that ended inside [lo, hi) (perf_counter ns)."""
        return [(a, b) for a, b in self.spans.get(name, ()) if lo <= b < hi]


class DeviceTrace:
    """torch.profiler over the window, CUDA activity only: the device's
    kernel, copy and set records and the runtime API calls, without a
    record for every host-side operator (which doubled the lane's frame
    time). Its timestamps are the system clock's (time.time_ns)."""

    def __init__(self):
        self.prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        self.t0 = self.t1 = None   # perf_counter ns of the traced stretch
        self.w0 = self.w1 = None   # the same instants on the system clock
        self.lane_tids = ()

    def start(self):
        """Start tracing; call it on the lane's thread."""
        self.lane_tids = lane_thread_ids()
        self.prof.start()
        self.t0, self.w0 = time.perf_counter_ns(), time.time_ns()

    def stop(self):
        torch.cuda.synchronize()
        self.t1, self.w1 = time.perf_counter_ns(), time.time_ns()
        self.prof.stop()

    def reduce(self, probes: Probes) -> dict:
        """Reduce the raw events (see `reduce_events`)."""
        events = self.prof.profiler.kineto_results.events()
        off = self.w0 - self.t0          # system clock - perf_counter
        cuda = torch.autograd.DeviceType.CUDA
        rows = [(e.name(), e.device_type() == cuda, e.start_ns(), e.duration_ns(), e.device_resource_id())
                for e in events]
        return reduce_events(rows, self.w0, self.w1, self.lane_tids, lambda t: host_state(probes, t - off))


def lane_thread_ids():
    """The ids a runtime API event of the calling thread carries as its
    `device_resource_id`: the thread's system id (with CPU activity on) or
    the low 32 bits of its pthread id, signed (CUDA activity alone)."""
    return (threading.get_native_id(), ctypes.c_int32(threading.get_ident() & 0xFFFFFFFF).value)


def host_state(probes: Probes, t):
    """What the host was in at perf_counter time t: the lane's innermost
    span (or the pacing sleep, or the harness), and the mapping worker's
    keyframe if one was in flight."""
    lane = "harness"
    for name in ("lane.build", "lane.track", "lane.frame", "lane.pace"):
        if any(a <= t < b for a, b in probes.spans.get(name, ())):
            lane = name
            break
    if any(a <= t < b for a, b in probes.spans.get("mapping.kf", ())):
        lane += "+mapping.kf"
    return lane


def reduce_events(rows, lo, hi, lane_tids, label) -> dict:
    """One pass over (name, on_device, start_ns, duration_ns, thread) rows of
    a trace whose window is [lo, hi) ns: the device's busy time (the union of
    its intervals), time by kernel name, K1's device time and main-kernel
    count, the launch calls by thread (those of the ids in `lane_tids`
    apart), and the longest idle gaps, each named by `label(midpoint)`."""
    busy, by_name = [], defaultdict(float)
    k1_s, k1_n = 0.0, 0
    launches = defaultdict(int)
    for name, on_device, s, d, tid in rows:
        if on_device:
            busy.append((s, s + d))
            by_name[name] += d * 1e-9
            if K1_KERNEL in name:
                k1_s += d * 1e-9
                k1_n += K1_KERNEL + "_kernel" in name
        elif name in LAUNCH_CALLS:
            launches[tid] += 1
    gaps = sorted(stats.idle_gaps(busy, lo, hi), key=lambda g: g[0] - g[1])[:TOP]
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (hi - lo) * 1e-9, "busy_s": stats.union_length(busy, lo, hi) * 1e-9,
        "lane_launches": sum(launches.get(t, 0) for t in set(lane_tids)),
        "launches_by_thread": dict(launches),
        "k1_device_s": k1_s, "k1_kernels": k1_n,
        "device_ops": [[n[:NAME_CAP], s] for n, s in top],
        "idle_gaps": [[label((s + e) / 2), (e - s) * 1e-9] for s, e in gaps],
    }
