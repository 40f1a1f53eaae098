"""The port's span-and-counter recorder (orb_slam2_2021_tpu_torch/io/trace.py):
off it records nothing, reads no clock and allocates nothing; on, spans
nest per thread with their parents and keys, the map lock records its waits
and holds, a synchronous System drive on the CPU gives every frame one
`frame` span over its `build.*` and `track.*` children, a keyframe's
creation and its local mapping share the keyframe's id, and a local BA whose
second LM phase was aborted records the iterations it ran. Nothing the
recorder does synchronises a device.
"""

import ast
import inspect
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

from orb_slam2_2021_tpu_torch.config import synthetic_config
from orb_slam2_2021_tpu_torch.io import trace
from orb_slam2_2021_tpu_torch.io.synthetic import SyntheticStereoWorld, forward_trajectory
from orb_slam2_2021_tpu_torch.pipeline import local_mapping
from orb_slam2_2021_tpu_torch.pipeline.system import System

torch.set_num_threads(1)

CFG = synthetic_config(width=320, height=240)
N_FRAMES = 20   # keyframes at frames 0, 15 and 19, a local BA on the last
WAIT_S = 60.0


@pytest.fixture(autouse=True)
def recorder_off():
    """Every test starts and ends with the recorder off."""
    trace.stop()
    yield
    trace.stop()


def _raise(*a, **k):
    raise AssertionError("called while it must not be")


def _pthread_low32():
    low = threading.get_ident() & 0xFFFFFFFF
    return low - (1 << 32) if low >= 1 << 31 else low


def _off_calls(lock):
    with trace.span("a"):
        with trace.span("b", key=3):
            trace.count("c", 1)
    trace.begin("d").end()
    trace.begin("e", 5).end(6)
    trace.record("f", 1, 2)
    assert trace.stamp() is None
    with lock:
        with lock:
            pass


def test_off_records_nothing_reads_no_clock_and_allocates_nothing(monkeypatch):
    monkeypatch.setattr(trace, "_clock", _raise)
    monkeypatch.setattr(trace.time, "time_ns", _raise)
    lock = trace.TracedLock(threading.RLock())
    assert trace.span("x") is trace.NOOP and trace.begin("x") is trace.NOOP
    _off_calls(lock)                      # warm: the lock's thread-local slot
    tracemalloc.start()
    try:
        before = tracemalloc.take_snapshot()
        for _ in range(200):
            _off_calls(lock)
        after = tracemalloc.take_snapshot()
    finally:
        tracemalloc.stop()
    grown = [d for d in after.compare_to(before, "filename")
             if d.traceback[0].filename == trace.__file__ and d.size_diff > 0]
    assert grown == [], grown
    assert trace.stop() is None


def test_off_system_frames_read_no_recorder_clock(monkeypatch):
    """Two frames of a System (its initialization and a tracked frame) with
    the recorder's clock made to raise: no call site reads it while off."""
    monkeypatch.setattr(trace, "_clock", _raise)
    world = SyntheticStereoWorld(CFG, seed=3)
    sys_ = System(CFG, enable_loop_closing=False, device="cpu")
    for i, (R, t) in enumerate(forward_trajectory(2, step=0.12)):
        sys_.track_stereo(*world.render(R, t), timestamp=0.1 * i)
    sys_.shutdown()
    assert [r["state"] for r in sys_.metrics] == ["OK", "OK"]
    assert not hasattr(sys_, "lock_waits")


def test_spans_nest_with_parents_keys_and_counters():
    trace.start()
    with trace.span("outer", key=7) as outer:
        with trace.span("inner"):
            trace.count("n", 3)
        with trace.span("other", key=9):
            with trace.span("leaf"):
                pass
    trace.record("queued", 10, 20, key=4)
    b = trace.begin("stamped", 100)
    b.end(250)
    b.end(300)                            # a second end does nothing
    rec = trace.stop()
    by = {s.name: s for s in rec.spans}
    assert len(rec.spans) == 6
    assert by["outer"].parent == -1 and by["outer"].key == 7 and by["outer"].id == outer.id
    assert by["inner"].parent == outer.id and by["inner"].key == 7
    assert by["other"].parent == outer.id and by["other"].key == 9
    assert by["leaf"].parent == by["other"].id and by["leaf"].key == 9
    assert (by["queued"].t0, by["queued"].t1, by["queued"].key, by["queued"].parent) == (10, 20, 4, -1)
    assert (by["stamped"].t0, by["stamped"].t1) == (100, 250)
    assert by["outer"].t0 <= by["inner"].t0 <= by["inner"].t1 <= by["other"].t0 <= by["outer"].t1
    (c,) = rec.counters
    assert (c.name, c.value, c.key, c.span) == ("n", 3, 7, by["inner"].id)
    assert rec.t_start <= by["outer"].t0 and by["outer"].t1 <= rec.t_stop
    assert rec.seconds_by_key("inner") == {7: pytest.approx((by["inner"].t1 - by["inner"].t0) * 1e-9)}
    with trace.span("after"):             # off again: nothing more is kept
        pass
    assert len(rec.spans) == 6


def test_offset_to_the_system_clock():
    trace.start()
    time.sleep(0.01)
    rec = trace.stop()
    now = time.perf_counter_ns()
    assert abs(rec.to_profiler_ns(now) - time.time_ns()) < 5_000_000
    assert 0 < rec.offset_err_ns < 1_000_000


def test_records_are_per_thread():
    """Spans of concurrent threads carry their own ids and parents; the
    low-32 id is the pthread id's, signed, as a profiler's runtime events
    carry it."""
    go = threading.Barrier(3, timeout=WAIT_S)
    ids = {}

    def work(name):
        ids[name] = (threading.get_native_id(), _pthread_low32())
        go.wait()
        with trace.span(name, key=len(name)):
            go.wait()
            with trace.span(name + ".child"):
                time.sleep(0.01)
            go.wait()

    trace.start()
    threads = [threading.Thread(target=work, args=(n,)) for n in ("lane", "mapping")]
    for th in threads:
        th.start()
    work("main")
    for th in threads:
        th.join(WAIT_S)
        assert not th.is_alive()
    rec = trace.stop()
    by = {s.name: s for s in rec.spans}
    for name in ("lane", "mapping", "main"):
        top, child = by[name], by[name + ".child"]
        assert (top.tid, top.tid32) == ids[name] == (child.tid, child.tid32)
        assert top.parent == -1 and child.parent == top.id and child.key == len(name)
    assert len({by[n].tid for n in ("lane", "mapping", "main")}) == 3


def test_traced_lock_records_wait_and_hold_once_per_outer_acquisition():
    lock = trace.TracedLock(threading.RLock())
    held, release = threading.Event(), threading.Event()

    def holder():
        with lock:
            held.set()
            release.wait(WAIT_S)

    trace.start()
    th = threading.Thread(target=holder)
    th.start()
    assert held.wait(WAIT_S)
    threading.Timer(0.05, release.set).start()
    with trace.span("frame", key=1):
        with lock:
            with lock:                    # re-entry records nothing more
                with trace.span("inside"):
                    pass
    th.join(WAIT_S)
    rec = trace.stop()
    me = threading.get_native_id()
    waits, holds = rec.named("lock.wait", tid=me), rec.named("lock.hold", tid=me)
    frame = rec.named("frame")[0]
    assert len(waits) == len(holds) == 1
    assert waits[0].t1 - waits[0].t0 >= 30_000_000, "the wait for the other thread's hold"
    assert waits[0].parent == holds[0].parent == frame.id and holds[0].key == 1
    assert rec.named("inside")[0].parent == holds[0].id
    assert holds[0].t0 == waits[0].t1
    other = [s for s in rec.spans if s.tid != me]
    assert sorted(s.name for s in other) == ["lock.hold", "lock.wait"], "the holder's own acquisition"


@pytest.fixture(scope="module")
def drive():
    """A synchronous System (mapping on, loop closing off) over
    N_FRAMES frames with the recorder on and every CUDA synchronisation
    made to raise."""
    world = SyntheticStereoWorld(CFG, seed=3)
    frames = [world.render(R, t) for R, t in forward_trajectory(N_FRAMES, step=0.12)]
    with pytest.MonkeyPatch.context() as mp:
        for owner, attr in ((torch.cuda, "synchronize"), (torch.cuda.Stream, "synchronize"),
                            (torch.cuda.Event, "synchronize"), (torch.cuda, "current_stream")):
            mp.setattr(owner, attr, _raise)
        sys_ = System(CFG, enable_loop_closing=False, device="cpu")
        trace.stop()
        trace.start()
        try:
            for i, (left, right) in enumerate(frames):
                sys_.track_stereo(left, right, timestamp=0.1 * i)
            sys_.shutdown()
        finally:
            rec = trace.stop()
    return sys_, rec


def _children(rec, span):
    return [s for s in rec.spans if s.parent == span.id]


def _descendants(rec, span):
    out, todo = [], [span]
    while todo:
        kids = _children(rec, todo.pop())
        out += kids
        todo += kids
    return out


def test_each_frame_has_one_frame_span_over_build_and_track(drive):
    sys_, rec = drive
    lane = threading.get_native_id()
    frames = rec.named("frame")
    assert sorted(s.key for s in frames) == list(range(N_FRAMES))
    assert all(s.tid == lane and s.parent == -1 for s in frames)
    for fr in frames:
        kids = {s.name for s in _children(rec, fr)}
        assert {"build", "lock.wait", "lock.hold"} <= kids, kids
        names = {s.name for s in _descendants(rec, fr)}
        for stage in ("build.upload", "build.pyramid", "build.fast", "build.select", "build.describe",
                      "build.stereo", "track"):
            assert stage in names, (fr.key, stage)
        assert any(n.startswith("track.") for n in names), fr.key
        # in synchronous mode a keyframe's mapping runs inline, keyed by it
        assert all(s.key == fr.key for s in _children(rec, fr) if not s.name.startswith("mapping."))
        (build,) = [s for s in _children(rec, fr) if s.name == "build"]
        assert all(s.t0 >= build.t0 and s.t1 <= build.t1 for s in _children(rec, build))
    fused = {s.key for s in rec.named("track.fused_step")}
    assert fused, "the fused step ran"
    for name in ("track.motion_search", "track.pose_opt", "track.local_search", "track.readback",
                 "track.bind", "track.select_local_kfs", "track.snapshot", "track.kf_decision"):
        assert rec.named(name), name
    pose_rounds = [s for s in rec.named("track.pose_opt")
                   if any(p.id == s.parent for p in rec.named("track.fused_step"))]
    assert len(pose_rounds) == 3 * CFG.optim.pose_rounds * len(fused), "an LM round a span"


def test_metrics_take_their_times_from_the_spans(drive):
    sys_, rec = drive
    builds = {s.key: s for s in rec.named("build")}
    assert len(sys_.metrics) == N_FRAMES
    for r in sys_.metrics:
        b = builds[r["frame_id"]]
        assert r["ms_extract"] == pytest.approx((b.t1 - b.t0) * 1e-6, abs=1e-9)
        assert r["ms_total"] >= r["ms_extract"] + r["ms_track"] - 1e-9


def test_keyframe_creation_and_its_mapping_share_its_id(drive):
    sys_, rec = drive
    created = [s.key for s in rec.named("track.kf_create")]
    mapped = [s.key for s in rec.named("mapping.kf")]
    assert created == list(range(sys_.map.next_kf)) and len(created) >= 3
    assert mapped == created
    assert sorted(s.key for s in rec.named("mapping.queued")) == created
    frames = {s.id: s for s in rec.named("frame")}
    for s in rec.named("mapping.kf"):   # synchronous: inline after the frame's tracking
        assert s.parent in frames
    for name in ("mapping.cull_points", "mapping.device_pass", "mapping.cull_kfs", "local_ba",
                 "local_ba.window", "local_ba.upload", "local_ba.phase", "local_ba.readback",
                 "local_ba.writeback"):
        assert rec.named(name), name
    iters = [c.value for c in rec.counters if c.name == "local_ba.iters"]
    assert sum(iters) == sum(n for _, n in sys_.local_mapper.ba_solve_times) > 0


def test_no_recorder_code_synchronises_a_device():
    """The recorder imports no device library and calls no synchronise (the
    drive above ran with every CUDA synchronisation made to raise)."""
    tree = ast.parse(inspect.getsource(trace))
    imported = ({a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
                | {n.module.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)})
    assert imported <= {"__future__", "itertools", "threading", "time", "dataclasses", "typing"}, imported
    called = {n.func.attr for n in ast.walk(tree) if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)}
    assert not {c for c in called if "synchron" in c}


def test_aborted_second_phase_records_the_iterations_run(drive, monkeypatch):
    """Local BA whose second LM phase a newly inserted keyframe aborted:
    ba_solve_times and the `local_ba.iters` counter hold the first phase's
    5 iterations, not 15."""
    sys_, _ = drive
    lm = sys_.local_mapper
    k = int(np.nonzero(sys_.map.kf_valid)[0][-1])
    real, phases = local_mapping.lm_chunk_pq, []

    def first_phase_then_abort(*args):
        phases.append(args[-1])
        out = real(*args)
        lm.abort_ba = True                # as insert_keyframe sets it
        return out

    monkeypatch.setattr(local_mapping, "lm_chunk_pq", first_phase_then_abort)
    n_solves = len(lm.ba_solve_times)
    lm.abort_ba = False
    trace.start()
    try:
        lm._local_ba(k)
    finally:
        rec = trace.stop()
        lm.abort_ba = False
    assert phases == [CFG.optim.local_ba_iters1] == [5]
    assert len(lm.ba_solve_times) == n_solves + 1
    assert lm.ba_solve_times[-1][1] == 5
    assert [c.value for c in rec.counters if c.name == "local_ba.iters"] == [5]
    assert len(rec.named("local_ba.phase")) == 1
