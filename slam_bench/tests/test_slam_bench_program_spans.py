"""The join of the port's own spans with the device trace
(slam_bench/program_spans.py) on a made-up window: launches, host time and
idle time by the innermost span, the six readings the spans feed, and the
idle gaps' labels refined by the spans open on the lane and the worker."""

from collections import namedtuple

import pytest

from slam_bench import program_spans as ps
from slam_bench import tracing

Span = namedtuple("Span", "id parent name key tid tid32 t0 t1")
LANE, WORKER = (11, -11), (22, -22)


def _spans():
    """Two 100-ns frames on the lane (build then track, a readback and a
    lock wait in each) and one keyframe on the worker over the second."""
    out, n = [], 0

    def add(name, t0, t1, th, key, parent=-1):
        nonlocal n
        n += 1
        out.append(Span(n, parent, name, key, th[0], th[1], t0, t1))
        return n

    for f, base in enumerate((1000, 1200)):
        fr = add("frame", base, base + 100, LANE, f)
        b = add("build", base, base + 30, LANE, f, fr)
        add("build.fast", base + 5, base + 15, LANE, f, b)
        add("lock.wait", base + 30, base + 40, LANE, f, fr)
        h = add("lock.hold", base + 40, base + 100, LANE, f, fr)
        t = add("track", base + 40, base + 100, LANE, f, h)
        add("track.pose_opt", base + 45, base + 60, LANE, f, t)
        add("track.readback", base + 80, base + 90, LANE, f, t)
    kf = add("mapping.kf", 1190, 1290, WORKER, 1)
    add("lock.hold", 1200, 1210, WORKER, 1, kf)
    add("mapping.queued", 1100, 1190, WORKER, 1)
    return out


def _rows():
    launch = lambda t, th: ("cudaLaunchKernel", False, t, 1, th)   # noqa: E731
    rows = [launch(t, LANE[1]) for t in (1006, 1010, 1020, 1050, 1070)]      # frame 0
    rows += [launch(t, LANE[0]) for t in (1208, 1250, 1251, 1270, 1299)]     # frame 1
    rows += [launch(1150, LANE[1])]                                          # between frames
    rows += [launch(t, WORKER[1]) for t in (1195, 1205, 1280)]
    rows += [("k", True, 1000, 100, 0), ("k", True, 1130, 100, 0)]           # device busy
    return rows


@pytest.fixture(scope="module")
def out():
    return ps.analyse(_spans(), _rows(), 1000, 1400)


def test_launches_by_innermost_span_and_group(out):
    lane = out["lane"]
    assert lane["n_launches"] == 11
    assert lane["launches"] == {"build.fast": 3, "build": 1, "track.pose_opt": 3, "track": 3, "-": 1}
    assert lane["launch_groups"] == {"build": 4, "track": 6, "-": 1}
    assert out["lane_launch_share_in_spans"] == pytest.approx(10 / 11)
    assert out["worker"]["n_launches"] == 3
    assert out["worker"]["launches"] == {"mapping.kf": 2, "lock.hold": 1}
    assert out["frames"] == 2 and out["keyframes"] == 1


def test_host_and_idle_time_by_innermost_span(out):
    lane = out["lane"]
    assert "frame" not in lane["host_ns"], "its children cover each frame"
    assert lane["host_ns"]["build.fast"] == 20 and lane["host_ns"]["build"] == 40
    assert lane["host_ns"]["lock.wait"] == 20 and lane["host_ns"]["track.readback"] == 20
    assert sum(lane["host_ns"].values()) == 200
    # device busy [1000, 1100) and [1130, 1230): idle [1100, 1130) and [1230, 1400)
    assert out["idle_ns_total"] == 200
    assert lane["idle_ns"]["-"] == 30 + 100          # between frames, after the last
    assert lane["idle_ns"]["lock.wait"] == 10 and lane["idle_ns"]["track"] == 35
    assert lane["idle_ns"]["track.pose_opt"] == 15 and lane["idle_ns"]["track.readback"] == 10
    assert out["worker"]["idle_ns"]["mapping.kf"] == 60 and out["worker"]["idle_ns"]["-"] == 140
    table = ps.stage_table(out)
    assert table[0] == ("-", 0.5, 0.0, pytest.approx(0.65))


def test_readings(out):
    r = out["readings"]
    assert r["frontend.launch_calls_per_frame"] == 2.0
    assert r["tracking.launch_calls_per_frame"] == 3.0
    assert r["tracking.readback_wait_ms"] == pytest.approx(1e-6 * 10)
    assert r["lane.map_lock_wait_ms"] == pytest.approx(1e-6 * 10)
    # frame 1's track overlaps the keyframe: (60 - 10) ns / 4 launches over
    # frame 0's (60 - 10) ns / 2 launches
    assert r["lane.us_per_launch_mapping_ratio"] == pytest.approx((50 / 4) / (50 / 2))
    assert r["mapping.launch_calls_per_kf"] == 3.0


def test_readings_are_none_with_nothing_to_read():
    r = ps.analyse([], [("k", True, 0, 10, 0)], 0, 100)["readings"]
    assert set(r.values()) == {None}
    spans = [s for s in _spans() if s.tid == LANE[0]]
    r = ps.analyse(spans, [r_ for r_ in _rows() if r_[4] in LANE or r_[1]], 1000, 1400)["readings"]
    assert r["mapping.launch_calls_per_kf"] is None and r["lane.us_per_launch_mapping_ratio"] is None
    assert r["tracking.launch_calls_per_frame"] == 3.0


def test_refined_labels_keep_the_present_label_as_prefix(out):
    lane, worker = out["lane"]["timeline"], out["worker"]["timeline"]
    assert ps.refine_label("lane.track", lane.path_at(1270), worker.path_at(1270)) == "lane.track/track"
    assert ps.refine_label("lane.track", lane.path_at(1250), ()) == "lane.track/track.pose_opt"
    assert (ps.refine_label("lane.track+mapping.kf", lane.path_at(1242), worker.path_at(1205))
            == "lane.track/track+mapping.kf/lock.hold")
    assert ps.refine_label("harness", (), ()) == "harness"
    assert ps.refine_label("lane.build+mapping.kf", ("frame", "build"), ()) == "lane.build/build+mapping.kf"


def test_host_state_labels_unchanged_without_program_spans():
    """The harness's labels stand as they were where no program span is
    given: refining with empty paths returns them whole."""
    from types import SimpleNamespace

    p = SimpleNamespace(spans={"lane.frame": [(0, 100)], "lane.track": [(20, 60)], "mapping.kf": [(50, 70)]})
    for t in (30, 55, 80, 150):
        label = tracing.host_state(p, t)
        assert ps.refine_label(label, (), ()) == label


def test_on_profiler_clock():
    rec = namedtuple("R", "spans offset_ns")([Span(1, -1, "frame", 0, 1, 1, 10, 20)], 1000)
    (s,) = ps.on_profiler_clock(rec)
    assert (s.t0, s.t1) == (1010, 1020)
