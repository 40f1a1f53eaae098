"""The metric arithmetic on made-up samples and a made-up trace, the
per-layer readers on a made-up context, the K1 counts against the bounds
the port's kernel table gives, and the comparison's numbers."""

import math
from types import SimpleNamespace

import numpy as np
import pytest

from slam_bench import harness, peaks, stats, tracing
from slam_bench.reference import checks


def test_percentile_and_rate():
    lat = [100.0, 200.0, 300.0, 400.0, 1000.0]
    assert stats.percentile(lat, 50) == 300.0
    assert stats.percentile(lat, 90) == pytest.approx(760.0)
    assert stats.rate(75, 50.0) == 1.5
    with pytest.raises(ValueError):
        stats.rate(3, 0.0)


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (8, 12), (-4, -1)]
    assert stats.union_length(iv, 0, 10) == 3 + 1 + 2
    assert stats.idle_gaps(iv, 0, 10) == [(3, 5), (6, 8)]
    assert stats.idle_gaps([], 0, 4) == [(0, 4)]


def test_reduce_events_on_a_made_up_trace():
    ms = 1_000_000
    rows = [
        ("_Z20hamming_best2_kernelPKjS0_PKhP5uint2iiii", True, 10 * ms, 2 * ms, 0),
        ("hamming_best2_merge(uint2 const*)", True, 12 * ms, 1 * ms, 0),
        ("void at::elementwise_kernel", True, 11 * ms, 4 * ms, 0),
        ("void at::elementwise_kernel", True, 40 * ms, 10 * ms, 0),
        ("cudaLaunchKernel", False, 9 * ms, ms // 100, 7),
        ("cudaLaunchKernel", False, 9 * ms, ms // 100, 7),
        ("cuLaunchKernel", False, 9 * ms, ms // 100, 8),
        ("aten::add", False, 9 * ms, ms, 7),
    ]
    r = tracing.reduce_events(rows, 0, 100 * ms, (7, -3), lambda t: "lane.track")
    assert r["window_s"] == pytest.approx(0.1)
    assert r["busy_s"] == pytest.approx(0.015)
    assert r["lane_launches"] == 2 and r["launches_by_thread"] == {7: 2, 8: 1}
    assert r["k1_device_s"] == pytest.approx(0.003) and r["k1_kernels"] == 1
    assert r["device_ops"][0] == ["void at::elementwise_kernel", pytest.approx(0.014)]
    assert [g[1] for g in r["idle_gaps"]] == pytest.approx([0.05, 0.025, 0.01])
    assert all(g[0] == "lane.track" for g in r["idle_gaps"])


def test_lane_thread_ids():
    import threading

    ids = tracing.lane_thread_ids()
    assert ids[0] == threading.get_native_id() and -2 ** 31 <= ids[1] < 2 ** 31


def test_host_state_names_the_lane_span():
    p = SimpleNamespace(spans={"lane.frame": [(0, 100)], "lane.track": [(20, 60)], "mapping.kf": [(50, 70)]})
    assert tracing.host_state(p, 30) == "lane.track"
    assert tracing.host_state(p, 55) == "lane.track+mapping.kf"
    assert tracing.host_state(p, 80) == "lane.frame"
    assert tracing.host_state(p, 150) == "harness"


def test_readers_on_a_made_up_context():
    trace = {"lane_launches": 3000, "window_s": 10.0, "busy_s": 1.5, "k1_device_s": 1e-4, "k1_kernels": 10}
    ctx = SimpleNamespace(frames=3, span_s={"lane.build": [0.1, 0.2], "lane.track": [0.3],
                                            "mapping.kf": [0.5, 0.7]},
                          kf_inserted=1, ba_solve_s=[0.2, 0.4], k1_calls=[(2000, 2000, 1)] * 10, trace=trace)
    want = {"lane.launch_calls_per_frame": 1000.0, "frontend.build_ms": 150.0, "tracking.track_ms": 300.0,
            "mapping.kf_ms": 600.0, "mapping.kf_per_frame": 1 / 3, "local_ba.ms_per_solve": 300.0,
            "device.idle_share": 85.0,
            "hamming_best2_roofline": 100.0 * peaks.hamming_best2_bound_s(2000, 2000, 1) / 1e-5}
    for name, v in want.items():
        assert harness.metric_reader(name)(ctx) == pytest.approx(v), name
    empty = SimpleNamespace(frames=0, span_s={}, kf_inserted=0, ba_solve_s=[], k1_calls=[], trace=None)
    for name in want:
        assert harness.metric_reader(name)(empty) is None, name


@pytest.mark.parametrize("n,m,t,bound_us", [
    (4096, 2000, 1, 2.53), (2000, 2000, 10, 12.27), (1397, 2000, 1, 0.87), (1483, 455, 1, 0.23),
    (2000, 2000, 9, 11.00), (2000, 2000, 1, 1.24)])
def test_k1_counts_match_the_kernel_table(n, m, t, bound_us):
    """The bounds PERF.md's kernel table gives for hamming_best2 (bytes
    bound at each of these shapes)."""
    b, ops = peaks.hamming_best2_counts(n, m, t)
    assert b / peaks.H100_BYTES_PER_S > ops / peaks.H100_INT8_OPS_PER_S
    assert 1e6 * peaks.hamming_best2_bound_s(n, m, t) == pytest.approx(bound_us, abs=0.05)


def _frame(n=6, seed=0):
    rng = np.random.default_rng(seed)
    return {"xy": rng.uniform(0, 500, (n, 2)).astype(np.float32), "octave": rng.integers(0, 8, n),
            "desc": rng.integers(-2 ** 31, 2 ** 31, (n, 8)).astype(np.int32), "valid": np.ones(n, bool),
            "u_right": rng.uniform(0, 400, n).astype(np.float32), "depth": rng.uniform(4, 28, n).astype(np.float32)}


def test_feature_diff():
    f = _frame()
    assert checks.feature_diff(f, {k: v.copy() for k, v in f.items()}) == 0.0
    half = {k: v.copy() for k, v in f.items()}
    half["valid"][3:] = False
    assert checks.feature_diff(half, f) == pytest.approx(0.5)
    moved = {k: v.copy() for k, v in f.items()}
    moved["u_right"][0] += 0.01
    assert checks.feature_diff(moved, f) == pytest.approx(1 - 5 / 7)
    flipped = {k: v.copy() for k, v in f.items()}
    flipped["desc"][:, 0] ^= 1
    assert checks.feature_diff(flipped, f) == 1.0


def test_ate_and_map_error():
    rng = np.random.default_rng(1)
    gt = np.cumsum(rng.normal(0, 0.1, (50, 3)), axis=0)
    a = 0.3
    R = np.array([[math.cos(a), -math.sin(a), 0], [math.sin(a), math.cos(a), 0], [0, 0, 1]])
    assert checks.ate_percent(gt @ R.T + [1, 2, 3], gt) == pytest.approx(0.0, abs=1e-9)
    noisy = gt + rng.normal(0, 0.01, gt.shape)
    length = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    assert 0 < checks.ate_percent(noisy, gt) < 100 * 0.02 / length
    world = {"depth_grid": np.array([[4.0, 8.0], [4.0, 8.0]]), "x0": 0.0, "y0": 0.0, "cell": 1.0}
    assert checks.surface_depth(world["depth_grid"], 0, 0, 1, 0.5, 0.25) == pytest.approx(6.0)
    pts = np.array([[0.5, 0.5, 6.0], [0.25, 0.0, 5.0 * 1.1], [0.75, 0.5, 7.0 * 0.9]])
    assert checks.map_error_percent(pts, world) == pytest.approx(10.0)


def test_ate_with_scale_for_a_monocular_trajectory():
    """A trajectory known up to a scale aligns with one; without the scale
    its error stays."""
    rng = np.random.default_rng(2)
    gt = np.cumsum(rng.normal(0, 0.1, (40, 3)), axis=0)
    a = 0.7
    R = np.array([[1, 0, 0], [0, math.cos(a), -math.sin(a)], [0, math.sin(a), math.cos(a)]])
    est = 0.37 * gt @ R.T + [3, -1, 2]
    assert checks.ate_percent(est, gt, scale=True) == pytest.approx(0.0, abs=1e-9)
    assert checks.ate_percent(est, gt) > 1.0
    M, t = checks.rigid_align(est, gt, scale=True)
    assert np.allclose(est @ M.T + t, gt)
