"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix, limit and per-layer metric is found by name, and the file
keeps to the benchmark's format.

    python -m pytest -q slam_bench/tests
"""

import json
import os
import re

import pytest

from slam_bench import harness
from slam_bench.reference.settings import settings_from_yaml

ROOT = harness.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert BENCH["command"] == ["python3", "slam_bench/run.py"]
    assert BENCH["paths"] == ["slam_bench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_units_and_entries():
    names = [c["name"] for c in BENCH["configs"]] + CELLS
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for n in names + [m["name"] for m in metrics] + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.match(n), n
    assert len(set(c["name"] for c in BENCH["configs"])) == len(BENCH["configs"])
    assert len(set(CELLS)) == len(CELLS)
    assert len(set(m["name"] for m in metrics)) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher"), m
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert {"frames_per_s", "frame_ms_p50", "frame_ms_p90", "setup_s"} == e2e
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= set(CELLS)
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = harness.resolve_cell(cell, ROOT)
    assert c.sensor in harness.SENSORS and c.camera_hz > 0
    assert os.path.exists(c.yaml_path)
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    traffic = json.load(open(os.path.join(ROOT, "slam_bench/traffic", w["traffic"] + ".json")))
    assert c.gen is harness.generator(traffic["generator"])
    assert c.traffic.warmup_frames > 0 and c.traffic.check_frames > 0
    for fn in ("params", "generate", "map_error_percent"):
        assert callable(getattr(c.gen, fn))
    assert set(c.limits) == {"feat_diff", "ate_pct", "map_err_pct"}
    s = settings_from_yaml(c.yaml_path)
    assert s.width > 0 and s.orb.n_features > 0
    for m in c.per_layer:
        assert callable(harness.metric_reader(m["name"]))


@pytest.mark.parametrize("cfg", [c["name"] for c in BENCH["configs"]])
def test_configuration_files(cfg):
    entry = next(c for c in BENCH["configs"] if c["name"] == cfg)
    assert entry["file"].startswith("slam_bench/configs/")
    meta = json.load(open(os.path.join(ROOT, entry["file"])))
    assert isinstance(meta["async_mode"], bool) and "source" in meta and "assumed" in meta
    assert meta["sensor"] in harness.SENSORS
    assert set(entry["reduced"]) <= set(meta) and len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert NAME.match(key) and {"deployment", "as_run", "why"} <= set(meta[key]), key
    assert any(w["config"] == cfg for w in BENCH["workloads"])
    for w in BENCH["workloads"]:
        if w["config"] == cfg:
            assert harness.resolve_cell(w["name"], ROOT).async_mode == meta["async_mode"]


class _FakeSystem:
    def __getattr__(self, name):
        return lambda *a: (name, a)


def test_each_sensor_reaches_its_system_entry():
    """The sensor table hands each sensor's frame to its own entry."""
    import numpy as np

    imgs = np.arange(2 * 2 * 3 * 4).reshape(2, 2, 3, 4)
    depth = np.arange(2 * 3 * 4).reshape(2, 3, 4)
    s = _FakeSystem()
    name, a = harness.SENSORS["stereo"].track(s, imgs, None, 1, 0.5)
    assert name == "track_stereo" and (a[0] == imgs[1, 0]).all() and (a[1] == imgs[1, 1]).all() and a[2] == 0.5
    name, a = harness.SENSORS["rgbd"].track(s, imgs[:, 0], depth, 1, 0.5)
    assert name == "track_rgbd" and (a[0] == imgs[1, 0]).all() and (a[1] == depth[1]).all()
    name, a = harness.SENSORS["mono"].track(s, imgs[:, 0], None, 1, 0.5)
    assert name == "track_monocular" and (a[0] == imgs[1, 0]).all() and a[1] == 0.5
    assert [k for k, v in harness.SENSORS.items() if not v.metric_scale] == ["mono"]


def test_generator_found_by_name():
    from slam_bench.gen import world

    assert harness.generator("world") is world
    with pytest.raises(SystemExit):
        harness.generator("../world")


def test_upstream_settings_values():
    k = settings_from_yaml(os.path.join(ROOT, "slam_bench/configs/kitti00_stereo.yaml"))
    assert (k.fx, k.fy, k.cx, k.cy, k.bf, k.fps) == (718.856, 718.856, 607.1928, 185.2157, 386.1448, 10.0)
    assert (k.width, k.height, k.orb.n_features, k.orb.ini_fast_th, k.orb.min_fast_th) == (1241, 376, 2000, 20, 7)
    t = settings_from_yaml(os.path.join(ROOT, "slam_bench/configs/tum_fr1_rgbd.yaml"))
    assert t.dist_coef == (0.262383, -0.953104, -0.005358, 0.002628, 1.163314)
    assert (t.width, t.height, t.fps, t.bf, t.depth_map_factor, t.orb.n_features) == (640, 480, 30.0, 40.0, 5000.0, 1000)


def test_program_reads_the_same_settings():
    from orb_slam2_2021_tpu_torch.config import config_from_yaml

    for cell in CELLS:
        c = harness.resolve_cell(cell, ROOT)
        cfg = config_from_yaml(c.yaml_path, **c.overrides)
        s = settings_from_yaml(c.yaml_path)
        assert (cfg.fx, cfg.bf, cfg.width, cfg.height, cfg.dist_coef) == (s.fx, s.bf, s.width, s.height, s.dist_coef)
        assert (cfg.orb.n_features, cfg.orb.ini_fast_th, cfg.orb.n_levels) == (
            s.orb.n_features, s.orb.ini_fast_th, s.orb.n_levels)
        assert (cfg.max_keyframes, cfg.max_map_points) == (2048, 131072)
