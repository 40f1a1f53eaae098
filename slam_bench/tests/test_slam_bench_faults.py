"""The rest of a run, with the timed path broken underneath: each planted
fault makes `correct` come out false, and the sound run of the same size
passes. It skips the look for a card and runs the port on the CPU, at half
the KITTI resolution (the same field of view and baseline), for a short
window; the cell's own limits decide.

    python -m pytest -q slam_bench/tests/test_slam_bench_faults.py   (about 4 min)
"""

import dataclasses
import os
import time

import pytest

from slam_bench import faults, harness
from slam_bench.faults import half_size_yaml

CELL = "kitti00_stereo.drive"
SECONDS = 10.0
SEED = 2 ** 31 + 77


@pytest.fixture(scope="module")
def small_cell(tmp_path_factory):
    cell = harness.resolve_cell(CELL)
    path = str(tmp_path_factory.mktemp("cfg") / "half.yaml")
    half_size_yaml(cell.yaml_path, path)
    return dataclasses.replace(cell, yaml_path=path)


def _run(cell, fault=None):
    import torch

    torch.set_num_threads(min(4, os.cpu_count() or 1))
    return harness.run_cell(cell, SEED, SECONDS, False, "cpu", time.time(), fault=fault)


def test_sound_run_is_correct(small_cell):
    res = _run(small_cell)
    assert res["correct"], res["check"]
    assert res["check"]["feat_diff"]["value"] == 0.0


@pytest.mark.parametrize("name,number", [("unchanged", "ate_pct"), ("half", "feat_diff"),
                                         ("altered", "feat_diff"), ("depth_scaled", "map_err_pct")])
def test_fault_makes_the_run_incorrect(small_cell, name, number):
    res = _run(small_cell, faults.FAULTS[name])
    assert not res["correct"]
    c = res["check"][number]
    assert c["value"] > c["limit"], (name, res["check"])
