"""The port's dataset readers and its dataset driver on the CPU.

KITTI-odometry and TUM-RGB-D-layout sequences written to a temporary
directory (PNG through PIL, and PGM through the readers' fallback when PIL
is missing) read identically by the JAX package's readers and the port's:
the same frames in the same order, timestamps, values and dtypes. Then
`python -m orb_slam2_2021_tpu_torch.run_slam` runs a short synthetic
sequence in async mode on the CPU and writes its trajectories, metrics and
map file.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from orb_slam2_2021_tpu.io import datasets as jds
from orb_slam2_2021_tpu_torch.io import datasets as tds

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, W, N = 24, 32, 5


def _write(path, img):
    """8-bit or 16-bit grey image, PNG or binary PGM by the file's suffix."""
    if path.endswith(".pgm"):
        with open(path, "wb") as f:
            maxv = 255 if img.dtype == np.uint8 else 65535
            f.write(b"P5\n# written by the test\n%d %d\n%d\n" % (img.shape[1], img.shape[0], maxv))
            f.write(img.astype(">u2").tobytes() if maxv > 255 else img.tobytes())
    else:
        from PIL import Image

        Image.fromarray(img).save(path)


def _kitti(root, ext, rng):
    os.makedirs(os.path.join(root, "image_0"))
    os.makedirs(os.path.join(root, "image_1"))
    with open(os.path.join(root, "times.txt"), "w") as f:
        f.write("\n".join(f"{0.1037 * i:.6e}" for i in range(N)) + "\n")
    for i in range(N):
        for cam in ("image_0", "image_1"):
            _write(os.path.join(root, cam, f"{i:06d}.{ext}"), rng.integers(0, 256, (H, W), np.uint8))


def _tum(root, ext, rng):
    os.makedirs(os.path.join(root, "rgb"))
    os.makedirs(os.path.join(root, "depth"))
    rgb = ["# color images", "# timestamp filename"]
    depth = ["# depth maps"]
    for i in range(N):
        ts = 1305031102.175304 + 0.0333 * i
        rgb.append(f"{ts:.6f} rgb/{i}.{ext}")
        _write(os.path.join(root, "rgb", f"{i}.{ext}"), rng.integers(0, 256, (H, W), np.uint8))
        if i != 2:  # frame 2 has no depth map within 20 ms: the association drops it
            depth.append(f"{ts + 0.004 * (i % 2):.6f} depth/{i}.{ext}")
            raw = rng.integers(0, 30000, (H, W)).astype(np.uint16 if ext == "pgm" else np.uint8)
            _write(os.path.join(root, "depth", f"{i}.{ext}"), raw)
    with open(os.path.join(root, "rgb.txt"), "w") as f:
        f.write("\n".join(rgb) + "\n")
    with open(os.path.join(root, "depth.txt"), "w") as f:
        f.write("\n".join(depth) + "\n")


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert isinstance(x, np.ndarray) == isinstance(y, np.ndarray)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y)
        else:
            assert type(x) is type(y) and x == y


@pytest.mark.parametrize("layout", ["kitti", "tum"])
@pytest.mark.parametrize("ext", ["png", "pgm"])
def test_readers_match_the_reference(tmp_path, monkeypatch, layout, ext):
    if ext == "pgm":
        monkeypatch.setitem(sys.modules, "PIL", None)  # the readers' no-PIL fallback
    rng = np.random.default_rng(0)
    root = str(tmp_path / layout)
    if layout == "kitti":
        _kitti(root, ext, rng)
        ref, port = jds.KittiStereoSequence(root), tds.KittiStereoSequence(root)
        assert port.times == ref.times and port.names == ref.names
        assert len(tds.KittiStereoSequence(root, max_frames=3)) == 3
    else:
        _tum(root, ext, rng)
        ref, port = jds.TumRgbdSequence(root), tds.TumRgbdSequence(root)
        assert port.pairs == ref.pairs and len(port) == N - 1
    rows_ref, rows_port = list(ref), list(port)
    assert len(rows_port) == len(ref) == len(port)
    for a, b in zip(rows_ref, rows_port):
        _same(a, b)
    assert rows_port[0][1].dtype == np.float32


def test_run_slam_writes_its_files(tmp_path):
    """12 synthetic frames in async mode on the CPU: every frame line, the
    ATE, the timing lines, and the trajectory, metrics and map files."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="2")
    cmd = [sys.executable, "-m", "orb_slam2_2021_tpu_torch.run_slam", "synthetic", "12",
           "--device", "cpu", "--async", "--metrics", "metrics.ndjson", "--save-map", "map.npz"]
    res = subprocess.run(cmd, capture_output=True, text=True, cwd=tmp_path, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    out = res.stdout.splitlines()
    assert sum(line.startswith("frame ") for line in out) == 12
    ate = float(next(line for line in out if line.startswith("ATE RMSE:")).split()[-1])
    assert np.isfinite(ate) and ate < 0.3
    assert any(line.startswith("median tracking time:") for line in out)
    assert "wrote 12 metrics records to metrics.ndjson" in out
    assert np.loadtxt(tmp_path / "trajectory_kitti.txt").shape == (12, 12)
    assert np.loadtxt(tmp_path / "trajectory_tum.txt").shape == (12, 8)
    recs = [json.loads(line) for line in open(tmp_path / "metrics.ndjson")]
    assert [r["frame_id"] for r in recs] == list(range(12))
    assert os.path.getsize(tmp_path / "map.npz") > 0


@pytest.mark.parametrize("flag", ["--viz"])  # --publish runs: tests/test_torch_io.py
def test_run_slam_refuses_unported_outputs(monkeypatch, tmp_path, flag):
    """No output flag is refused any more: --viz, the last one ported, writes
    the viewer's PNGs (tests/test_torch_viz.py holds the images)."""
    from orb_slam2_2021_tpu_torch import run_slam

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(sys, "argv", ["run_slam", "synthetic", "2", flag, "out", "--device", "cpu"])
    run_slam.main()
    assert sorted(os.listdir(tmp_path / "out")) == ["frame_000000.png", "map_000000.png"]
