"""The port's I/O outputs held against the JAX package on the CPU:
rectification maps and the bilinear remap (`io/rectify.py`), the message
bus, the TCP fan-out, the laser-scan relay and the System publisher
(`io/pubsub.py`), and `run_slam.py --publish`.

Inputs are made from numpy seeds and fed to both sides. Maps and the relay
are numpy on both sides and must be identical; the remap agrees within
1e-4 on 0-255 values.
"""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from orb_slam2_2021_tpu.io import pubsub as jpubsub
from orb_slam2_2021_tpu.io import rectify as jrect
from chip_smoke import kitti_lens  # the KITTI-width lens of chip_smoke.py phase 23
from orb_slam2_2021_tpu_torch.config import synthetic_config
from orb_slam2_2021_tpu_torch.io import pubsub as tpubsub
from orb_slam2_2021_tpu_torch.io import rectify as trect
from orb_slam2_2021_tpu_torch.io.synthetic import SyntheticStereoWorld, forward_trajectory
from orb_slam2_2021_tpu_torch.place.bundle import PACKAGED_VOCAB_SMALL, PlaceRecognition
from test_config_io import YAML  # the arducam-style LEFT/RIGHT settings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REMAP_TOL = 1e-4  # 0-255 values


@pytest.fixture
def yaml_path(tmp_path):
    p = tmp_path / "settings.yaml"
    p.write_text(YAML)
    return str(p)


def test_yaml_rectification_maps_equal_reference(yaml_path):
    for ref, port in zip(jrect.rectification_from_yaml(yaml_path),
                         trect.rectification_from_yaml(yaml_path)):
        assert port.map_x.dtype == np.float32 and port.map_x.shape == (480, 640)
        assert np.array_equal(port.map_x, ref.map_x) and np.array_equal(port.map_y, ref.map_y)


def test_kitti_width_rectify_map_equals_reference():
    lens = kitti_lens(1.0)
    ref, port = jrect.build_rectify_map(*lens), trect.build_rectify_map(*lens)
    assert port.map_x.shape == (376, 1241)
    assert np.array_equal(port.map_x, ref.map_x) and np.array_equal(port.map_y, ref.map_y)


def _edge_maps(h, w, rng):
    """Random in-image coordinates, with rows and columns set to the edge
    cases: -1.0 (no corner inside), -0.5 (half the first pixel), W-1+0.2,
    W-0.5, exact integers and far outside."""
    map_x = rng.uniform(-2.0, w + 1.0, (h, w)).astype(np.float32)
    map_y = rng.uniform(-2.0, h + 1.0, (h, w)).astype(np.float32)
    for j, v in enumerate([-1.0, -0.5, w - 1 + 0.2, w - 0.5, -50.0, w + 50.0, 0.0, w - 1.0]):
        map_x[:, j] = v
    for i, v in enumerate([-1.0, -0.5, h - 1 + 0.2, h - 0.5, -50.0, h + 50.0, 0.0, h - 1.0]):
        map_y[i, :] = v
    return trect.RectifyMaps(map_y=map_y, map_x=map_x)


@pytest.mark.parametrize("dtype", [np.uint8, np.float32])
def test_remap_matches_reference_at_the_edges(dtype):
    rng = np.random.default_rng(11)
    h, w = 24, 32
    maps = _edge_maps(h, w, rng)
    img = rng.uniform(1, 255, (h, w)).astype(dtype)
    ref = np.asarray(jrect.remap(img, jrect.RectifyMaps(map_y=maps.map_y, map_x=maps.map_x)))
    out = trect.remap(img, maps, device="cpu")
    assert out.dtype == torch.float32 and tuple(out.shape) == (h, w)
    out = out.numpy()
    assert np.abs(out - ref).max() <= REMAP_TOL
    x = maps.map_x[0]
    assert (out[:, x == -1.0] == 0).all() and (out[:, x == -50.0] == 0).all()
    # -0.5 reads half of pixel 0 (rows 6, 7 are the integer rows 0, h-1)
    i0 = 6
    np.testing.assert_allclose(out[i0, 1], 0.5 * float(img[0, 0]), atol=REMAP_TOL)
    np.testing.assert_allclose(out[i0, 2], 0.8 * float(img[0, w - 1]), rtol=1e-6)


def test_remap_real_maps_and_identity(yaml_path):
    """A rendered frame through the YAML's left maps and a random image
    through the KITTI-width lens, against the reference; an identity map
    returns the image."""
    cfg = synthetic_config(width=640, height=480)
    left, _ = SyntheticStereoWorld(cfg, seed=3).render(*forward_trajectory(1, step=0.1)[0])
    kitti = trect.build_rectify_map(*kitti_lens(1.0))
    kimg = np.random.default_rng(2).integers(0, 256, (376, 1241), dtype=np.uint8)
    for img, maps in ((left.astype(np.uint8), trect.rectification_from_yaml(yaml_path)[0]),
                      (left, trect.rectification_from_yaml(yaml_path)[1]), (kimg, kitti)):
        ref = np.asarray(jrect.remap(img, jrect.RectifyMaps(map_y=maps.map_y, map_x=maps.map_x)))
        out = trect.remap(img, maps, device="cpu").numpy()
        assert np.abs(out - ref).max() <= REMAP_TOL
        assert np.array_equal(trect.remap(img, maps, device="cpu").numpy(), out), "cached plan"
    K = np.array([[400.0, 0, 32], [0, 400.0, 24], [0, 0, 1]])
    ident = trect.build_rectify_map(K, np.zeros(5), np.eye(3), np.concatenate([K, np.zeros((3, 1))], 1),
                                    (64, 48))
    small = np.random.default_rng(0).uniform(0, 255, (48, 64)).astype(np.float32)
    assert np.abs(trect.remap(small, ident, device="cpu").numpy() - small).max() <= REMAP_TOL


def test_entry_points_default_to_the_card():
    """remap (and below, the map processor) take device="cuda" by default
    and raise without a card, never falling back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    maps = trect.build_rectify_map(np.eye(3), np.zeros(5), np.eye(3), np.eye(3, 4), (4, 3))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        trect.remap(np.zeros((3, 4), np.uint8), maps)


def test_message_bus():
    bus = tpubsub.MessageBus()
    got = []
    bus.subscribe("t", got.append)
    bus.publish("t", {"a": 1})
    assert got == [{"a": 1}] and bus.latest("t") == {"a": 1} and bus.latest("u") is None


def _read_lines(sock, out, stop):
    """NDJSON lines from `sock` into `out` until EOF."""
    buf = b""
    while True:
        try:
            data = sock.recv(1 << 16)
        except socket.timeout:
            if stop.is_set():
                return
            continue
        if not data:
            return
        buf += data
        *lines, buf = buf.split(b"\n")
        out.extend(json.loads(line) for line in lines)


def test_tcp_round_trip_carries_an_ndarray():
    bus = tpubsub.MessageBus()
    pub = tpubsub.TcpPublisher(bus, [tpubsub.TOPIC_POSE], port=0)
    try:
        c = socket.create_connection(("127.0.0.1", pub.port), timeout=5)
        deadline = time.time() + 5
        while not pub.n_subscribers and time.time() < deadline:
            time.sleep(0.01)
        Twc = np.arange(16, dtype=np.float64).reshape(4, 4) / 7.0
        bus.publish(tpubsub.TOPIC_POSE, {"t": 1.5, "Twc": Twc, "n": np.int64(3)})
        bus.publish("not_fanned_out", {"x": 1})
        c.settimeout(5)
        line = b""
        while not line.endswith(b"\n"):
            line += c.recv(4096)
        msg = json.loads(line)
        assert msg["topic"] == tpubsub.TOPIC_POSE
        nd = msg["msg"]["Twc"]
        assert nd["__nd__"] and nd["shape"] == [4, 4] and nd["dtype"] == "float64"
        assert np.array_equal(np.asarray(nd["data"]).reshape(4, 4), Twc)
        assert msg["msg"]["t"] == 1.5 and msg["msg"]["n"] == 3
        c.close()
    finally:
        pub.close()
    assert not pub._accept_thread.is_alive(), "close() stops the accept thread"


@pytest.mark.parametrize("kind", ["seeded", "empty"])
def test_pointcloud_to_laserscan_equals_reference(kind):
    if kind == "empty":
        pts = np.zeros((0, 3))
    else:
        rng = np.random.default_rng(5)
        pts = rng.normal(0, [8.0, 0.6, 8.0], (3000, 3))
        pts[:5] = [[0, 0, 5.0], [3.0, 0, 1e-4], [0, 9.0, 5.0], [0, 0, 0.1], [50.0, 0, 0]]
    ref, port = jpubsub.pointcloud_to_laserscan(pts), tpubsub.pointcloud_to_laserscan(pts)
    for a, b in zip(ref, port):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    if kind == "seeded":
        assert np.isfinite(port[0]).sum() > 100


def _deep_equal(a, b):
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_deep_equal(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


def test_system_publisher_messages_equal_reference():
    """One port System (CPU, 320x240, mapping on) read by the port's and
    the JAX SystemPublisher after each frame: the same messages on every
    topic, the scan relay included."""
    from orb_slam2_2021_tpu_torch.pipeline.system import System

    cfg = synthetic_config(width=320, height=240)
    world = SyntheticStereoWorld(cfg, seed=3)
    sys_ = System(cfg, enable_loop_closing=False, device="cpu",
                  place_rec=PlaceRecognition.from_file(PACKAGED_VOCAB_SMALL, "cpu"))
    topics = [tpubsub.TOPIC_POSE, tpubsub.TOPIC_POINTCLOUD, tpubsub.TOPIC_GRID,
              tpubsub.TOPIC_GRID_POSE, tpubsub.TOPIC_SCAN, tpubsub.TOPIC_METRICS]
    assert topics == [jpubsub.TOPIC_POSE, jpubsub.TOPIC_POINTCLOUD, jpubsub.TOPIC_GRID,
                      jpubsub.TOPIC_GRID_POSE, jpubsub.TOPIC_SCAN, jpubsub.TOPIC_METRICS]
    got = {}
    pubs = []
    for side, mod in (("port", tpubsub), ("ref", jpubsub)):
        bus = mod.MessageBus()
        for t in topics:
            bus.subscribe(t, lambda m, _k=(side, t): got.setdefault(_k, []).append(m))
        pubs.append(mod.SystemPublisher(sys_, bus, publish_scan=True))
    n_pose = 0
    for i, (R, t) in enumerate(forward_trajectory(4, step=0.12)):
        pose = sys_.track_stereo(*world.render(R, t), timestamp=0.1 * i)
        n_pose += pose is not None
        for p in pubs:
            p.publish_frame(0.1 * i)
            p.publish_map(0.1 * i)
    for t in topics:
        port, ref = got.get(("port", t), []), got.get(("ref", t), [])
        assert len(port) == len(ref) > 0, t
        assert all(_deep_equal(a, b) for a, b in zip(port, ref)), t
    assert len(got[("port", tpubsub.TOPIC_POSE)]) == n_pose == 4
    last = got[("port", tpubsub.TOPIC_POSE)][-1]["Twc"]
    np.testing.assert_allclose(np.linalg.inv(last)[:3, :3], pose[0], atol=1e-6)
    np.testing.assert_allclose(np.linalg.inv(last)[:3, 3], pose[1], atol=1e-6)
    assert np.array_equal(got[("port", tpubsub.TOPIC_GRID)][-1]["data"], sys_.occupancy_grid().data)


def test_run_slam_publishes(tmp_path):
    """`run_slam synthetic 8 --device cpu --publish`: prints its port,
    streams the topics to a subscriber, closes at exit, exits 0."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="2")
    cmd = [sys.executable, "-m", "orb_slam2_2021_tpu_torch.run_slam", "synthetic", "8",
           "--device", "cpu", "--publish"]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            cwd=tmp_path, env=env)
    lines, stop = [], threading.Event()
    try:
        first = proc.stdout.readline()
        assert first.startswith("publishing NDJSON on 127.0.0.1:"), first + proc.stderr.read()[-3000:]
        port = int(first.strip().rsplit(":", 1)[1])
        sock = socket.create_connection(("127.0.0.1", port), timeout=30)
        sock.settimeout(1.0)
        reader = threading.Thread(target=_read_lines, args=(sock, lines, stop), daemon=True)
        reader.start()
        out, err = proc.communicate(timeout=600)
        reader.join(timeout=30)
        assert not reader.is_alive(), "the publisher closed the connection at exit"
        sock.close()
    finally:
        stop.set()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, err[-3000:]
    assert sum(line.startswith("frame ") for line in out.splitlines()) == 8
    poses = [m["msg"] for m in lines if m["topic"] == "os2_pose"]
    assert poses and poses[-1]["t"] == pytest.approx(0.7) and poses[-1]["Twc"]["shape"] == [4, 4]
    assert {m["topic"] for m in lines} <= {"os2_pose", "os2_pointcloud", "os2_gm", "os2_gm_pose",
                                           "os2_metrics"}
