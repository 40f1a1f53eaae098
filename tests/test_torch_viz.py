"""The port's headless viewer (`viz/frame_drawer.py`, `viz/map_drawer.py`,
`viz/viewer.py`) and `run_slam.py --viz`, held against the JAX package on
the CPU.

The drawers are numpy on both sides: on the same arrays the images must be
identical (`np.array_equal`), and a synchronous System's Viewer must write
the same PNG bytes as the reference's Viewer reading that System.
"""

import os
import subprocess
import sys
import threading
from types import SimpleNamespace

import numpy as np
import pytest
from PIL import Image

from orb_slam2_2021_tpu.config import synthetic_config as ref_synthetic_config
from orb_slam2_2021_tpu.mapping.map_store import MapStore as RefMapStore
from orb_slam2_2021_tpu.viz import frame_drawer as jframe
from orb_slam2_2021_tpu.viz import map_drawer as jmap
from orb_slam2_2021_tpu.viz import viewer as jviewer
from orb_slam2_2021_tpu_torch import convert
from orb_slam2_2021_tpu_torch.config import synthetic_config
from orb_slam2_2021_tpu_torch.io.synthetic import SyntheticStereoWorld, forward_trajectory
from orb_slam2_2021_tpu_torch.pipeline.system import System
from orb_slam2_2021_tpu_torch.viz import FrameDrawer, MapDrawer, Viewer
from orb_slam2_2021_tpu_torch.viz.frame_drawer import BAR_H

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _frame_inputs(rng, n=60, h=48, w=64, uint8=False):
    img = rng.uniform(-20, 275, (h, w))
    img = img.clip(0, 255).astype(np.uint8) if uint8 else img.astype(np.float32)
    kp = rng.uniform(-4, w + 4, (n, 2)).astype(np.float32)
    valid = rng.random(n) < 0.9
    bind = np.where(rng.random(n) < 0.5, rng.integers(0, 100, n), -1).astype(np.int64)
    return img, kp, valid, bind


@pytest.mark.parametrize("case", ["bind", "inlier_vo", "uint8_no_bind", "empty"])
def test_frame_drawer_equals_reference(case):
    rng = np.random.default_rng(["bind", "inlier_vo", "uint8_no_bind", "empty"].index(case))
    img, kp, valid, bind = _frame_inputs(rng, n=0 if case == "empty" else 60,
                                         uint8=case == "uint8_no_bind")
    kw = {"state": "LOST" if case == "empty" else "OK", "n_kf": 7, "n_mp": 1234}
    if case != "uint8_no_bind":
        kw["bind"] = bind
    if case == "inlier_vo":
        kw["inlier"] = rng.random(len(kp)) < 0.7
        kw["vo_mask"] = rng.random(len(kp)) < 0.2
    ref = jframe.FrameDrawer().draw(img, kp, valid, **kw)
    port = FrameDrawer().draw(img, kp, valid, **kw)
    assert port.shape == (48 + BAR_H, 64, 3) and port.dtype == np.uint8
    assert np.array_equal(port, ref)


def _reference_map(n_kf=5, n_mp=300):
    """A reference MapStore with keyframes around a turn, covisibility
    weights on both sides of the drawing threshold and map points."""
    cfg = ref_synthetic_config(width=64, height=48)
    m = RefMapStore(cfg)
    rng = np.random.default_rng(3)
    pos = rng.uniform(-5, 5, (n_mp, 3)).astype(np.float32)
    ids = m.add_map_points_batch(pos, rng.integers(0, 2 ** 32, (n_mp, 8), dtype=np.uint32), first_kf=0)
    N = cfg.orb.n_features
    for k in range(n_kf):
        a = 0.3 * k
        R = np.array([[np.cos(a), 0, -np.sin(a)], [0, 1, 0], [np.sin(a), 0, np.cos(a)]], np.float32)
        t = np.array([0.4 * k, 0.0, -0.2 * k], np.float32)
        bind = np.full(N, -1, np.int64)
        sel = ids[k * 40: k * 40 + 80][:N]
        bind[: len(sel)] = sel
        m.add_keyframe(R, t, rng.uniform(0, 48, (N, 2)).astype(np.float32),
                       np.full(N, -1.0, np.float32), np.full(N, -1.0, np.float32),
                       np.zeros(N, np.int32), np.zeros(N, np.float32),
                       np.zeros((N, 8), np.uint32), np.ones(N, bool), bind, k, 0.1 * k)
    kfs = np.nonzero(m.kf_valid)[0]
    for i, j, w in ((0, 1, 150), (1, 2, 99), (2, 3, 100), (0, 4, 400)):
        m.covis[kfs[i], kfs[j]] = m.covis[kfs[j], kfs[i]] = w
    m.mp_valid[ids[::7]] = False
    return m


@pytest.mark.parametrize("graph", [True, False])
def test_map_drawer_equals_reference(graph):
    ref_map = _reference_map()
    port_map = convert.map_store_from_reference(ref_map)
    K = ref_map.kf_valid.shape[0]
    # the spanning tree and loop edges, read where a store has them
    for m in (ref_map, port_map):
        m.kf_parent = np.full(K, -1, np.int64)
        m.kf_parent[1:5] = [0, 1, 2, 3]
        m.kf_loop_edges = np.zeros((K, K), bool)
        m.kf_loop_edges[0, 4] = m.kf_loop_edges[4, 0] = True
    pose = (np.eye(3, dtype=np.float32), np.array([0.5, 0.0, 1.0], np.float32))
    local = np.array([-1, 0, 3, 7, 14, 299, 40])
    kw = {"cur_pose": pose, "local_ids": local, "draw_graph": graph}
    ref = jmap.MapDrawer(width=240, height=200).render(ref_map, **kw)
    port = MapDrawer(width=240, height=200).render(port_map, **kw)
    assert port.shape == (200, 240, 3) and (port != 255).any()
    assert np.array_equal(port, ref)
    empty = convert.map_store_from_reference(RefMapStore(ref_map.cfg))
    assert np.array_equal(MapDrawer(64, 64).render(empty),
                          jmap.MapDrawer(64, 64).render(RefMapStore(ref_map.cfg)))


def _drive(sys_, n, viewers):
    cfg = sys_.cfg
    world = SyntheticStereoWorld(cfg, seed=3)
    for i, (R, t) in enumerate(forward_trajectory(n, step=0.12)):
        left, right = world.render(R, t)
        sys_.track_stereo(left, right, timestamp=0.1 * i)
        for v in viewers:
            v.update(left)


def test_viewer_sync_drive_writes_the_reference_images(tmp_path):
    """A synchronous mapping drive on the CPU: the port's Viewer and the
    reference's Viewer, both reading the port's System, write the same PNG
    bytes; the drawers read the tracker's last frame and the map store."""
    sys_ = System(synthetic_config(width=320, height=240), enable_mapping=True,
                  enable_loop_closing=False, device="cpu")
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    port = Viewer(sys_, out_dir=str(port_dir), stride=3, map_size=300)
    ref = jviewer.Viewer(sys_, out_dir=str(ref_dir), stride=3, map_size=300)
    _drive(sys_, 7, [port, ref])
    sys_.shutdown()
    names = sorted(os.listdir(port_dir))
    assert names == [f"{kind}_{i:06d}.png" for kind in ("frame", "map") for i in (0, 3, 6)]
    assert names == sorted(os.listdir(ref_dir))
    for name in names:
        assert (port_dir / name).read_bytes() == (ref_dir / name).read_bytes(), name
    frame = np.asarray(Image.open(port_dir / "frame_000006.png"))
    assert frame.shape == (240 + BAR_H, 320, 3)
    green = (frame[..., 1] == 220) & (frame[..., 0] == 0)
    assert green.sum() > 100  # tracked map points drawn
    assert sys_.map.n_kf >= 1 and port.lock_holds == []  # sync: the map is drawn as it stands


def test_async_viewer_copies_the_map_under_its_lock():
    """Async mode on the CPU: each update holds the map lock for its copy
    (an update waits while another thread holds the lock), and the copy
    renders as the store itself does under the lock."""
    sys_ = System(synthetic_config(width=320, height=240), enable_mapping=True,
                  enable_loop_closing=False, async_mode=True, device="cpu")
    viewer = Viewer(sys_, map_size=200)
    release = threading.Event()
    try:
        _drive(sys_, 5, [viewer])
        assert len(viewer.lock_holds) == 5 and all(h >= 0 for h in viewer.lock_holds)
        held, done = threading.Event(), threading.Event()

        def hold():
            with sys_.map.lock:
                held.set()
                release.wait(30)

        holder = threading.Thread(target=hold)
        holder.start()
        assert held.wait(30)
        updater = threading.Thread(target=lambda: (viewer.update(), done.set()))
        updater.start()
        assert not done.wait(0.5), "the viewer's copy did not wait for the map lock"
        release.set()
        holder.join(30)
        updater.join(60)
        assert done.is_set() and not updater.is_alive() and not holder.is_alive()
        assert len(viewer.lock_holds) == 6
        with sys_.map.lock:  # the worker writes the store under this lock
            pose = sys_.tracker.last_pose
            drawer = MapDrawer(200, 200)
            assert np.array_equal(drawer.render(viewer._map_view(), cur_pose=pose),
                                  drawer.render(sys_.map, cur_pose=pose))
    finally:
        release.set()
        sys_.shutdown()
    viewer.update()  # shut down: the map is quiescent and drawn as it stands
    assert len(viewer.lock_holds) == 7


def test_async_map_view_holds_only_the_rows_in_use():
    """The async copy holds the keyframe rows up to next_kf, the map-point
    rows up to next_mp and covisibility's [next_kf, next_kf] corner of a
    store whose capacity is larger; MapDrawer (with and without the graph)
    and the frame drawer give the same pixels from it as from the store."""
    m = convert.map_store_from_reference(_reference_map())
    m.kf_valid[2] = False  # a culled keyframe inside the rows in use
    nk, nm = m.next_kf, m.next_mp
    assert m.kf_capacity > nk and m.mp_capacity > nm
    rng = np.random.default_rng(5)
    img, kp, valid, bind = _frame_inputs(rng)
    pose = (np.eye(3, dtype=np.float32), np.array([0.5, 0.0, 1.0], np.float32))
    tracker = SimpleNamespace(last_frame_data={"xy": kp, "kp_valid": valid}, _bind_cur=bind,
                              state=SimpleNamespace(name="OK"), last_pose=pose)
    sys_ = SimpleNamespace(cfg=synthetic_config(width=64, height=48), map=m, async_mode=True,
                           tracker=tracker)
    viewer = Viewer(sys_, map_size=240)
    view = viewer._map_view()
    assert len(viewer.lock_holds) == 1 and view.n_kf == m.n_kf
    assert view.covis.shape == (nk, nk) and np.array_equal(view.covis, m.covis[:nk, :nk])
    for name, n in (("kf_valid", nk), ("kf_R", nk), ("kf_t", nk), ("mp_pos", nm), ("mp_valid", nm)):
        got = getattr(view, name)
        assert len(got) == n and np.array_equal(got, getattr(m, name)[:n]), name
    for graph in (True, False):
        drawer = MapDrawer(240, 200)
        assert np.array_equal(drawer.render(view, cur_pose=pose, draw_graph=graph),
                              drawer.render(m, cur_pose=pose, draw_graph=graph))
    fd = FrameDrawer(sys_.cfg)
    assert np.array_equal(fd.draw_from_system(sys_, img, view), fd.draw_from_system(sys_, img))


def test_run_slam_viz_writes_pngs(tmp_path):
    """`run_slam synthetic 6 --viz out --device cpu`: a frame and a map PNG
    at frames 0 and 5 (stride 5)."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="2")
    cmd = [sys.executable, "-m", "orb_slam2_2021_tpu_torch.run_slam", "synthetic", "6",
           "--viz", "out", "--device", "cpu"]
    res = subprocess.run(cmd, capture_output=True, text=True, cwd=tmp_path, env=env, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    names = sorted(os.listdir(tmp_path / "out"))
    assert names == ["frame_000000.png", "frame_000005.png", "map_000000.png", "map_000005.png"]
    assert np.asarray(Image.open(tmp_path / "out" / "frame_000005.png")).shape == (240 + BAR_H, 320, 3)
    assert np.asarray(Image.open(tmp_path / "out" / "map_000005.png")).shape == (720, 720, 3)
