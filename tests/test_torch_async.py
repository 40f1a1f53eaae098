"""The port's async mode on the CPU: tracking on the caller's thread, local
mapping with loop closing on a worker thread, global BA on a thread of its
own (the reference's thread layout). The System drive is held to the bounds
of the JAX package's tests/test_async.py and beside the synchronous port on
the same frames; the worker's and the global-BA thread's control paths
(drain on finish, abort of a local BA by a new keyframe, a superseded or
stopped global BA, reset while busy, an exception raised on the lane) are
driven directly, with solves made to block on threading events.
"""

import threading
import time

import numpy as np
import pytest
import torch

from orb_slam2_2021_tpu_torch.config import synthetic_config
from orb_slam2_2021_tpu_torch.io.synthetic import SyntheticStereoWorld, forward_trajectory
from orb_slam2_2021_tpu_torch.io.trajectory import ate_rmse
from orb_slam2_2021_tpu_torch.mapping.map_store import MapStore
from orb_slam2_2021_tpu_torch.pipeline import local_mapping, loop_closing
from orb_slam2_2021_tpu_torch.pipeline.local_mapping import LocalMapping
from orb_slam2_2021_tpu_torch.pipeline.streams import DeviceStreams
from orb_slam2_2021_tpu_torch.pipeline.system import System
from orb_slam2_2021_tpu_torch.place.bundle import PACKAGED_VOCAB_SMALL, PlaceRecognition
from orb_slam2_2021_tpu_torch.place.kf_database import KeyFrameDatabase
from orb_slam2_2021_tpu_torch.place.vocab import BinaryVocabulary

torch.set_num_threads(1)

CFG = synthetic_config(width=320, height=240)
N_FRAMES = 20
WAIT_S = 60.0  # bound on every wait for another thread


def _gt_mats(gt):
    out = []
    for R, t in gt:
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        out.append(T)
    return out


def _small_place():
    return PlaceRecognition.from_file(PACKAGED_VOCAB_SMALL, "cpu")


@pytest.fixture(scope="module")
def drive():
    """The rendered frames and ground truth of tests/test_async.py's forward
    drive (SyntheticStereoWorld seed 3, step 0.12 m), N_FRAMES long."""
    world = SyntheticStereoWorld(CFG, seed=3)
    gt = forward_trajectory(N_FRAMES, step=0.12)
    return [world.render(R, t) for R, t in gt], gt


def _run(frames, **kw):
    sys_ = System(CFG, place_rec=_small_place(), device="cpu", **kw)
    n_ok = sum(sys_.track_stereo(l, r, timestamp=0.1 * i) is not None
               for i, (l, r) in enumerate(frames))
    sys_.shutdown()
    return sys_, n_ok


@pytest.fixture(scope="module")
def sync_system(drive):
    """The synchronous port System (mapping and loop closing on) over the
    drive; its map serves the control-path tests below."""
    return _run(drive[0])


def test_async_drive_meets_the_reference_bounds_beside_sync(drive, sync_system):
    """JAX tests/test_async.py:30-47's bounds: tracked >= n - 2, ATE below
    max(6% of the path, 0.3 m), the map grown past the initializer's
    points; invariants clean and both threads joined. The synchronous port
    meets the same bounds on the same frames."""
    frames, gt = drive
    sys_, n_ok = _run(frames, async_mode=True)
    assert sys_.local_mapper.async_mode and sys_._worker is not None
    assert not sys_._worker.is_alive(), "the mapping worker was joined"
    th = sys_.loop_closer.gba_thread
    assert th is None or not th.is_alive(), "the global-BA thread was joined"
    mats = _gt_mats(gt)
    total = float(np.linalg.norm(np.diff([T[:3, 3] for T in mats], axis=0), axis=1).sum())
    bound = max(0.06 * total, 0.3)
    sync_, n_sync = sync_system
    for name, s, n in (("async", sys_, n_ok), ("sync", sync_, n_sync)):
        est = s.trajectory_kitti()
        ate = ate_rmse(est, mats[: len(est)])
        assert n >= N_FRAMES - 2, f"{name}: tracked {n}/{N_FRAMES}"
        assert np.isfinite(ate) and ate < bound, f"{name}: ATE {ate:.3f} m over {total:.2f} m"
        assert s.map.n_kf >= 2 and s.map.next_mp > 600, f"{name}: the map did not grow"
        bad = s.map.check_invariants()
        assert not bad, f"{name}: " + "\n".join(bad[:20])
    assert len(sys_.metrics) == N_FRAMES


def _worker(lm):
    lm.async_mode, lm.streams = True, DeviceStreams("cpu")
    th = threading.Thread(target=lm.run_worker, name="mapping", daemon=True)
    th.start()
    return th


def test_worker_drains_its_queue_on_request_finish():
    lm = LocalMapping(CFG, MapStore(CFG), "cpu")
    done = []

    def slow_process(k, words=None, frame=None, ready=None):
        time.sleep(0.02)
        done.append(k)

    lm._process = slow_process
    th = _worker(lm)
    for k in range(6):
        lm.insert_keyframe(k, None)
    lm.request_finish()
    th.join(WAIT_S)
    assert not th.is_alive(), "the worker ended after request_finish"
    assert done == list(range(6)) and not lm.queue, "every queued keyframe was processed, in order"
    assert lm.error is None


def test_new_keyframe_aborts_a_local_ba_in_flight(sync_system, monkeypatch):
    """The first LM phase blocks until a keyframe has been inserted; the
    solve then skips its second phase and writes back the first's result."""
    sys_, _ = sync_system
    lm = sys_.local_mapper
    k = int(np.nonzero(sys_.map.kf_valid)[0][-1])
    real, phases = local_mapping.lm_chunk_pq, []
    started, release = threading.Event(), threading.Event()

    def blocking(*args):
        phases.append(args[-1])  # the phase's LM iterations
        if len(phases) == 1:
            started.set()
            assert release.wait(WAIT_S)
        return real(*args)

    monkeypatch.setattr(local_mapping, "lm_chunk_pq", blocking)
    n_solves = len(lm.ba_solve_times)
    lm.abort_ba = False
    th = threading.Thread(target=lm._local_ba, args=(k,))
    th.start()
    assert started.wait(WAIT_S), "local BA started"
    lm.insert_keyframe(k, None)
    release.set()
    th.join(WAIT_S)
    lm.queue.clear()
    assert phases == [CFG.optim.local_ba_iters1], "the second LM phase was aborted"
    assert len(lm.ba_solve_times) == n_solves + 1, "the first phase's result was written back"


@pytest.mark.parametrize("interrupt", ["none", "newer_loop", "stop"])
def test_global_ba_writes_back_only_when_current(sync_system, monkeypatch, interrupt):
    """A global BA whose index a newer loop bumped while it solved writes
    nothing back ("superseded"); one stopped between iterations ends early
    ("aborted"); an undisturbed one writes the map ("written")."""
    sys_, _ = sync_system
    m = sys_.map
    voc = BinaryVocabulary(2, 2, np.zeros((7, 8), np.uint32), np.ones(4, np.float32))
    lc = loop_closing.LoopClosing(CFG, m, KeyFrameDatabase(voc), "cpu")
    real, calls = loop_closing.lm_chunk_pq, []
    started, release = threading.Event(), threading.Event()

    def blocking(*args):
        calls.append(1)
        if len(calls) == 1:
            started.set()
            assert release.wait(WAIT_S)
        return real(*args)

    monkeypatch.setattr(loop_closing, "lm_chunk_pq", blocking)
    before = (m.kf_R.copy(), m.kf_t.copy(), m.mp_pos.copy(), m.write_epoch)
    th = threading.Thread(target=lc._run_global_ba, args=(lc.full_ba_idx,))
    th.start()
    assert started.wait(WAIT_S), "global BA started"
    if interrupt == "newer_loop":
        lc.full_ba_idx += 1
    elif interrupt == "stop":
        lc.stop_gba = True
    release.set()
    th.join(WAIT_S)
    outcome = {"none": "written", "newer_loop": "superseded", "stop": "aborted"}[interrupt]
    assert [r["outcome"] for r in lc.gba_runs] == [outcome]
    unchanged = (np.array_equal(m.kf_R, before[0]) and np.array_equal(m.kf_t, before[1])
                 and np.array_equal(m.mp_pos, before[2]) and m.write_epoch == before[3])
    assert unchanged == (interrupt != "none")
    assert len(calls) == (1 if interrupt == "stop" else CFG.optim.global_ba_iters)


def test_request_reset_waits_for_the_busy_worker():
    lm = LocalMapping(CFG, MapStore(CFG), "cpu")
    busy, release, done = threading.Event(), threading.Event(), []

    def blocking_process(k, words=None, frame=None, ready=None):
        busy.set()
        assert release.wait(WAIT_S)
        done.append(k)

    lm._process = blocking_process
    th = _worker(lm)
    lm.insert_keyframe(0, None)
    assert busy.wait(WAIT_S)
    lm.insert_keyframe(1, None)
    lm.recent[5] = 1
    resetter = threading.Thread(target=lm.request_reset)
    resetter.start()
    resetter.join(0.3)
    assert resetter.is_alive(), "request_reset returned while the worker was busy"
    release.set()
    resetter.join(WAIT_S)
    assert not resetter.is_alive()
    assert done == [0] and not lm.queue and not lm.recent and not lm.abort_ba
    lm.request_finish()
    th.join(WAIT_S)
    assert not th.is_alive()


def test_worker_exception_is_raised_on_the_lane(drive, monkeypatch):
    def fail(self, k):
        raise RuntimeError("mapping pass failed on purpose")

    monkeypatch.setattr(LocalMapping, "_mapping_device_pass", fail)
    frames, _ = drive
    sys_ = System(CFG, async_mode=True, enable_loop_closing=False, device="cpu")
    with pytest.raises(RuntimeError, match="on purpose"):
        for i, (l, r) in enumerate(frames[:8]):
            sys_.track_stereo(l, r, timestamp=0.1 * i)
            sys_._worker.join(0.5)  # let the worker reach the keyframe
    assert not sys_._worker.is_alive(), "the worker thread ended"
    with pytest.raises(RuntimeError, match="on purpose"):
        sys_.shutdown()


def test_async_rgbd_drive():
    """A few RGB-D frames in async mode, depth as uint16 at TUM's
    DepthMapFactor: tracked, keyframes mapped by the worker, invariants
    clean, the worker joined."""
    cfg = CFG.replace(depth_map_factor=5000.0)
    world = SyntheticStereoWorld(cfg, seed=4, z_min=1.0, z_max=6.0)
    sys_ = System(cfg, sensor="rgbd", async_mode=True, enable_loop_closing=False, device="cpu")
    n_ok = 0
    for i, (R, t) in enumerate(forward_trajectory(8, step=0.15)):
        img, depth = world.render_rgbd(R, t)
        raw = np.round(depth * cfg.depth_map_factor).astype(np.uint16)
        n_ok += sys_.track_rgbd(img, raw, timestamp=0.1 * i) is not None
    sys_.shutdown()
    assert n_ok == 8
    assert sys_.map.next_kf >= 2 and not sys_._worker.is_alive()
    bad = sys_.map.check_invariants()
    assert not bad, "\n".join(bad[:20])


def test_cold_build_from_two_threads_compiles_once(tmp_path, monkeypatch):
    """CudaKernel.build() under its lock: two threads reaching a kernel that
    is not built yet compile it once and load it once (the compiler and the
    loader replaced here, so the test runs without nvcc)."""
    from orb_slam2_2021_tpu_torch.ops import cuda_build

    calls = {"compile": 0, "load": 0}

    def fake_compile(src, lib_path):
        calls["compile"] += 1
        time.sleep(0.2)  # a slow compile: the second thread arrives meanwhile
        open(lib_path, "w").close()

    class Lib:
        def __getattr__(self, name):
            return type("Fn", (), {})()

    def fake_load(lib_path):
        calls["load"] += 1
        return Lib()

    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "_compile", fake_compile)
    monkeypatch.setattr(cuda_build, "_load", fake_load)
    kernel = cuda_build.CudaKernel("hamming.cu", "hamming_best2_launch", [])
    barrier, got = threading.Barrier(2), []

    def build():
        barrier.wait()
        got.append(kernel.build())

    threads = [threading.Thread(target=build) for _ in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(WAIT_S)
    assert calls == {"compile": 1, "load": 1} and len(got) == 2 and got[0] is got[1]


def test_launch_counts_are_kept_per_thread():
    from orb_slam2_2021_tpu_torch.ops.cuda_build import CudaKernel

    kernel = CudaKernel("hamming.cu", "hamming_best2_launch", [])
    kernel.count()
    th = threading.Thread(target=lambda: [kernel.count() for _ in range(3)], name="mapping")
    th.start()
    th.join(WAIT_S)
    assert kernel.launches == 4
    assert dict(kernel.launches_by_thread) == {threading.current_thread().name: 1, "mapping": 3}
    kernel.reset_counts()
    assert kernel.launches == 0 and not kernel.launches_by_thread


def test_async_mono_drive():
    """Monocular input in async mode: the two-view initialization on the
    lane, the monocular mapping gates on the worker."""
    world = SyntheticStereoWorld(CFG, seed=9)
    images = [world.render(R, t)[0] for R, t in forward_trajectory(14, step=0.12)]
    sys_ = System(CFG, sensor="mono", async_mode=True, place_rec=_small_place(), device="cpu")
    tracked = [sys_.track_monocular(img, timestamp=0.1 * i) is not None for i, img in enumerate(images)]
    sys_.shutdown()
    init = tracked.index(True)
    assert init <= 8 and all(tracked[init:]), tracked
    assert sys_.map.next_kf >= 3 and sys_.local_mapper.monocular and not sys_._worker.is_alive()
    bad = sys_.map.check_invariants()
    assert not bad, "\n".join(bad[:20])
