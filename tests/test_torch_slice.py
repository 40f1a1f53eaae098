"""The PyTorch port's System end to end, held against the JAX reference
System on the same rendered 320x240 sequence, synchronous: the stereo
tracking lane with mapping off, and with local mapping and the occupancy
grid on (loop closing off); the modes still unported; and the port's
independence from JAX. Loop closing at the defaults is held against the
reference in tests/test_torch_loop.py.

The reference System gets the small packaged vocabulary and the port its
default one: with loop closing off no keyframe ever enters either keyframe
database, so relocalization falls back to the reference-keyframe search on
both sides. Tracking is therefore the same algorithm on both sides.
"""

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from orb_slam2_2021_tpu.config import synthetic_config
from orb_slam2_2021_tpu.io.synthetic import SyntheticStereoWorld, forward_trajectory
from orb_slam2_2021_tpu.io.trajectory import ate_rmse
from orb_slam2_2021_tpu_torch.pipeline.system import System as TSystem

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 12


def _gt_mats(gt):
    out = []
    for R, t in gt:
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        out.append(T)
    return out


def test_slice_matches_reference_system():
    from orb_slam2_2021_tpu.pipeline.system import System as JSystem
    from orb_slam2_2021_tpu.place.bundle import PACKAGED_VOCAB_SMALL, PlaceRecognition
    from orb_slam2_2021_tpu.place.vocab import BinaryVocabulary

    cfg = synthetic_config(width=320, height=240)
    world = SyntheticStereoWorld(cfg, seed=3)
    gt = forward_trajectory(N_FRAMES, step=0.12)
    frames = [world.render(R, t) for R, t in gt]

    ref = JSystem(cfg, enable_mapping=False,
                  place_rec=PlaceRecognition(BinaryVocabulary.load(PACKAGED_VOCAB_SMALL)))
    port = TSystem(cfg, enable_mapping=False, device="cpu")
    for i, (left, right) in enumerate(frames):
        pr = ref.track_stereo(left, right, timestamp=0.1 * i)
        pt = port.track_stereo(left, right, timestamp=0.1 * i)
        assert (pr is None) == (pt is None), f"frame {i}: tracked flags differ"
        if pr is not None:
            dt = np.abs(pt[1] - pr[1]).max()
            dR = np.abs(pt[0] - pr[0]).max()
            assert dt < 1e-3, f"frame {i}: t differs by {dt:.2e} m (tolerance 1 mm)"
            assert dR < 1e-3, f"frame {i}: R differs by {dR:.2e} (tolerance 1e-3)"
        assert port.map.n_kf == ref.map.n_kf, f"frame {i}: keyframe counts differ"
    ref.shutdown()
    port.shutdown()

    assert [m["state"] for m in port.metrics] == [m["state"] for m in ref.metrics]
    est_t, est_r = port.trajectory_kitti(), ref.trajectory_kitti()
    assert len(est_t) == len(est_r) == N_FRAMES
    diff = max(np.abs(A[:3, 3] - B[:3, 3]).max() for A, B in zip(est_t, est_r))
    assert diff < 1e-3, f"exported trajectories differ by {diff:.2e} m (tolerance 1 mm)"
    ate_t, ate_r = ate_rmse(est_t, _gt_mats(gt)), ate_rmse(est_r, _gt_mats(gt))
    assert np.isfinite(ate_t) and abs(ate_t - ate_r) < 1e-3, \
        f"ATE {ate_t:.4f} m vs the reference's {ate_r:.4f} m (tolerance 1 mm)"


def test_mapping_on_matches_reference_system():
    """20 frames with local mapping and the grid on: keyframes at frames 0,
    15 and 19, the first local BA at frame 19."""
    from orb_slam2_2021_tpu.pipeline.system import System as JSystem
    from orb_slam2_2021_tpu.place.bundle import PACKAGED_VOCAB_SMALL, PlaceRecognition
    from orb_slam2_2021_tpu.place.vocab import BinaryVocabulary

    n = 20
    cfg = synthetic_config(width=320, height=240)
    world = SyntheticStereoWorld(cfg, seed=3)
    gt = forward_trajectory(n, step=0.12)
    ref = JSystem(cfg, enable_mapping=True, enable_loop_closing=False,
                  place_rec=PlaceRecognition(BinaryVocabulary.load(PACKAGED_VOCAB_SMALL)))
    port = TSystem(cfg, enable_mapping=True, enable_loop_closing=False, device="cpu")
    worst = 0.0
    for i, (R, t) in enumerate(gt):
        left, right = world.render(R, t)
        pr = ref.track_stereo(left, right, timestamp=0.1 * i)
        pt = port.track_stereo(left, right, timestamp=0.1 * i)
        assert (pr is None) == (pt is None), f"frame {i}: tracked flags differ"
        assert port.map.n_kf == ref.map.n_kf, f"frame {i}: keyframe counts differ"
        if pr is not None:
            worst = max(worst, np.abs(pt[1] - pr[1]).max(), np.abs(pt[0] - pr[0]).max())
        n_r, n_t = int(ref.map.mp_valid.sum()), int(port.map.mp_valid.sum())
        assert abs(n_t - n_r) <= 0.01 * n_r, f"frame {i}: {n_t} vs {n_r} map points (tolerance 1%)"
    ref.shutdown()
    port.shutdown()
    # measured: poses within 9.5e-5 m and 5.4e-6 in R; map points identical
    assert worst < 1e-3, f"poses differ by {worst:.2e} (tolerance 1 mm / 1e-3)"
    assert [m["state"] for m in port.metrics] == [m["state"] for m in ref.metrics]
    assert [m["keyframe"] for m in port.metrics] == [m["keyframe"] for m in ref.metrics]
    assert np.nonzero([m["keyframe"] for m in port.metrics])[0].tolist() == [0, 15, 19]
    assert len(port.local_mapper.ba_solve_times) == len(ref.local_mapper.ba_solve_times) == 1
    assert all(r["ms_mapping"] >= 0 for r in port.metrics)
    assert np.array_equal(port.map.kf_valid, ref.map.kf_valid)
    for k in np.nonzero(ref.map.kf_valid)[0]:
        assert np.abs(port.map.kf_t[k] - ref.map.kf_t[k]).max() < 1e-3, "keyframe t: 1 mm"
    est_t, est_r = port.trajectory_kitti(), ref.trajectory_kitti()
    ate_t, ate_r = ate_rmse(est_t, _gt_mats(gt)), ate_rmse(est_r, _gt_mats(gt))
    assert np.isfinite(ate_t) and abs(ate_t - ate_r) < 1e-3, \
        f"ATE {ate_t:.4f} m vs the reference's {ate_r:.4f} m (tolerance 1 mm)"
    # the grid is built from the (1e-4 m apart) map: a ray whose end lies on
    # a cell boundary can land in the neighbour cell (measured: 4 of 108
    # occupied cells differ); the occupied sets must overlap by 90%
    occ_t = port.occupancy_grid().data == 100
    occ_r = ref.occupancy_grid().data == 100
    assert occ_r.sum() > 50 and (occ_t & occ_r).sum() >= 0.9 * occ_r.sum()
    assert len(port.point_cloud()) == len(ref.point_cloud())


def _reset_on_early_loss(mapping: bool):
    """Initialize, then show a frame of an unrelated world: both systems lose
    track with a small map, reset, and re-initialize on the next frame."""
    from orb_slam2_2021_tpu.pipeline.system import System as JSystem
    from orb_slam2_2021_tpu.place.bundle import PACKAGED_VOCAB_SMALL, PlaceRecognition
    from orb_slam2_2021_tpu.place.vocab import BinaryVocabulary

    cfg = synthetic_config(width=320, height=240)
    gt = forward_trajectory(3, step=0.12)
    worlds = [SyntheticStereoWorld(cfg, seed=3), SyntheticStereoWorld(cfg, seed=11)]
    frames = [worlds[0].render(*gt[0]), worlds[0].render(*gt[1]),
              worlds[1].render(*gt[2]), worlds[1].render(*gt[2])]
    ref = JSystem(cfg, enable_mapping=mapping, enable_loop_closing=False,
                  place_rec=PlaceRecognition(BinaryVocabulary.load(PACKAGED_VOCAB_SMALL)))
    port = TSystem(cfg, enable_mapping=mapping, enable_loop_closing=False, device="cpu")
    states = []
    for i, (left, right) in enumerate(frames):
        pr = ref.track_stereo(left, right, timestamp=0.1 * i)
        pt = port.track_stereo(left, right, timestamp=0.1 * i)
        assert (pr is None) == (pt is None), f"frame {i}: tracked flags differ"
        assert port.map.n_kf == ref.map.n_kf, f"frame {i}: keyframe counts differ"
        states.append((port.tracker.state.name, ref.tracker.state.name))
    assert states[2] == ("LOST", "LOST") and port._reset_requested is False
    assert states[3] == ("OK", "OK") and port.map.n_kf == 1, "re-initialized after the reset"
    assert len(port.trajectory_kitti()) == len(ref.trajectory_kitti()) == 1
    return port, ref


def test_reset_on_early_loss_matches_reference():
    _reset_on_early_loss(mapping=False)


def test_reset_with_mapping_matches_reference():
    """The reset order with mapping on: the mapping queue and its device
    keyframe store, the map, the tracker, then the grid (rebuilt from the
    new map's one keyframe)."""
    port, ref = _reset_on_early_loss(mapping=True)
    assert int(port.map.mp_valid.sum()) == int(ref.map.mp_valid.sum())
    assert not port.local_mapper.queue and port.local_mapper._devkf.uploaded[0]
    assert np.array_equal(port.occupancy_grid().data, ref.occupancy_grid().data)


def test_unported_modes_raise():
    """The reference's defaults construct (place recognition from the
    packaged vocabulary, loop closing on), as does a given PlaceRecognition;
    the RGB-D and monocular Systems and localization mode construct and
    run; async mode starts its worker only with mapping on (as in the
    reference); the dense local BA (use_cg_local_ba=False) constructs."""
    from orb_slam2_2021_tpu_torch.place.bundle import PACKAGED_VOCAB_SMALL, PlaceRecognition
    from orb_slam2_2021_tpu_torch.place.vocab import BinaryVocabulary

    cfg = synthetic_config(width=320, height=240)
    for kwargs, worker in (({"async_mode": True}, True),
                           ({"enable_mapping": False, "async_mode": True}, False),
                           ({"enable_mapping": False, "sensor": "mono", "async_mode": True}, False),
                           ({"enable_loop_closing": False, "async_mode": True}, True)):
        started = TSystem(cfg, device="cpu", **kwargs)
        assert started.async_mode == worker and (started._worker is not None) == worker
        started.shutdown()
        assert started._worker is None or not started._worker.is_alive()
    dense = TSystem(cfg.replace(optim=dataclasses.replace(cfg.optim, use_cg_local_ba=False)), device="cpu")
    assert not dense.local_mapper.cfg.optim.use_cg_local_ba and dense.loop_closer.dist_gba is None
    with pytest.raises(ValueError):
        TSystem(cfg, sensor="lidar", device="cpu")
    sys_ = TSystem(cfg, device="cpu")
    assert sys_.loop_closer is not None and sys_.local_mapper.loop_closer is sys_.loop_closer
    assert sys_.loop_closer.fix_scale and not sys_.local_mapper.monocular
    assert (sys_.place.voc.k, sys_.place.voc.L) == (10, 6)
    assert sys_.map.on_kf_erased == sys_.place.kfdb.erase
    pr = PlaceRecognition(BinaryVocabulary.load(PACKAGED_VOCAB_SMALL), device="cpu")
    world = SyntheticStereoWorld(cfg, seed=3)
    gt = forward_trajectory(2, step=0.12)
    mono = TSystem(cfg, sensor="mono", place_rec=pr, device="cpu")
    assert not mono.loop_closer.fix_scale and mono.local_mapper.monocular
    assert mono.tracker.sensor == "mono"
    assert mono.track_monocular(world.render(*gt[0])[0], timestamp=0.0) is None
    assert mono.tracker.state.name == "NOT_INITIALIZED" and mono.tracker._mono_ref is not None
    rgbd = TSystem(cfg, sensor="rgbd", enable_mapping=False, place_rec=pr, device="cpu")
    img, depth = world.render_rgbd(*gt[0])
    assert rgbd.track_rgbd(img, depth, timestamp=0.0) is not None and rgbd.map.n_kf == 1
    rgbd.activate_localization_mode()
    n_mp = int(rgbd.map.next_mp)
    img, depth = world.render_rgbd(*gt[1])
    assert rgbd.track_rgbd(img, depth, timestamp=0.1) is not None
    assert rgbd.map.n_kf == 1 and int(rgbd.map.next_mp) == n_mp
    rgbd.deactivate_localization_mode()
    assert not rgbd.tracker.only_tracking
    sys_ = TSystem(cfg, enable_mapping=False, place_rec=pr, device="cpu")
    assert sys_.place is pr and sys_.tracker.place is pr and sys_.loop_closer is None
    sys_ = TSystem(cfg, enable_loop_closing=False, place_rec=pr, device="cpu")
    assert sys_.local_mapper is not None and sys_.grid_mapper is not None
    assert sys_.loop_closer is None and sys_.local_mapper.loop_closer is None
    assert sys_.occupancy_grid().data.shape == (cfg.gridmap.size_z, cfg.gridmap.size_x)


def test_entry_points_default_to_the_card():
    """System, System.from_map_file (through its keyword arguments) and the
    PlaceRecognition constructors run on the card unless told otherwise;
    without one they raise instead of falling back to the CPU."""
    import inspect

    from orb_slam2_2021_tpu_torch.place.bundle import PACKAGED_VOCAB_SMALL, PlaceRecognition
    from orb_slam2_2021_tpu_torch.place.vocab import BinaryVocabulary

    for fn in (TSystem.__init__, PlaceRecognition.__init__, PlaceRecognition.load_default,
               PlaceRecognition.from_file):
        assert inspect.signature(fn).parameters["device"].default == "cuda", fn
    if torch.cuda.is_available():
        return
    cfg = synthetic_config(width=320, height=240)
    voc = BinaryVocabulary.load(PACKAGED_VOCAB_SMALL)
    for make in (lambda: TSystem(cfg), lambda: TSystem(cfg, enable_mapping=False),
                 lambda: TSystem.from_map_file(cfg, "no_such_map.npz"),
                 lambda: PlaceRecognition.load_default(), lambda: PlaceRecognition(voc),
                 lambda: PlaceRecognition.from_file(PACKAGED_VOCAB_SMALL)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


def test_port_runs_without_jax():
    """Frames through the port's System, mapping off, mapping on, and at the
    reference's defaults (place recognition and loop closing on), in a
    process where importing jax fails; the package must not pull in any
    JAX-using reference module (orb_slam2_2021_tpu.place included)."""
    script = textwrap.dedent("""
        import sys
        sys.modules["jax"] = None
        import numpy as np
        import torch
        torch.set_num_threads(1)
        from orb_slam2_2021_tpu_torch.pipeline.system import System
        from orb_slam2_2021_tpu.config import synthetic_config
        from orb_slam2_2021_tpu.io.synthetic import SyntheticStereoWorld, forward_trajectory
        cfg = synthetic_config(width=320, height=240)
        world = SyntheticStereoWorld(cfg, seed=3)
        s = System(cfg, enable_mapping=False, device="cpu")
        poses = [s.track_stereo(*world.render(R, t), timestamp=0.1 * i)
                 for i, (R, t) in enumerate(forward_trajectory(2, step=0.12))]
        assert all(p is not None for p in poses), poses
        s = System(cfg, enable_mapping=True, enable_loop_closing=False, device="cpu")
        poses = [s.track_stereo(*world.render(R, t), timestamp=0.1 * i)
                 for i, (R, t) in enumerate(forward_trajectory(3, step=0.12))]
        s.shutdown()
        assert all(p is not None for p in poses), poses
        assert (s.occupancy_grid().data == 100).sum() > 0
        # the reference's defaults: packaged vocabulary, loop closing on
        from orb_slam2_2021_tpu_torch.place.bundle import PlaceRecognition
        assert PlaceRecognition.load_default(device="cpu").voc.L == 6
        s = System(cfg, device="cpu")
        poses = [s.track_stereo(*world.render(R, t), timestamp=0.1 * i)
                 for i, (R, t) in enumerate(forward_trajectory(3, step=0.12))]
        s.shutdown()
        assert all(p is not None for p in poses), poses
        assert s.loop_closer is not None and len(s.place.kfdb.bow) == s.map.n_kf == 1
        bad = sorted(m for m in sys.modules if m.startswith("orb_slam2_2021_tpu.")
                     and m.split(".")[1] not in ("config", "mapping", "native", "io"))
        assert not bad, bad
        print("OK")
    """)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    res = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=300)
    assert res.returncode == 0 and res.stdout.strip().endswith("OK"), res.stderr[-3000:]


def test_package_sources_do_not_import_jax():
    pkg = os.path.join(REPO, "orb_slam2_2021_tpu_torch")
    for root, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                src = open(os.path.join(root, f)).read()
                assert "import jax" not in src and "from jax" not in src, f
