"""The RGB-D and monocular paths and localization mode of the PyTorch port
against the JAX reference on the CPU at 320x240: the RGB-D and monocular
frame builds on rendered frames, the single-image extractor against the
stereo batch, the TUM trajectory writer, and the three Systems over short
rendered sequences (synchronous, local mapping on, loop closing off, both
given the small packaged vocabulary: with loop closing off no keyframe
enters either keyframe database, so relocalization falls back to the
reference-keyframe search on both sides)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_2021_tpu.config import synthetic_config
from orb_slam2_2021_tpu.frontend import frame as jframe
from orb_slam2_2021_tpu.io.synthetic import SyntheticStereoWorld, forward_trajectory
from orb_slam2_2021_tpu.io.trajectory import save_tum as j_save_tum
from orb_slam2_2021_tpu_torch.convert import config_from_reference, desc_to_numpy
from orb_slam2_2021_tpu_torch.frontend import features as tfeat
from orb_slam2_2021_tpu_torch.frontend import frame as tframe
from orb_slam2_2021_tpu_torch.io.trajectory import save_tum
from orb_slam2_2021_tpu_torch.pipeline.system import System as TSystem
from test_torch_two_view import reference_samples

torch.set_num_threads(1)

LENS = (0.25, -0.15, -0.002, 0.001, 0.0)  # the synthetic lens of tests/test_undistort.py
DEPTH_FACTOR = 5000.0                      # TUM's DepthMapFactor
CFG = synthetic_config(width=320, height=240)
RGBD_CFG = CFG.replace(dist_coef=LENS, depth_map_factor=DEPTH_FACTOR)


def _rgbd_frames(cfg, n, seed, lens):
    world = SyntheticStereoWorld(cfg, seed=seed)
    out = []
    for R, t in forward_trajectory(n, step=0.12):
        img, depth = world.render_rgbd(R, t, dist_coef=lens)
        out.append((img, (depth * DEPTH_FACTOR).astype(np.float32)))
    return out


def _systems(sensor, cfg, **kw):
    """The reference and the port System, mapping on and loop closing off,
    both with the small packaged vocabulary."""
    from orb_slam2_2021_tpu.pipeline.system import System as JSystem
    from orb_slam2_2021_tpu.place.bundle import PACKAGED_VOCAB_SMALL, PlaceRecognition as JPR
    from orb_slam2_2021_tpu.place.vocab import BinaryVocabulary as JVoc
    from orb_slam2_2021_tpu_torch.place.bundle import PlaceRecognition as TPR
    from orb_slam2_2021_tpu_torch.place.vocab import BinaryVocabulary as TVoc

    ref = JSystem(cfg, enable_loop_closing=False, sensor=sensor,
                  place_rec=JPR(JVoc.load(PACKAGED_VOCAB_SMALL)), **kw)
    port = TSystem(config_from_reference(cfg), enable_loop_closing=False, sensor=sensor,
                   place_rec=TPR(TVoc.load(PACKAGED_VOCAB_SMALL), device="cpu"), device="cpu", **kw)
    return ref, port


def _pose_diff(pt, pr):
    return max(float(np.abs(pt[1] - pr[1]).max()), float(np.abs(pt[0] - pr[0]).max()))


# ---------------------------------------------------------------- frames
@pytest.fixture(scope="module")
def rgbd_frame():
    return _rgbd_frames(RGBD_CFG, 3, 4, LENS)[2]


def test_rgbd_frame_matches_reference(rgbd_frame):
    """Identical keypoint slots (raw coordinates and validity), undistorted
    coordinates within 1e-4 px, u_right and depth within 1e-4."""
    img, depth = rgbd_frame
    scale = 1.0 / DEPTH_FACTOR
    ref = jax.jit(jframe.build_rgbd_frame, static_argnums=(2, 3))(
        jnp.asarray(img), jnp.asarray(depth), RGBD_CFG, scale)
    cfg = config_from_reference(RGBD_CFG)
    out = tframe.build_rgbd_frame(torch.from_numpy(img), torch.from_numpy(depth), cfg, scale)
    raw = tframe.extract_orb(torch.from_numpy(img), cfg.orb)
    v_r, v_t = np.asarray(ref.kp.valid), out.kp.valid.numpy()
    assert np.array_equal(v_r, v_t) and v_r.sum() > 0.9 * cfg.orb.n_features
    assert np.array_equal(np.asarray(ref.kp.octave), out.kp.octave.numpy())
    raw_r = np.asarray(jax.jit(jframe.extract_orb, static_argnums=1)(jnp.asarray(img), RGBD_CFG.orb).xy)
    assert np.array_equal(raw_r, raw.xy.numpy()), "raw keypoint coordinates identical"
    assert np.abs(np.asarray(ref.kp.xy) - out.kp.xy.numpy()).max() < 1e-4
    assert np.abs(np.asarray(ref.kp.xy) - raw_r).max() > 1.0, "the lens moved the keypoints"
    d_r, d_t = np.asarray(ref.depth), out.depth.numpy()
    assert np.array_equal(d_r > 0, d_t > 0) and (d_r > 0).sum() > 0.9 * v_r.sum()
    assert np.abs(d_t - d_r).max() < 1e-4, "depth: tolerance 1e-4 m"
    assert np.abs(out.u_right.numpy() - np.asarray(ref.u_right)).max() < 1e-4, "u_right: 1e-4 px"
    same_desc = (np.asarray(ref.kp.desc) == desc_to_numpy(out.kp.desc)).all(1).mean()
    assert same_desc > 0.97, f"descriptors: >= 97% identical, got {same_desc:.4f}"


def test_mono_frame_matches_reference(rgbd_frame):
    img, _ = rgbd_frame
    ref = jax.jit(jframe.build_mono_frame, static_argnums=1)(jnp.asarray(img), RGBD_CFG)
    out = tframe.build_mono_frame(torch.from_numpy(img), config_from_reference(RGBD_CFG))
    assert np.array_equal(np.asarray(ref.kp.valid), out.kp.valid.numpy())
    assert np.abs(np.asarray(ref.kp.xy) - out.kp.xy.numpy()).max() < 1e-4
    for x in (out.u_right, out.depth, out.sad_dist):
        assert x.shape == (CFG.orb.n_features,) and bool((x == -1).all())


def test_single_image_extraction_matches_the_stereo_batch(rgbd_frame):
    """extract_orb at B = 1 gives the keypoints of the left half of the
    batch-2 stereo build, exactly."""
    world = SyntheticStereoWorld(CFG, seed=3)
    left, right = world.render(*forward_trajectory(2, step=0.12)[1])
    pair = torch.from_numpy(np.stack([left, right]))
    kp2, _ = tfeat.extract_orb_batched(pair, CFG.orb)
    kp1 = tfeat.extract_orb(pair[0], CFG.orb)
    for f in kp1._fields:
        assert torch.equal(getattr(kp1, f), getattr(kp2, f)[0]), f


def test_save_tum_matches_reference(tmp_path):
    """The same stamped poses written by both packages give the same text:
    rotations of every quaternion branch (trace-dominant and each diagonal
    entry dominant, angles up to 179 degrees)."""
    from scipy.spatial.transform import Rotation

    rng = np.random.default_rng(5)
    rots = list(Rotation.random(40, random_state=7).as_matrix())
    rots += [Rotation.from_rotvec(np.deg2rad(179.0) * a).as_matrix() for a in np.eye(3)]
    stamped = []
    for i, R in enumerate(rots):
        T = np.eye(4, dtype=np.float32)
        T[:3, :3], T[:3, 3] = R, rng.normal(0, 3, 3)
        stamped.append((0.1 * i + 1e-3, T))
    j_save_tum(str(tmp_path / "ref.txt"), stamped)
    save_tum(str(tmp_path / "port.txt"), stamped)
    ref, got = (tmp_path / "ref.txt").read_text(), (tmp_path / "port.txt").read_text()
    assert len(got.splitlines()) == len(stamped) and got == ref


# ---------------------------------------------------------------- systems
def test_rgbd_system_matches_reference():
    """12 frames through a lens, depth in DepthMapFactor units: identical
    tracked flags, states, keyframes and map-point counts, poses within
    1 mm (measured 1.5e-4); the TUM trajectories agree to the same
    tolerance."""
    frames = _rgbd_frames(RGBD_CFG, 12, 4, LENS)
    ref, port = _systems("rgbd", RGBD_CFG)
    worst = 0.0
    for i, (img, depth) in enumerate(frames):
        pr = ref.track_rgbd(img, depth, timestamp=0.1 * i)
        pt = port.track_rgbd(img, depth, timestamp=0.1 * i)
        assert (pr is None) == (pt is None), f"frame {i}: tracked flags differ"
        assert port.map.n_kf == ref.map.n_kf, f"frame {i}: keyframe counts differ"
        assert int(port.map.mp_valid.sum()) == int(ref.map.mp_valid.sum()), f"frame {i}: map points"
        if pr is not None:
            worst = max(worst, _pose_diff(pt, pr))
    ref.shutdown()
    port.shutdown()
    assert worst < 1e-3, f"poses differ by {worst:.2e} (tolerance 1 mm / 1e-3)"
    assert [m["state"] for m in port.metrics] == [m["state"] for m in ref.metrics]
    assert [m["keyframe"] for m in port.metrics] == [m["keyframe"] for m in ref.metrics]
    tt, tr = port.trajectory_tum(), ref.trajectory_tum()
    assert [s for s, _ in tt] == [s for s, _ in tr] and len(tt) == len(frames)
    assert max(np.abs(a - b).max() for (_, a), (_, b) in zip(tt, tr)) < 1e-3


def test_mono_system_matches_reference():
    """16 frames, the reference's two-view minimal sets injected into the
    port: the same initialization frame (6), keyframes and map-point
    counts, tracked flags and states; poses (at the map's own scale) within
    1e-3 (measured 2.9e-6)."""
    world = SyntheticStereoWorld(CFG, seed=9)
    images = [world.render(R, t)[0] for R, t in forward_trajectory(16, step=0.12)]
    ref, port = _systems("mono", CFG)
    port.tracker.init_sampler = lambda valid, frame_id: torch.from_numpy(
        reference_samples(jax.random.PRNGKey(frame_id), valid).astype(np.int64))
    worst, init = 0.0, None
    for i, img in enumerate(images):
        pr = ref.track_monocular(img, timestamp=0.1 * i)
        pt = port.track_monocular(img, timestamp=0.1 * i)
        assert (pr is None) == (pt is None), f"frame {i}: tracked flags differ"
        assert port.map.n_kf == ref.map.n_kf, f"frame {i}: keyframe counts differ"
        assert int(port.map.mp_valid.sum()) == int(ref.map.mp_valid.sum()), f"frame {i}: map points"
        if pr is not None:
            init = i if init is None else init
            worst = max(worst, _pose_diff(pt, pr))
    ref.shutdown()
    port.shutdown()
    assert init is not None and init <= 12, f"initialized at frame {init}"
    assert port.map.next_kf >= 3, "mapping inserted keyframes after the two-view pair"
    assert worst < 1e-3, f"poses differ by {worst:.2e} (tolerance 1e-3)"
    assert [m["state"] for m in port.metrics] == [m["state"] for m in ref.metrics]
    assert [m["keyframe"] for m in port.metrics] == [m["keyframe"] for m in ref.metrics]


def test_localization_mode_matches_reference():
    """Stereo, as tests/test_tracking_modes.py: 10 mapped frames, then
    localization mode with all but 8 map points hidden for 8 frames (VO
    points carry the pose), then the map back and 4 frames of a revisit:
    identical vo_mode and tracked flags per frame, no keyframe or map point
    added, poses within 1 mm (measured 2.6e-4)."""
    world = SyntheticStereoWorld(CFG, seed=3)
    gt = forward_trajectory(18, step=0.12)
    ref, port = _systems("stereo", CFG)
    for i in range(10):
        pr = ref.track_stereo(*world.render(*gt[i]), timestamp=0.1 * i)
        pt = port.track_stereo(*world.render(*gt[i]), timestamp=0.1 * i)
        assert (pr is None) == (pt is None)
    n_kf, n_mp = ref.map.next_kf, ref.map.next_mp
    assert (port.map.next_kf, port.map.next_mp) == (n_kf, n_mp)
    ref.activate_localization_mode()
    port.activate_localization_mode()
    saved = ref.map.mp_valid.copy()
    assert np.array_equal(saved, port.map.mp_valid)
    hide = np.nonzero(saved)[0][8:]
    ref.map.mp_valid[hide] = False
    port.map.mp_valid[hide] = False
    vo, worst = [], 0.0
    poses = [(i, gt[i]) for i in range(10, 18)] + [(i, gt[i]) for i in range(4, 8)]
    for j, (i, pose) in enumerate(poses):
        if j == 8:
            ref.map.mp_valid[:] = saved
            port.map.mp_valid[:] = saved
        pr = ref.track_stereo(*world.render(*pose), timestamp=1.0 + 0.1 * j)
        pt = port.track_stereo(*world.render(*pose), timestamp=1.0 + 0.1 * j)
        assert (pr is None) == (pt is None), f"localization frame {j}: tracked flags differ"
        assert port.tracker.vo_mode == ref.tracker.vo_mode, f"localization frame {j}: vo_mode"
        vo.append(port.tracker.vo_mode)
        if pr is not None:
            worst = max(worst, _pose_diff(pt, pr))
    ref.shutdown()
    port.shutdown()
    assert any(vo[:8]), "VO mode never engaged while the map was hidden"
    assert not vo[-1], "VO mode did not end after the map came back"
    assert (port.map.next_kf, port.map.next_mp) == (n_kf, n_mp), "localization mode added to the map"
    assert worst < 1e-3, f"poses differ by {worst:.2e} (tolerance 1 mm / 1e-3)"
