"""The port's own copies of the reference's host code (config, map store,
native map-store kernels, synthetic worlds, trajectory metrics, map files)
held against the reference on the CPU.

Everything compared here is plain Python and numpy on both sides, so the
comparisons are exact (tolerance 0) except where stated.
"""

import dataclasses

import numpy as np
import pytest

from orb_slam2_2021_tpu import config as jconfig
from orb_slam2_2021_tpu.io import persistence as jpersist
from orb_slam2_2021_tpu.io import synthetic as jsyn
from orb_slam2_2021_tpu.io.trajectory import ate_rmse as j_ate
from orb_slam2_2021_tpu.mapping.map_store import MapStore as JMapStore
from orb_slam2_2021_tpu_torch import config as tconfig
from orb_slam2_2021_tpu_torch import native as tnative
from orb_slam2_2021_tpu_torch.convert import config_from_reference, map_store_from_reference
from orb_slam2_2021_tpu_torch.io import persistence as tpersist
from orb_slam2_2021_tpu_torch.io import synthetic as tsyn
from orb_slam2_2021_tpu_torch.io.trajectory import ate_rmse as t_ate
from orb_slam2_2021_tpu_torch.mapping.map_store import MapStore as TMapStore

CONFIGS = [("synthetic_config", dict(width=320, height=240)), ("kitti_stereo_config", {})]


def _fields(cfg):
    """Every field of a config tree, nested configs as dicts."""
    return dataclasses.asdict(cfg)


@pytest.mark.parametrize("name,kw", CONFIGS)
def test_config_matches_reference_field_by_field(name, kw):
    ref = getattr(jconfig, name)(**kw)
    port = getattr(tconfig, name)(**kw)
    assert type(port).__module__ == "orb_slam2_2021_tpu_torch.config"
    assert _fields(port) == _fields(ref), "same field names, defaults and values"
    conv = config_from_reference(ref)
    assert type(conv) is tconfig.SlamConfig and conv == port
    assert type(conv.orb) is tconfig.OrbConfig


def _poses(kind):
    if kind == "stereo":
        return tsyn.forward_trajectory(3, step=0.3, yaw_rate=0.02), jsyn.forward_trajectory(3, step=0.3, yaw_rate=0.02)
    return tsyn.orbit_trajectory(3, total_deg=90.0), jsyn.orbit_trajectory(3, total_deg=90.0)


@pytest.mark.parametrize("seed", [3, 11])
@pytest.mark.parametrize("kind", ["stereo", "cylinder"])
def test_synthetic_worlds_render_byte_identical(kind, seed):
    cfg_t, cfg_j = tconfig.synthetic_config(320, 240), jconfig.synthetic_config(320, 240)
    cls = "SyntheticStereoWorld" if kind == "stereo" else "SyntheticCylinderWorld"
    world_t, world_j = getattr(tsyn, cls)(cfg_t, seed=seed), getattr(jsyn, cls)(cfg_j, seed=seed)
    poses_t, poses_j = _poses(kind)
    for (Rt, tt), (Rj, tj) in zip(poses_t, poses_j):
        assert np.array_equal(Rt, Rj) and np.array_equal(tt, tj), "trajectories: tolerance 0"
        for a, b in zip(world_t.render(Rt, tt), world_j.render(Rj, tj)):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), "renders: byte for byte"


@pytest.mark.parametrize("with_scale", [False, True])
def test_ate_rmse_matches_reference(with_scale):
    rng = np.random.default_rng(4)
    gt, est = [], []
    for i in range(20):
        T = np.eye(4)
        T[:3, 3] = [0.1 * i, 0.02 * np.sin(i), 0.3 * i]
        gt.append(T)
        E = T.copy()
        E[:3, 3] = 1.3 * T[:3, 3] + rng.normal(0, 0.05, 3)
        est.append(E)
    assert t_ate(est, gt, with_scale=with_scale) == j_ate(est, gt, with_scale=with_scale)


def _filled_store(cls, cfg, rng):
    """A store with 3 keyframes and 60 points, written field by field (no
    map-store logic runs), so a save/load round trip sees every field."""
    m = cls(cfg)
    K, M, N = 3, 60, cfg.orb.n_features
    for f in jpersist._KF_FIELDS:
        arr = getattr(m, f)
        if f == "covis":
            arr[:K, :K] = rng.integers(0, 50, (K, K))
        elif arr.dtype == bool:
            arr[:K] = rng.random(arr[:K].shape) < 0.5
        else:
            arr[:K] = rng.integers(0, 1000, arr[:K].shape).astype(arr.dtype)
    for f in jpersist._MP_FIELDS:
        arr = getattr(m, f)
        if arr.dtype == bool:
            arr[:M] = rng.random(arr[:M].shape) < 0.8
        else:
            arr[:M] = rng.integers(-1, 1000, arr[:M].shape).astype(arr.dtype)
    m.next_kf, m.next_mp, m.n_kf, m.big_change_idx = K, M, K, 2
    m.children = {0: {1, 2}}
    m.loop_edges = {0: {2}, 2: {0}}
    assert N > 0
    return m


def _assert_same_store(a, b):
    for f in jpersist._KF_FIELDS + jpersist._MP_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    for f in ("next_kf", "next_mp", "n_kf", "big_change_idx", "children", "loop_edges", "obs_cap"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_map_file_loads_in_the_other_package(tmp_path, direction):
    rng = np.random.default_rng(5)
    cfg_j = jconfig.synthetic_config(320, 240)
    cfg_t = config_from_reference(cfg_j)
    path = str(tmp_path / "map.npz")
    if direction == "reference_to_port":
        src = _filled_store(JMapStore, cfg_j, rng)
        jpersist.save_map(path, src, next_frame_id=17)
        out, next_id = tpersist.load_map(path, cfg_t)
        assert isinstance(out, TMapStore)
    else:
        src = _filled_store(TMapStore, cfg_t, rng)
        tpersist.save_map(path, src, next_frame_id=17)
        out, next_id = jpersist.load_map(path, cfg_j)
        assert isinstance(out, JMapStore)
    assert next_id == 17
    _assert_same_store(src, out)


def test_map_store_from_reference_copies_everything():
    rng = np.random.default_rng(6)
    src = _filled_store(JMapStore, jconfig.synthetic_config(320, 240), rng)
    out = map_store_from_reference(src)
    assert isinstance(out, TMapStore) and type(out.cfg) is tconfig.SlamConfig
    _assert_same_store(src, out)
    out.kf_R[0] += 1.0
    out.children[0].add(7)
    assert not np.array_equal(out.kf_R[0], src.kf_R[0]) and 7 not in src.children[0], "copies"


def _drive_store(cfg):
    """One map-store update through the native-backed entry points: 80
    points, then three keyframes binding overlapping subsets of them
    (observations, covisibility), then the per-point statistics."""
    rng = np.random.default_rng(7)
    m = TMapStore(cfg)
    N = cfg.orb.n_features
    ids = m.add_map_points_batch(rng.normal(0, 3, (80, 3)).astype(np.float32) + [0, 0, 10],
                                 rng.integers(0, 2 ** 32, (80, 8), dtype=np.uint32), 0)
    for k in range(3):
        bind = np.full(N, -1, np.int64)
        feats = rng.choice(N, 50, replace=False)
        bind[feats] = ids[rng.choice(80, 50, replace=False)]
        R = np.eye(3, dtype=np.float32)
        t = np.array([0.2 * k, 0, 0], np.float32)
        m.add_keyframe(R, t, rng.uniform(0, 320, (N, 2)).astype(np.float32),
                       np.full(N, -1, np.float32), np.full(N, -1, np.float32),
                       rng.integers(0, cfg.orb.n_levels, N).astype(np.int32),
                       rng.uniform(-np.pi, np.pi, N).astype(np.float32),
                       rng.integers(0, 2 ** 32, (N, 8), dtype=np.uint32),
                       np.ones(N, bool), bind, frame_id=k, timestamp=0.1 * k)
    m.update_point_stats(ids)
    return m


def test_native_build_matches_numpy_path(monkeypatch):
    assert tnative.HAVE_NATIVE, "the port's map-store kernels build with g++ into _build/"
    assert "orb_slam2_2021_tpu_torch" in tnative._lib_path() and "_build" in tnative._lib_path()
    cfg = tconfig.synthetic_config(320, 240)
    native = _drive_store(cfg)
    monkeypatch.setattr(tnative, "HAVE_NATIVE", False)
    plain = _drive_store(cfg)
    for f in jpersist._KF_FIELDS + jpersist._MP_FIELDS:
        x, y = getattr(native, f), getattr(plain, f)
        if x.dtype.kind == "f" and f in ("mp_normal", "mp_min_dist", "mp_max_dist"):
            # float32 sums in another order in C++ than in numpy
            np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-6, err_msg=f)
        else:
            assert np.array_equal(x, y), f
