"""The port's map outputs held against the JAX package on the CPU: the
numpy rasterizer and image writers (`viz/draw.py`), the statistical outlier
filter and the offline map processor (`tools/map_processor.py`).

Inputs are made from numpy seeds and fed to both sides. The rasterizer and
the writers are numpy on both sides and must be identical; the filter's
mean kNN distances agree within 1e-5 relative and its masks exactly; the
map processor's PLY and TUM files are byte-identical.
"""

import functools
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_2021_tpu.config import synthetic_config as j_synthetic_config
from orb_slam2_2021_tpu.tools import map_processor as jmp
from orb_slam2_2021_tpu.viz import draw as jdraw
from orb_slam2_2021_tpu_torch.config import synthetic_config
from orb_slam2_2021_tpu_torch.io.synthetic import SyntheticStereoWorld, forward_trajectory
from orb_slam2_2021_tpu_torch.place.bundle import PACKAGED_VOCAB_SMALL, PlaceRecognition
from orb_slam2_2021_tpu_torch.tools import map_processor as tmp
from orb_slam2_2021_tpu_torch.viz import draw as tdraw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOR_RTOL = 1e-5
MAP_FRAMES = 16  # keyframes at frames 0 and 15 (320x240, seed 3, step 0.12 m)
PGM_CELLS_DIFFERING = 0  # the replay of one map file gives the reference's grid


# ----------------------------------------------------------------------
# viz.draw
# ----------------------------------------------------------------------

PRIMITIVES = {
    "text": lambda d, img: d.draw_text(img, "ORB-SLAM2 kf=12 ok: 3.5%", 3, 4, (250, 10, 5)),
    "text_clipped": lambda d, img: d.draw_text(img, "EDGE", 58, 36, (1, 2, 3)),
    "rect": lambda d, img: d.draw_rect(img, 50, 30, 5, -3, (0, 255, 0)),
    "fill_rect": lambda d, img: d.fill_rect(img, -4, 20, 17, 60, (9, 9, 200)),
    "circle": lambda d, img: d.draw_circle(img, 31.4, 22.7, 9, (255, 255, 0)),
    "points": lambda d, img: d.draw_points(
        img, np.random.default_rng(3).uniform(-5, 70, (40, 2)), (200, 0, 200), size=2),
    "line": lambda d, img: d.draw_line(img, -3.2, 5.5, 70.1, 40.9, (17, 34, 51)),
    "lines": lambda d, img: d.draw_lines(
        img, np.random.default_rng(4).uniform(-10, 70, (6, 4)), (90, 180, 45)),
}


@pytest.mark.parametrize("name", sorted(PRIMITIVES))
def test_draw_primitive_same_pixels(name):
    base = np.random.default_rng(1).integers(0, 256, (44, 64, 3), dtype=np.uint8)
    a, b = base.copy(), base.copy()
    PRIMITIVES[name](jdraw, a)
    PRIMITIVES[name](tdraw, b)
    assert np.array_equal(a, b) and not np.array_equal(b, base)


@pytest.mark.parametrize("writer,shape", [("write_png", (20, 30, 3)), ("write_png", (20, 30)),
                                          ("write_pgm", (21, 33))])
def test_image_writers_same_bytes(tmp_path, writer, shape):
    img = np.random.default_rng(2).integers(0, 256, shape, dtype=np.uint8)
    getattr(jdraw, writer)(str(tmp_path / "ref"), img)
    getattr(tdraw, writer)(str(tmp_path / "port"), img)
    assert (tmp_path / "ref").read_bytes() == (tmp_path / "port").read_bytes()


# ----------------------------------------------------------------------
# statistical outlier filter
# ----------------------------------------------------------------------

def _reference_mean_knn(points, k):
    """The reference's distances: the jitted body of
    orb_slam2_2021_tpu/tools/map_processor.py:38-54, verbatim (the
    reference returns only the mask)."""
    @functools.partial(jax.jit, static_argnums=(1,))
    def mean_knn_dist(p, kk):
        sq = jnp.sum(p * p, axis=1)
        d2 = sq[:, None] + sq[None, :] - 2.0 * (p @ p.T)
        d2 = jnp.maximum(d2, 0.0).at[jnp.arange(p.shape[0]), jnp.arange(p.shape[0])].set(jnp.inf)
        neg_top, _ = jax.lax.top_k(-d2, kk)
        return jnp.mean(jnp.sqrt(-neg_top), axis=1)

    return np.asarray(mean_knn_dist(np.asarray(points, np.float32), k))


def _cloud(kind):
    rng = np.random.default_rng(0)
    if kind == "reference_test":  # tests/test_tools.py: 200 points, one gross outlier
        cloud = rng.normal(0, 1.0, (200, 3)).astype(np.float32)
        cloud[0] = [50.0, 50.0, 50.0]
        return cloud, 10
    cloud = (rng.normal(0, 1.0, (2000, 3)) * [4.0, 1.0, 2.5]).astype(np.float32)
    cloud[:20] = rng.uniform(-40, 40, (20, 3))  # sparse outliers
    return cloud, 50


@pytest.mark.parametrize("kind", ["reference_test", "seeded_2000"])
def test_sor_matches_reference(kind):
    cloud, k = _cloud(kind)
    ref = _reference_mean_knn(cloud, k)
    port = tmp.mean_knn_distances(torch.from_numpy(cloud), k).numpy()
    assert port.dtype == np.float32
    np.testing.assert_allclose(port, ref, rtol=SOR_RTOL, atol=0)
    keep = tmp.statistical_outlier_filter(cloud, k, 1.0, device="cpu")
    assert np.array_equal(keep, jmp.statistical_outlier_filter(cloud, k, 1.0))
    if kind == "reference_test":
        assert not keep[0] and keep[1:].mean() > 0.8


@pytest.mark.parametrize("rows", [1, 7, "N"])
def test_sor_blocks_give_one_blocks_result(rows):
    cloud, k = _cloud("seeded_2000")
    p = torch.from_numpy(cloud)
    one = tmp.mean_knn_distances(p, k, block_rows=len(cloud))
    b = len(cloud) if rows == "N" else rows
    assert torch.equal(tmp.mean_knn_distances(p, k, block_rows=b), one)


def test_sor_block_rows_follow_the_byte_budget():
    n = 487_556
    b = tmp.sor_block_rows(n)
    assert b * n * 4 <= tmp.SOR_BLOCK_BYTES < (b + 1) * n * 4
    assert tmp.sor_block_rows(10) == 10 and tmp.sor_block_rows(10 ** 10) == 1


def test_sor_small_inputs():
    assert tmp.statistical_outlier_filter(np.zeros((0, 3)), device="cpu").shape == (0,)
    assert tmp.statistical_outlier_filter(np.zeros((1, 3)), device="cpu").tolist() == [True]
    pts = np.random.default_rng(3).normal(0, 1, (5, 3))
    assert np.array_equal(tmp.statistical_outlier_filter(pts, 50, device="cpu"),
                          jmp.statistical_outlier_filter(pts, 50))


# ----------------------------------------------------------------------
# map processor
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def saved_map(tmp_path_factory):
    """A map file the port's CPU System (320x240, mapping on) saved after
    MAP_FRAMES frames."""
    from orb_slam2_2021_tpu_torch.pipeline.system import System

    cfg = synthetic_config(width=320, height=240)
    world = SyntheticStereoWorld(cfg, seed=3)
    sys_ = System(cfg, enable_loop_closing=False, device="cpu",
                  place_rec=PlaceRecognition.from_file(PACKAGED_VOCAB_SMALL, "cpu"))
    for i, (R, t) in enumerate(forward_trajectory(MAP_FRAMES, step=0.12)):
        sys_.track_stereo(*world.render(R, t), timestamp=0.1 * i)
    sys_.shutdown()
    path = str(tmp_path_factory.mktemp("map") / "map.npz")
    sys_.save_map(path)
    return path, int(sys_.map.n_kf), int(sys_.map.mp_valid.sum())


def test_map_processor_outputs_equal_reference(saved_map, tmp_path):
    path, n_kf, n_mp = saved_map
    assert n_kf >= 2 and n_mp > 200
    ref = jmp.MapProcessor(path, j_synthetic_config(width=320, height=240))
    port = tmp.MapProcessor(path, synthetic_config(width=320, height=240), device="cpu")
    files = {}
    for side, mp in (("ref", ref), ("port", port)):
        d = tmp_path / side
        d.mkdir()
        mp.save_point_cloud_ply(str(d / "pc.ply"), filtered=False)
        mp.save_point_cloud_ply(str(d / "pc_filtered.ply"))
        mp.save_trajectory_tum(str(d / "kf.txt"))
        grid = mp.save_grid_map_pgm(str(d / "g.pgm"))
        files[side] = {f: (d / f).read_bytes() for f in ("pc.ply", "pc_filtered.ply", "kf.txt")}
        files[side]["grid"] = grid
        files[side]["pgm"] = (d / "g.pgm").read_bytes()
    r, p = files["ref"], files["port"]
    assert p["pc.ply"] == r["pc.ply"] and f"element vertex {n_mp}\n".encode() in p["pc.ply"]
    assert p["pc_filtered.ply"] == r["pc_filtered.ply"]
    assert p["kf.txt"] == r["kf.txt"] and len(p["kf.txt"].splitlines()) == n_kf
    header = b"P5\n1024 1024\n255\n"
    assert p["pgm"].startswith(header) and len(p["pgm"]) == len(header) + 1024 * 1024
    pix_p = np.frombuffer(p["pgm"][len(header):], np.uint8)
    pix_r = np.frombuffer(r["pgm"][len(header):], np.uint8)
    assert int((pix_p != pix_r).sum()) == PGM_CELLS_DIFFERING
    assert set(np.unique(pix_p)) <= {0, 205, 254} and (pix_p == 0).sum() > 0
    assert np.array_equal(p["grid"].data, r["grid"].data)


def test_map_processor_defaults_to_the_card(saved_map):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tmp.MapProcessor(saved_map[0])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        tmp.statistical_outlier_filter(np.zeros((4, 3), np.float32))


def _default_config_map(path):
    """A map file at the port's SlamConfig() defaults, which the CLI reads
    (as tests/test_tools.py builds one): 300 points ahead of two
    keyframes."""
    from orb_slam2_2021_tpu_torch.config import SlamConfig
    from orb_slam2_2021_tpu_torch.io.persistence import save_map
    from orb_slam2_2021_tpu_torch.mapping.map_store import MapStore

    cfg = SlamConfig()
    m = MapStore(cfg)
    rng = np.random.default_rng(0)
    pos = rng.uniform(-3, 3, (300, 3)).astype(np.float32)
    pos[:, 2] += 5
    ids = m.add_map_points_batch(pos, rng.integers(0, 2 ** 32, (300, 8), dtype=np.uint32), first_kf=0)
    N = cfg.orb.n_features
    for k, tz in enumerate((0.0, -0.5)):
        bind = np.full(N, -1, np.int64)
        bind[: len(ids)] = ids
        m.add_keyframe(np.eye(3, dtype=np.float32), np.array([0, 0, tz], np.float32),
                       rng.uniform(0, 300, (N, 2)).astype(np.float32), np.full(N, -1.0, np.float32),
                       np.full(N, -1.0, np.float32), np.zeros(N, np.int32), np.zeros(N, np.float32),
                       np.zeros((N, 8), np.uint32), np.ones(N, bool), bind, k, 0.1 * k)
    save_map(path, m)


def test_map_processor_main_writes_three_files(tmp_path):
    path = str(tmp_path / "map.npz")
    _default_config_map(path)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="2")
    out = tmp_path / "out"
    cmd = [sys.executable, "-m", "orb_slam2_2021_tpu_torch.tools.map_processor", path, str(out),
           "--device", "cpu"]
    res = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "loaded map: 2 keyframes, 300 map points" in res.stdout
    for f in ("pointcloud.ply", "kf_trajectory_tum.txt", "gridmap.pgm"):
        assert (out / f).stat().st_size > 0, f
    assert len((out / "kf_trajectory_tum.txt").read_text().splitlines()) == 2
    ref_out = tmp_path / "ref"
    jmp.main([path, str(ref_out)])
    for f in ("pointcloud.ply", "kf_trajectory_tum.txt", "gridmap.pgm"):
        assert (out / f).read_bytes() == (ref_out / f).read_bytes(), f


def test_map_processor_main_reads_any_configs_map(saved_map, tmp_path):
    """The CLI takes the keyframe width from the file: a 320x240 map (512
    features) goes through as a SlamConfig() one (2000) would."""
    from orb_slam2_2021_tpu_torch.tools.map_processor import main

    main([saved_map[0], str(tmp_path), "--device", "cpu"])
    rows = (tmp_path / "kf_trajectory_tum.txt").read_text().splitlines()
    assert len(rows) == saved_map[1] and (tmp_path / "gridmap.pgm").stat().st_size > 1024 * 1024
