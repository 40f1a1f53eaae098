"""The port's chessboard calibrator (`tools/calibration.py`) held against the
JAX package on the CPU.

The host code (board model, corner detection, Zhang's closed form, view
gating, stereo averaging, rectification, YAML) is a copy of the reference's
numpy and must give identical results. The joint LM runs in float32 on
both sides; the two sum in other orders, so on the noise-free views of
tests/test_tools.py::TestCalibration (where the reference reaches an rms of
about 1e-5 px) they agree within K_TOL px on K and the tolerances
below on the rest.
"""

import numpy as np
import pytest
import torch

import test_tools as jtools  # the views of TestCalibration (module, so pytest collects nothing twice)
from orb_slam2_2021_tpu.io import rectify as jrect
from orb_slam2_2021_tpu.tools import calibration as jcal
from orb_slam2_2021_tpu_torch import convert
from orb_slam2_2021_tpu_torch.io import rectify as trect
from orb_slam2_2021_tpu_torch.tools import calibration as tcal

PROJECT_TOL = 1e-4   # px, float32 projection
K_TOL = 5e-3         # px: fx, fy, cx, cy after the LM
DIST_TOL = 1e-4      # distortion coefficients
POSE_TOL = 1e-4      # rotation vectors (rad), translations (m)
RMS_TOL = 1e-4       # px
JAC_TOL = 1e-3       # relative to the Jacobian's largest entry

K_MONO = np.array([[420.0, 0, 320], [0, 430.0, 240], [0, 0, 1]])
DIST_MONO = np.array([-0.12, 0.05, 0, 0, 0])


def _views(K, dist, n_views=8, seed=0):
    return jtools.TestCalibration()._make_views(K, dist, n_views=n_views, seed=seed)


def _stereo_views():
    """The stereo rig of TestCalibration.test_stereo_calibration_and_yaml."""
    K = np.array([[420.0, 0, 320], [0, 420.0, 240], [0, 0, 1]])
    dist = np.zeros(5)
    R_rl = jcal._rodrigues_np(np.array([0.0, 0.02, 0.0]))
    t_rl = np.array([-0.12, 0.0, 0.0])
    obj, views_l, poses = _views(K, dist, seed=3)
    views_r = [jtools._project_np(K, dist, R_rl @ R, R_rl @ t + t_rl, obj) for R, t in poses]
    return views_l, views_r


@pytest.fixture(scope="module")
def mono():
    """(reference result, port result) of the mono solve on the CPU."""
    _, views, _ = _views(K_MONO, DIST_MONO)
    out = []
    for mod, kw in ((jcal, {}), (tcal, {"device": "cpu"})):
        cal = mod.MonoCalibrator(7, 5, 0.03, (640, 480))
        cal.views.extend(views)
        out.append(cal.calibrate(**kw))
    return out


@pytest.fixture(scope="module")
def stereo():
    views_l, views_r = _stereo_views()
    out = []
    for mod, kw in ((jcal, {}), (tcal, {"device": "cpu"})):
        cal = mod.StereoCalibrator(7, 5, 0.03, (640, 480))
        for vl, vr in zip(views_l, views_r):
            cal.add_view(vl, vr)
        out.append(cal.calibrate(**kw))
    return out


def _assert_mono_close(ref, port):
    assert np.abs(port.K - ref.K).max() < K_TOL, (ref.K, port.K)
    assert np.abs(port.dist - ref.dist).max() < DIST_TOL
    assert np.abs(port.rvecs - ref.rvecs).max() < POSE_TOL
    assert np.abs(port.tvecs - ref.tvecs).max() < POSE_TOL
    assert abs(port.rms - ref.rms) < RMS_TOL
    assert port.image_size == ref.image_size


def _chessboard(cols=8, rows=6, sq=40, margin=40):
    """A white-bordered chessboard image with cols x rows inner corners."""
    h, w = (rows + 1) * sq + 2 * margin, (cols + 1) * sq + 2 * margin
    img = np.full((h, w), 255, np.uint8)
    for r in range(rows + 1):
        for c in range(cols + 1):
            if (r + c) % 2 == 0:
                y, x = margin + r * sq, margin + c * sq
                img[y:y + sq, x:x + sq] = 0
    return img


def test_board_points_and_corner_detection_equal_reference():
    assert np.array_equal(tcal.board_points(8, 6, 0.108), jcal.board_points(8, 6, 0.108))
    img = _chessboard()
    ref, port = jcal.find_chessboard_corners(img, 8, 6), tcal.find_chessboard_corners(img, 8, 6)
    assert (ref is None) == (port is None)
    if ref is not None:  # OpenCV present: the same call on both sides
        assert port.shape == (48, 2) and np.array_equal(port, ref)
    blank = np.zeros((100, 120), np.float32)
    assert tcal.find_chessboard_corners(blank, 8, 6) is None


def test_zhang_initialization_equals_reference():
    obj, views, _ = _views(K_MONO, DIST_MONO)
    for v in views[:3]:
        for a, b in zip(tcal._normalize_2d(v), jcal._normalize_2d(v)):
            assert np.array_equal(a, b)
    Hs_t = [tcal.homography_dlt(obj[:, :2], v) for v in views]
    Hs_j = [jcal.homography_dlt(obj[:, :2], v) for v in views]
    assert all(np.array_equal(a, b) for a, b in zip(Hs_t, Hs_j))
    for i, j in ((0, 1), (0, 0), (1, 1)):
        assert np.array_equal(tcal._vij(Hs_t[0], i, j), jcal._vij(Hs_j[0], i, j))
    K_t, K_j = tcal.intrinsics_from_homographies(Hs_t), jcal.intrinsics_from_homographies(Hs_j)
    assert np.array_equal(K_t, K_j)
    for H in Hs_t:
        (Rt, tt), (Rj, tj) = tcal.extrinsics_from_homography(K_t, H), jcal.extrinsics_from_homography(K_j, H)
        assert np.array_equal(Rt, Rj) and np.array_equal(tt, tj)


def test_view_gating_equals_reference():
    _, views, _ = _views(K_MONO, np.zeros(5), n_views=12, seed=5)
    ct = tcal.MonoCalibrator(7, 5, 0.03, (640, 480))
    cj = jcal.MonoCalibrator(7, 5, 0.03, (640, 480))
    for v in views + views[:2]:
        assert np.array_equal(ct.view_params(v), cj.view_params(v))
        assert ct.add_view(v, min_novelty=0.05) == cj.add_view(v, min_novelty=0.05)
    assert len(ct.views) == len(cj.views)
    for n in (3, 10, 20):
        assert ct.good_enough(n) == cj.good_enough(n)


def test_rotation_helpers_and_rectify_equal_reference():
    rng = np.random.default_rng(11)
    rvs = [rng.normal(size=3) * s for s in (0.0, 1e-13, 1e-3, 0.5, 3.0)] + [np.array([np.pi, 0, 0])]
    for rv in rvs:
        R = jcal._rodrigues_np(rv)
        assert np.array_equal(tcal._rodrigues_np(rv), R)
        assert np.array_equal(tcal._rodrigues_inv_np(R), jcal._rodrigues_inv_np(R))
        q = jcal._quat_from_R(R)
        assert np.array_equal(tcal._quat_from_R(R), q)
        assert np.array_equal(tcal._R_from_quat(q), jcal._R_from_quat(q))
    K1 = np.array([[430.0, 0, 318], [0, 431.0, 241], [0, 0, 1]])
    K2 = np.array([[428.0, 0, 322], [0, 429.5, 238], [0, 0, 1]])
    R = jcal._rodrigues_np(np.array([0.01, 0.02, -0.005]))
    for t in (np.array([-0.12, 0.001, 0.002]), np.array([0.12, 0.0, 0.0])):
        for a, b in zip(tcal.stereo_rectify(K1, K2, R, t), jcal.stereo_rectify(K1, K2, R, t)):
            assert np.array_equal(a, b)


def test_stereo_yaml_text_equals_reference(stereo):
    ref, _ = stereo
    port = convert.calibration_from_reference(ref)
    assert isinstance(port, tcal.StereoCalibration) and isinstance(port.left, tcal.MonoCalibration)
    assert tcal.stereo_yaml(port) == jcal.stereo_yaml(ref)
    assert tcal.stereo_yaml(port, fps=30.0, depth_th=35.0) == jcal.stereo_yaml(ref, fps=30.0, depth_th=35.0)
    assert tcal._mat_yaml("X", np.eye(2)) == jcal._mat_yaml("X", np.eye(2))
    # the host half of the stereo solve, from the same two mono results
    again = tcal.stereo_from_monos(port.left, port.right)
    for name in ("R", "t", "R1", "R2", "P1", "P2", "baseline"):
        assert np.array_equal(getattr(again, name), getattr(ref, name)), name


def test_project_matches_jax():
    import jax.numpy as jnp

    rng = np.random.default_rng(2)
    V, M = 6, 35
    obj = np.broadcast_to(jcal.board_points(7, 5, 0.03), (V, M, 3)).astype(np.float32)
    params = np.array([420, 430, 320, 240, -0.12, 0.05, 1e-3, -2e-3, 0.01], np.float32)
    rvecs = rng.uniform(-0.4, 0.4, (V, 3)).astype(np.float32)
    tvecs = np.stack([rng.uniform(-0.08, 0, V), rng.uniform(-0.06, 0, V),
                      rng.uniform(0.35, 0.7, V)], 1).astype(np.float32)
    ref = np.asarray(jcal._project(jnp.asarray(params), jnp.asarray(rvecs), jnp.asarray(tvecs),
                                   jnp.asarray(obj)))
    port = tcal._project(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (params, rvecs, tvecs, obj)))
    assert port.dtype == torch.float32 and port.shape == (V, M, 2)
    assert np.abs(port.numpy() - ref).max() < PROJECT_TOL


def test_lm_jacobian_matches_jax():
    import jax
    import jax.numpy as jnp

    _, views, _ = _views(K_MONO, DIST_MONO, n_views=4)
    cal = tcal.MonoCalibrator(7, 5, 0.03, (640, 480))
    cal.views.extend(views)
    theta0, obj, img = cal.lm_inputs("cpu")
    V = obj.shape[0]

    def jres(theta, obj, img):
        pred = jcal._project(theta[:9], theta[9:9 + 3 * V].reshape(V, 3), theta[9 + 3 * V:].reshape(V, 3), obj)
        return (pred - img).reshape(-1)

    args = [jnp.asarray(a.numpy()) for a in (theta0, obj, img)]
    J_ref = np.asarray(jax.jacfwd(jres)(*args))
    J = torch.func.jacfwd(tcal._residual)(theta0, obj, img).numpy()
    assert J.shape == (2 * V * 35, 9 + 6 * V)
    assert np.abs(J - J_ref).max() < JAC_TOL * np.abs(J_ref).max()
    r_ref = np.asarray(jres(*args))
    assert np.abs(tcal._residual(theta0, obj, img).numpy() - r_ref).max() < PROJECT_TOL


def test_mono_calibrate_matches_jax(mono):
    ref, port = mono
    _assert_mono_close(ref, port)
    assert port.rms < 1e-3 and abs(port.K[0, 0] - 420) < 0.01 and abs(port.dist[0] + 0.12) < 1e-4


def test_stereo_calibrate_matches_jax(stereo):
    ref, port = stereo
    _assert_mono_close(ref.left, port.left)
    _assert_mono_close(ref.right, port.right)
    assert abs(port.baseline - ref.baseline) < POSE_TOL and abs(port.baseline - 0.12) < 1e-3
    for name in ("R", "t", "R1", "R2"):
        assert np.abs(getattr(port, name) - getattr(ref, name)).max() < POSE_TOL, name
    for name in ("P1", "P2"):
        assert np.abs(getattr(port, name) - getattr(ref, name)).max() < K_TOL, name


def test_yaml_to_rectification_chain_equals_reference(stereo, tmp_path):
    """stereo_yaml -> file -> rectification_from_yaml -> maps -> remap."""
    ref, port = stereo
    pj, pt = tmp_path / "ref.yaml", tmp_path / "port.yaml"
    pj.write_text(jcal.stereo_yaml(ref))
    pt.write_text(tcal.stereo_yaml(convert.calibration_from_reference(ref)))
    maps_j, maps_t = jrect.rectification_from_yaml(str(pj)), trect.rectification_from_yaml(str(pt))
    img = np.random.default_rng(4).integers(0, 256, (480, 640), dtype=np.uint8)
    for mj, mt in zip(maps_j, maps_t):
        assert np.array_equal(mt.map_x, mj.map_x) and np.array_equal(mt.map_y, mj.map_y)
        out = trect.remap(img, mt, device="cpu").numpy()
        assert np.abs(out - np.asarray(jrect.remap(img, mj))).max() < 1e-4
    # the port's own solve feeds the same chain
    pt.write_text(tcal.stereo_yaml(port))
    left, right = trect.rectification_from_yaml(str(pt))
    assert left.map_x.shape == (480, 640) and np.isfinite(right.map_y).all()


def test_calibrate_defaults_to_the_card():
    _, views, _ = _views(K_MONO, DIST_MONO, n_views=3)
    cal = tcal.MonoCalibrator(7, 5, 0.03, (640, 480))
    cal.views.extend(views)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA card"):
            cal.calibrate()
    with pytest.raises(ValueError, match=">= 3"):
        tcal.MonoCalibrator(7, 5, 0.03, (640, 480)).calibrate(device="cpu")
