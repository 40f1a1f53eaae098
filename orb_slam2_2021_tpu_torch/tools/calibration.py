"""Camera calibration: a chessboard mono and stereo calibrator (counterpart
of orb_slam2_2021_tpu/tools/calibration.py).

Covers the upstream ROS calibrator (calibrator.py): monocular intrinsics and
distortion from chessboard views (MonoCalibrator), stereo extrinsics and
rectification (StereoCalibrator), sample-coverage gating, and YAML in the
engine's settings schema (Camera.fx/fy/cx/cy, LEFT./RIGHT. K, D, R, P).

The closed-form start (Zhang 2000: DLT homographies, B-matrix intrinsics,
per-view extrinsics), the stereo averaging, Bouguet rectification and the
YAML are the reference's numpy, copied as host code. The joint
reprojection refinement is a Levenberg-Marquardt over every view and corner
on the device: 9 intrinsics plus 6 pose parameters per view, a dense
forward-mode Jacobian, Marquardt damping, accept and reject by
`torch.where`, so the fixed iterations run without a host sync and the
result comes back in one copy. Corner detection is input: pass pixel
corners, or use `find_chessboard_corners`, which needs OpenCV.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..geometry.so3 import so3_hat

# The LM's dtype. float32 is the reference's (the parity tests hold it).
# chip_smoke.py phase 24 holds the card's float32 solve against the CPU's
# float64 one: 8.9e-3 px apart on K for 60 noisy views on an H100, within
# its 0.05 px tolerance, so float32 stays.
CALIB_DTYPE = torch.float32


# ----------------------------------------------------------------------
# board model
# ----------------------------------------------------------------------

def board_points(cols: int, rows: int, square_size: float) -> np.ndarray:
    """[M, 3] chessboard inner-corner model points (z = 0)."""
    xs, ys = np.meshgrid(np.arange(cols), np.arange(rows))
    pts = np.stack([xs.ravel(), ys.ravel(), np.zeros(cols * rows)], axis=1)
    return (pts * square_size).astype(np.float64)


def find_chessboard_corners(image: np.ndarray, cols: int, rows: int):
    """Detect inner corners ([M, 2] float64, or None). Needs OpenCV, as the
    upstream calibrator does; without it, None."""
    try:
        import cv2
    except ImportError:
        return None
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = np.clip(img, 0, 255).astype(np.uint8)
    ok, corners = cv2.findChessboardCorners(img, (cols, rows))
    if not ok:
        return None
    corners = cv2.cornerSubPix(
        img, corners, (5, 5), (-1, -1),
        (cv2.TERM_CRITERIA_EPS + cv2.TERM_CRITERIA_MAX_ITER, 30, 0.01),
    )
    return corners.reshape(-1, 2).astype(np.float64)


# ----------------------------------------------------------------------
# Zhang closed-form initialization (host, small dense linear algebra)
# ----------------------------------------------------------------------

def _normalize_2d(pts):
    mu = pts.mean(axis=0)
    sd = pts.std(axis=0).mean() + 1e-12
    T = np.array([[1 / sd, 0, -mu[0] / sd], [0, 1 / sd, -mu[1] / sd], [0, 0, 1.0]])
    ph = np.concatenate([pts, np.ones((len(pts), 1))], axis=1)
    return (T @ ph.T).T[:, :2], T


def homography_dlt(obj_xy: np.ndarray, img_xy: np.ndarray) -> np.ndarray:
    """Normalized DLT homography board-plane -> image, [3, 3]."""
    a, Ta = _normalize_2d(obj_xy)
    b, Tb = _normalize_2d(img_xy)
    n = len(a)
    A = np.zeros((2 * n, 9))
    A[0::2, 0:2] = a
    A[0::2, 2] = 1
    A[0::2, 6:8] = -b[:, 0:1] * a
    A[0::2, 8] = -b[:, 0]
    A[1::2, 3:5] = a
    A[1::2, 5] = 1
    A[1::2, 6:8] = -b[:, 1:2] * a
    A[1::2, 8] = -b[:, 1]
    _, _, vt = np.linalg.svd(A)
    Hn = vt[-1].reshape(3, 3)
    H = np.linalg.inv(Tb) @ Hn @ Ta
    return H / H[2, 2]


def _vij(H, i, j):
    return np.array([
        H[0, i] * H[0, j],
        H[0, i] * H[1, j] + H[1, i] * H[0, j],
        H[1, i] * H[1, j],
        H[2, i] * H[0, j] + H[0, i] * H[2, j],
        H[2, i] * H[1, j] + H[1, i] * H[2, j],
        H[2, i] * H[2, j],
    ])


def intrinsics_from_homographies(Hs: Sequence[np.ndarray]) -> np.ndarray:
    """Zhang's B-matrix closed form -> K [3, 3] (needs >= 3 views)."""
    V = []
    for H in Hs:
        V.append(_vij(H, 0, 1))
        V.append(_vij(H, 0, 0) - _vij(H, 1, 1))
    V = np.asarray(V)
    _, _, vt = np.linalg.svd(V)
    b11, b12, b22, b13, b23, b33 = vt[-1]
    den = b11 * b22 - b12 * b12
    v0 = (b12 * b13 - b11 * b23) / den
    lam = b33 - (b13 * b13 + v0 * (b12 * b13 - b11 * b23)) / b11
    alpha = np.sqrt(abs(lam / b11))
    beta = np.sqrt(abs(lam * b11 / den))
    gamma = -b12 * alpha * alpha * beta / lam
    u0 = gamma * v0 / beta - b13 * alpha * alpha / lam
    return np.array([[alpha, gamma, u0], [0, beta, v0], [0, 0, 1.0]])


def extrinsics_from_homography(K: np.ndarray, H: np.ndarray):
    """Per-view (R, t), R projected onto SO(3) by an SVD."""
    Kinv = np.linalg.inv(K)
    h1, h2, h3 = H[:, 0], H[:, 1], H[:, 2]
    lam = 1.0 / (np.linalg.norm(Kinv @ h1) + 1e-12)
    r1 = lam * (Kinv @ h1)
    r2 = lam * (Kinv @ h2)
    t = lam * (Kinv @ h3)
    R = np.stack([r1, r2, np.cross(r1, r2)], axis=1)
    u, _, vt = np.linalg.svd(R)
    R = u @ vt
    if np.linalg.det(R) < 0:
        R = u @ np.diag([1, 1, -1]) @ vt
    if t[2] < 0:  # the board sits in front of the camera
        R[:, :2] *= -1
        t = -t
    return R, t


# ----------------------------------------------------------------------
# joint LM refinement on the device
# ----------------------------------------------------------------------

def _project(params, rvecs, tvecs, obj):
    """params [9]: fx, fy, cx, cy, k1, k2, p1, p2, k3; rvecs, tvecs [V, 3];
    obj [V, M, 3] -> pixels [V, M, 2]."""
    fx, fy, cx, cy, k1, k2, p1, p2, k3 = [params[i] for i in range(9)]
    th = torch.linalg.norm(rvecs, dim=-1) + 1e-12                  # [V]
    Kx = so3_hat(rvecs / th[:, None])
    s, c = torch.sin(th)[:, None, None], (1 - torch.cos(th))[:, None, None]
    Rs = torch.eye(3, dtype=rvecs.dtype, device=rvecs.device) + s * Kx + c * (Kx @ Kx)
    xc = torch.einsum("vij,vmj->vmi", Rs, obj) + tvecs[:, None, :]
    x = xc[..., 0] / xc[..., 2]
    y = xc[..., 1] / xc[..., 2]
    r2 = x * x + y * y
    rad = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 ** 3
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return torch.stack([fx * xd + cx, fy * yd + cy], dim=-1)


def _residual(theta, obj, img):
    """theta [9 + 6V] (intrinsics, rotation vectors, translations) -> the
    stacked reprojection residuals [2VM]."""
    V = obj.shape[0]
    rvecs = theta[9:9 + 3 * V].reshape(V, 3)
    tvecs = theta[9 + 3 * V:].reshape(V, 3)
    return (_project(theta[:9], rvecs, tvecs, obj) - img).reshape(-1)


def lm_refine(theta0, obj, img, iters: int = 30):
    """`iters` Levenberg-Marquardt steps on the tensors' device: a dense
    forward-mode Jacobian [2VM, 9 + 6V], damping lam * diag(JtJ), a step kept
    only if the squared residual falls (lam x0.5, else x4). Returns (theta,
    rms) as device tensors; nothing inside waits for the device."""
    jac = torch.func.jacfwd(_residual)
    theta = theta0
    lam = torch.full((), 1e-3, dtype=theta0.dtype, device=theta0.device)  # a fill, not an upload
    for _ in range(iters):
        r = _residual(theta, obj, img)
        J = jac(theta, obj, img)
        JtJ = J.T @ J
        g = J.T @ r
        A = JtJ + lam * torch.diag(torch.diagonal(JtJ))
        delta = torch.linalg.solve_ex(A, g)[0]
        theta_new = theta - delta
        r_new = _residual(theta_new, obj, img)
        better = torch.sum(r_new ** 2) < torch.sum(r ** 2)
        theta = torch.where(better, theta_new, theta)
        lam = torch.where(better, lam * 0.5, lam * 4.0)
    r = _residual(theta, obj, img)
    return theta, torch.sqrt(torch.mean(r ** 2))


# ----------------------------------------------------------------------
# calibrators
# ----------------------------------------------------------------------

@dataclass
class MonoCalibration:
    K: np.ndarray                 # [3, 3]
    dist: np.ndarray              # [5] k1 k2 p1 p2 k3
    rms: float
    rvecs: np.ndarray             # [V, 3]
    tvecs: np.ndarray             # [V, 3]
    image_size: Tuple[int, int]   # (width, height)


class MonoCalibrator:
    """Monocular chessboard calibrator (calibrator.py MonoCalibrator)."""

    def __init__(self, cols: int, rows: int, square_size: float,
                 image_size: Tuple[int, int]):
        self.obj = board_points(cols, rows, square_size)
        self.image_size = image_size
        self.views: List[np.ndarray] = []

    # the upstream calibrator scores x / y / size / skew coverage
    def view_params(self, corners: np.ndarray) -> np.ndarray:
        w, h = self.image_size
        x = corners[:, 0].mean() / w
        y = corners[:, 1].mean() / h
        area = (np.ptp(corners[:, 0]) * np.ptp(corners[:, 1])) / (w * h)
        d01 = corners[1] - corners[0]
        skew = abs(np.arctan2(d01[1], d01[0]))
        return np.array([x, y, np.sqrt(area), skew])

    def add_view(self, corners: np.ndarray, min_novelty: float = 0.1) -> bool:
        """Keep the view if it adds coverage (the upstream `is_good_sample`)."""
        p = self.view_params(corners)
        for v in self.views:
            if np.abs(self.view_params(v) - p).max() < min_novelty:
                return False
        self.views.append(np.asarray(corners, np.float64))
        return True

    def good_enough(self, min_views: int = 10) -> bool:
        return len(self.views) >= min_views

    def initial_theta(self) -> np.ndarray:
        """The LM's float64 start [9 + 6V]: Zhang's intrinsics, zero
        distortion, each view's rotation vector and translation."""
        if len(self.views) < 3:
            raise ValueError(f"need >= 3 chessboard views, have {len(self.views)}")
        Hs = [homography_dlt(self.obj[:, :2], v) for v in self.views]
        K = intrinsics_from_homographies(Hs)
        rts = [extrinsics_from_homography(K, H) for H in Hs]

        def rodrigues_inv(R):
            th = np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))
            if th < 1e-8:
                return np.zeros(3)
            w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
            return th * w / (2 * np.sin(th))

        return np.concatenate([
            [K[0, 0], K[1, 1], K[0, 2], K[1, 2], 0, 0, 0, 0, 0],
            np.concatenate([rodrigues_inv(R) for R, _ in rts]),
            np.concatenate([t for _, t in rts]),
        ])

    def lm_inputs(self, device) -> tuple:
        """(theta0, obj [V, M, 3], img [V, M, 2]) in CALIB_DTYPE on `device`,
        each rounded from float64 once, as the reference's float32 casts."""
        V, M = len(self.views), len(self.obj)
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device, CALIB_DTYPE)  # noqa: E731
        return (up(self.initial_theta()), up(np.broadcast_to(self.obj, (V, M, 3))),
                up(np.stack(self.views)))

    def calibrate(self, lm_iters: int = 30, device="cuda") -> MonoCalibration:
        """Zhang's start on the host, the joint LM on `device` (the card
        unless "cpu" is passed; without a card it raises), one readback."""
        dev = resolve_device(device)
        theta, rms = lm_refine(*self.lm_inputs(dev), iters=lm_iters)
        out = torch.cat([theta, rms[None]]).cpu().numpy().astype(np.float64)
        return self.result(out[:-1], float(out[-1]))

    def result(self, theta: np.ndarray, rms: float) -> MonoCalibration:
        V = len(self.views)
        K = np.array([[theta[0], 0, theta[2]], [0, theta[1], theta[3]], [0, 0, 1]])
        return MonoCalibration(
            K=K, dist=theta[4:9], rms=rms,
            rvecs=theta[9:9 + 3 * V].reshape(V, 3),
            tvecs=theta[9 + 3 * V:].reshape(V, 3),
            image_size=self.image_size,
        )


@dataclass
class StereoCalibration:
    left: MonoCalibration
    right: MonoCalibration
    R: np.ndarray       # right <- left rotation
    t: np.ndarray       # right <- left translation
    R1: np.ndarray      # rectification rotations
    R2: np.ndarray
    P1: np.ndarray      # [3, 4] rectified projections
    P2: np.ndarray
    baseline: float


class StereoCalibrator:
    """Stereo chessboard calibrator (calibrator.py StereoCalibrator): a mono
    solve per eye, the relative pose averaged over the views, Bouguet
    rectification (the K/D/R/P blocks the engine's YAML settings read)."""

    def __init__(self, cols: int, rows: int, square_size: float,
                 image_size: Tuple[int, int]):
        self.left = MonoCalibrator(cols, rows, square_size, image_size)
        self.right = MonoCalibrator(cols, rows, square_size, image_size)

    def add_view(self, corners_l: np.ndarray, corners_r: np.ndarray):
        self.left.views.append(np.asarray(corners_l, np.float64))
        self.right.views.append(np.asarray(corners_r, np.float64))

    def calibrate(self, device="cuda") -> StereoCalibration:
        return stereo_from_monos(self.left.calibrate(device=device),
                                 self.right.calibrate(device=device))


def stereo_from_monos(cl: MonoCalibration, cr: MonoCalibration) -> StereoCalibration:
    """Relative pose per view T_rl = T_r T_l^-1; the rotation averaged as a
    quaternion mean, the translation as an arithmetic mean; then Bouguet
    rectification."""
    Rs, ts = [], []
    for i in range(len(cl.rvecs)):
        Rl, tl = _rodrigues_np(cl.rvecs[i]), cl.tvecs[i]
        Rr, tr = _rodrigues_np(cr.rvecs[i]), cr.tvecs[i]
        R = Rr @ Rl.T
        ts.append(tr - R @ tl)
        Rs.append(R)
    qs = np.stack([_quat_from_R(R) for R in Rs])
    qs *= np.sign(qs @ qs[0])[:, None]
    q = qs.mean(axis=0)
    q /= np.linalg.norm(q)
    R = _R_from_quat(q)
    t = np.mean(ts, axis=0)

    R1, R2, P1, P2 = stereo_rectify(cl.K, cr.K, R, t)
    return StereoCalibration(
        left=cl, right=cr, R=R, t=t, R1=R1, R2=R2, P1=P1, P2=P2,
        baseline=float(np.linalg.norm(t)),
    )


def _quat_from_R(R):
    w = np.sqrt(max(0.0, 1 + R[0, 0] + R[1, 1] + R[2, 2])) / 2
    if w < 1e-8:
        d = np.diagonal(R)
        i = int(np.argmax(d))
        q = np.zeros(4)
        q[1 + i] = 1.0
        return q
    x = (R[2, 1] - R[1, 2]) / (4 * w)
    y = (R[0, 2] - R[2, 0]) / (4 * w)
    z = (R[1, 0] - R[0, 1]) / (4 * w)
    return np.array([w, x, y, z])


def _R_from_quat(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def stereo_rectify(K1, K2, R, t):
    """Bouguet rectification: split the relative rotation between the eyes,
    then rotate both so epipolar lines are rows. Returns R1, R2, P1 [3, 4],
    P2 [3, 4]."""
    rv = _rodrigues_inv_np(R)
    R_half_l = _rodrigues_np(-rv / 2)
    R_half_r = _rodrigues_np(rv / 2).T
    t_rect = R_half_r @ t
    # the baseline along x (left eye at the origin, right at +x)
    e1 = t_rect / (np.linalg.norm(t_rect) + 1e-12)
    if e1[0] < 0:
        e1 = -e1
    e2 = np.cross([0, 0, 1.0], e1)
    n = np.linalg.norm(e2)
    e2 = np.array([0, 1.0, 0]) if n < 1e-8 else e2 / n
    e3 = np.cross(e1, e2)
    Rw = np.stack([e1, e2, e3], axis=0)
    R1 = Rw @ R_half_l
    R2 = Rw @ R_half_r
    f = (K1[0, 0] + K1[1, 1] + K2[0, 0] + K2[1, 1]) / 4
    cx = (K1[0, 2] + K2[0, 2]) / 2
    cy = (K1[1, 2] + K2[1, 2]) / 2
    Kn = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1.0]])
    P1 = np.concatenate([Kn, np.zeros((3, 1))], axis=1)
    baseline = np.linalg.norm(t)
    P2 = np.concatenate([Kn, np.array([[-f * baseline], [0], [0]])], axis=1)
    return R1, R2, P1, P2


def _rodrigues_np(rv):
    th = np.linalg.norm(rv)
    if th < 1e-12:
        return np.eye(3)
    k = rv / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * (Kx @ Kx)


def _rodrigues_inv_np(R):
    th = np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))
    if th < 1e-12:
        return np.zeros(3)
    w = np.array([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return th * w / (2 * np.sin(th))


# ----------------------------------------------------------------------
# YAML emission (the engine's stereo settings schema)
# ----------------------------------------------------------------------

def _mat_yaml(name, m):
    m = np.asarray(m, np.float64)
    rows, cols = m.shape
    data = ", ".join(f"{v:.8f}" for v in m.ravel())
    return (f"{name}: !!opencv-matrix\n   rows: {rows}\n   cols: {cols}\n"
            f"   dt: d\n   data: [{data}]\n")


def stereo_yaml(calib: StereoCalibration, fps: float = 10.0,
                depth_th: float = 20.0) -> str:
    """Settings YAML in the upstream stereo schema (arducam.yaml), which
    `io.rectify.rectification_from_yaml` reads."""
    P1 = calib.P1
    bf = abs(calib.P2[0, 3])
    w, h = calib.left.image_size
    out = ["%YAML:1.0", ""]
    out += [
        f"Camera.fx: {P1[0, 0]:.6f}",
        f"Camera.fy: {P1[1, 1]:.6f}",
        f"Camera.cx: {P1[0, 2]:.6f}",
        f"Camera.cy: {P1[1, 2]:.6f}",
        "Camera.k1: 0.0", "Camera.k2: 0.0", "Camera.p1: 0.0", "Camera.p2: 0.0",
        f"Camera.width: {w}", f"Camera.height: {h}",
        f"Camera.fps: {fps:.1f}",
        f"Camera.bf: {bf:.6f}",
        "Camera.RGB: 1",
        f"ThDepth: {depth_th:.1f}",
        "",
    ]
    d5 = lambda d: np.asarray(d, np.float64).reshape(1, 5)  # noqa: E731
    out.append(_mat_yaml("LEFT.K", calib.left.K))
    out.append(_mat_yaml("LEFT.D", d5(calib.left.dist)))
    out.append(_mat_yaml("LEFT.R", calib.R1))
    out.append(_mat_yaml("LEFT.P", calib.P1))
    out.append(_mat_yaml("RIGHT.K", calib.right.K))
    out.append(_mat_yaml("RIGHT.D", d5(calib.right.dist)))
    out.append(_mat_yaml("RIGHT.R", calib.R2))
    out.append(_mat_yaml("RIGHT.P", calib.P2))
    return "\n".join(out)
