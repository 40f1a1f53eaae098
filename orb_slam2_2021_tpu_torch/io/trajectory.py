"""Trajectory export in the reference's formats and ATE evaluation: the
port's own copy of orb_slam2_2021_tpu/io/trajectory.py (the same files).

KITTI: 12 floats per line, row-major 3x4 Twc (System::SaveTrajectoryKITTI).
TUM: `t tx ty tz qx qy qz qw` per line (System::SaveTrajectoryTUM).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from ..geometry.so3 import rot_to_quat


def save_kitti(path: str, poses_twc: Sequence[np.ndarray]):
    with open(path, "w") as f:
        for T in poses_twc:
            row = T[:3, :4].reshape(-1)
            f.write(" ".join(f"{v:.9e}" for v in row) + "\n")


def save_tum(path: str, stamped: Sequence[Tuple[float, np.ndarray]]):
    """(timestamp, Twc [4, 4]) per line; the quaternion is computed in
    float32, as the reference does."""
    with open(path, "w") as f:
        for ts, T in stamped:
            t = T[:3, 3]
            R = torch.from_numpy(np.ascontiguousarray(T[:3, :3], np.float32))
            q = rot_to_quat(R[None])[0].numpy()  # (w, x, y, z)
            f.write(f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                    f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")


def ate_rmse(
    est_twc: Sequence[np.ndarray], gt_twc: Sequence[np.ndarray],
    align=True, with_scale=False,
) -> float:
    """Absolute trajectory error RMSE after optional SE3 (or Sim3 when
    with_scale — the monocular evaluation) Horn alignment."""
    est = np.asarray([T[:3, 3] for T in est_twc], np.float64)
    gt = np.asarray([T[:3, 3] for T in gt_twc], np.float64)
    assert est.shape == gt.shape
    if align and len(est) >= 3:
        mu_e = est.mean(0)
        mu_g = gt.mean(0)
        E = est - mu_e
        G = gt - mu_g
        U, _, Vt = np.linalg.svd(E.T @ G)
        S = np.eye(3)
        if np.linalg.det(U @ Vt) < 0:
            S[2, 2] = -1
        R = Vt.T @ S @ U.T
        s = 1.0
        if with_scale:
            Er = (R @ E.T).T
            s = float((Er * G).sum() / max((Er * Er).sum(), 1e-12))
        est = s * (R @ E.T).T + mu_g
        gt = G + mu_g
    err = est - gt
    return float(np.sqrt((err * err).sum(axis=1).mean()))
