"""Motion-only pose optimization (counterpart of orb_slam2_2021_tpu/optim/pose.py).

4 rounds of 10 Levenberg-Marquardt iterations on the 6-DoF pose over dense
[N, ...] observation tensors; chi2 reclassification between rounds, Huber
kernel in the first two rounds only. The accept/reject of each step stays on
the device (torch.where), and the 6x6 solve is `solve_ex`, so the loop never
waits for the device.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.camera import PinholeCamera
from ..geometry.se3 import se3_compose, se3_exp
from ..xmath import smm
from .robust import (
    huber_weight,
    mono_residual,
    point_jacobian_pose,
    proj_jacobian_mono,
    proj_jacobian_stereo,
    stereo_residual,
)


class PoseObs(NamedTuple):
    """Padded observation set for one frame."""
    xw: torch.Tensor          # [N, 3] world points
    uvr: torch.Tensor         # [N, 3] (u, v, u_r); u_r < 0 => monocular obs
    inv_sigma2: torch.Tensor  # [N] information scalar (per octave)
    valid: torch.Tensor       # [N] bool


def _to_camera(R, t, xw):
    return torch.matmul(xw, R.transpose(0, 1)) + t


def _rho(chi, delta2, use_huber: bool):
    if not use_huber:
        return chi
    return torch.where(
        chi <= delta2, chi, 2.0 * torch.sqrt(delta2 * torch.clamp_min(chi, 1e-12)) - delta2
    )


def _chi2(cam, R, t, obs: PoseObs):
    """Per-observation chi2 (stereo 3 residual dims, mono 2) and behind-camera."""
    Xc = _to_camera(R, t, obs.xw)
    r3 = stereo_residual(cam, Xc, obs.uvr)
    r2 = mono_residual(cam, Xc, obs.uvr[:, :2])
    is_stereo = obs.uvr[:, 2] >= 0
    chi_s = torch.sum(r3 * r3, dim=-1) * obs.inv_sigma2
    chi_m = torch.sum(r2 * r2, dim=-1) * obs.inv_sigma2
    return torch.where(is_stereo, chi_s, chi_m), Xc[:, 2] <= 0.0


def _delta2(obs: PoseObs, chi2_mono: float, chi2_stereo: float):
    is_stereo = obs.uvr[:, 2] >= 0
    return torch.where(
        is_stereo,
        torch.full_like(obs.inv_sigma2, chi2_stereo),
        torch.full_like(obs.inv_sigma2, chi2_mono),
    )


def _build_normal_eq(cam, R, t, obs: PoseObs, active, use_huber: bool, delta2):
    Xc = _to_camera(R, t, obs.xw)
    is_stereo = obs.uvr[:, 2] >= 0
    r3 = stereo_residual(cam, Xc, obs.uvr)
    r2 = mono_residual(cam, Xc, obs.uvr[:, :2])
    Jp = point_jacobian_pose(Xc)
    J3 = -smm(proj_jacobian_stereo(cam, Xc), Jp)
    J2 = -smm(proj_jacobian_mono(cam, Xc), Jp)

    # mono observations as 3-dim residuals with a zeroed third row
    r = torch.where(is_stereo[:, None], r3, torch.nn.functional.pad(r2, (0, 1)))
    J = torch.where(
        is_stereo[:, None, None], J3, torch.cat([J2, torch.zeros_like(J2[:, :1])], dim=1)
    )
    chi = torch.sum(r * r, dim=-1) * obs.inv_sigma2
    w_huber = huber_weight(chi, delta2) if use_huber else torch.ones_like(chi)
    w = obs.inv_sigma2 * w_huber * active.to(torch.float32)
    H = torch.einsum("nik,n,nil->kl", J, w, J)
    b = torch.einsum("nik,n,ni->k", J, w, r)
    err = torch.sum(_rho(chi, delta2, use_huber) * active)
    return H, b, err


def pose_optimize(cam: PinholeCamera, R0, t0, obs: PoseObs, cfg):
    """Returns (R, t, inlier_mask, n_inliers) on the device; `cfg` is the
    reference's OptimConfig."""
    dev = obs.xw.device
    delta2 = _delta2(obs, cfg.chi2_mono, cfg.chi2_stereo)
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    R, t = R0, t0
    inlier = obs.valid
    for round_idx in range(cfg.pose_rounds):
        use_huber = round_idx < 2  # reference: kernels removed in rounds 3-4
        lam = torch.tensor(cfg.lm_lambda_init, dtype=torch.float32, device=dev)
        for _ in range(cfg.pose_iters):
            H, b, err = _build_normal_eq(cam, R, t, obs, inlier, use_huber, delta2)
            Hd = H + lam * torch.diag(torch.diagonal(H)) + 1e-8 * eye6
            step = torch.linalg.solve_ex(Hd, b[:, None])[0][:, 0]
            dR, dt = se3_exp(-step)
            Rn, tn = se3_compose(dR, dt, R, t)
            chi_n, _ = _chi2(cam, Rn, tn, obs)
            err_new = torch.sum(_rho(chi_n, delta2, use_huber) * inlier)
            improved = err_new < err
            R = torch.where(improved, Rn, R)
            t = torch.where(improved, tn, t)
            lam = torch.where(improved, lam * 0.5, lam * 4.0)
        chi, behind = _chi2(cam, R, t, obs)
        inlier = obs.valid & (chi <= delta2) & ~behind
    return R, t, inlier, torch.sum(inlier)
