"""Bundle-adjustment problem and residual blocks (counterpart of
orb_slam2_2021_tpu/optim/ba.py).

A problem is a set of padded tensors:
  cameras : R [C,3,3], t [C,3] (Tcw), cam_free [C]
  points  : xw [P,3]
  obs     : obs_cam [O], obs_pt [O] (int64), obs_uvr [O,3] (u_r < 0 = mono),
            obs_inv_sigma2 [O], obs_valid [O]
  pt_obs  : [P, Q] obs indices (-1 pad), the dense path's reverse index.

Only the blocks the conjugate-gradient solver needs are ported
(`optim/ba_cg.py`); the reference's dense reduced-camera solver
(`_lm_step`, `ba_solve`, `make_local_ba`) serves `use_cg_local_ba=False`,
which the port does not run (ROADMAP.md).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.camera import PinholeCamera
from ..xmath import smm, smv
from .robust import (
    point_jacobian_pose,
    proj_jacobian_mono,
    proj_jacobian_stereo,
    stereo_residual,
)


class BAProblem(NamedTuple):
    R: torch.Tensor               # [C, 3, 3] Tcw rotations
    t: torch.Tensor               # [C, 3]
    xw: torch.Tensor              # [P, 3]
    obs_cam: torch.Tensor         # [O] int64
    obs_pt: torch.Tensor          # [O] int64
    obs_uvr: torch.Tensor         # [O, 3]; u_r < 0 => mono
    obs_inv_sigma2: torch.Tensor  # [O]
    obs_valid: torch.Tensor       # [O] bool
    pt_obs: torch.Tensor          # [P, Q] int64 obs indices, -1 pad
    cam_free: torch.Tensor        # [C] bool: optimizable


def _camera_points(prob: BAProblem, R, t, xw):
    Rc = R[prob.obs_cam]                                  # [O,3,3]
    Xc = smv(Rc, xw[prob.obs_pt]) + t[prob.obs_cam]
    return Rc, Xc


def _residual(cam: PinholeCamera, prob: BAProblem, Xc):
    """Per-observation residual [O,3] (mono rows have a zero third entry)."""
    r3 = stereo_residual(cam, Xc, prob.obs_uvr)
    r2 = torch.cat([r3[:, :2], torch.zeros_like(r3[:, :1])], dim=1)
    return torch.where((prob.obs_uvr[:, 2] >= 0)[:, None], r3, r2)


def _residual_jacobians(cam: PinholeCamera, prob: BAProblem, R, t, xw):
    """Per-observation residual r [O,3], Jc [O,3,6], Jp [O,3,3], chi2 [O],
    behind [O]."""
    Rc, Xc = _camera_points(prob, R, t, xw)
    r = _residual(cam, prob, Xc)
    is_stereo = prob.obs_uvr[:, 2] >= 0

    Jproj3 = proj_jacobian_stereo(cam, Xc)                # [O,3,3]
    Jproj2 = proj_jacobian_mono(cam, Xc)                  # [O,2,3]
    Jproj2 = torch.cat([Jproj2, torch.zeros_like(Jproj2[:, :1])], dim=1)
    Jproj = torch.where(is_stereo[:, None, None], Jproj3, Jproj2)

    Jpose = point_jacobian_pose(Xc)                       # [O,3,6]
    Jc = -smm(Jproj, Jpose)
    Jp = -smm(Jproj, Rc)

    chi2 = torch.sum(r * r, dim=1) * prob.obs_inv_sigma2
    return r, Jc, Jp, chi2, Xc[:, 2] <= 0


def _residual_chi2(cam: PinholeCamera, prob: BAProblem, R, t, xw):
    """chi2 [O] and behind [O] only (the LM accept/reject gate)."""
    _, Xc = _camera_points(prob, R, t, xw)
    r = _residual(cam, prob, Xc)
    return torch.sum(r * r, dim=1) * prob.obs_inv_sigma2, Xc[:, 2] <= 0


def _total_cost(chi2, w_active, delta2, use_huber: bool):
    if use_huber:
        rho = torch.where(
            chi2 <= delta2, chi2,
            2.0 * torch.sqrt(delta2 * torch.clamp_min(chi2, 1e-12)) - delta2,
        )
    else:
        rho = chi2
    return torch.sum(rho * w_active)
