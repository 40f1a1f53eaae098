"""Bundle adjustment with Schur-complement landmark elimination
(counterpart of orb_slam2_2021_tpu/optim/ba.py).

A problem is a set of padded tensors:
  cameras : R [C,3,3], t [C,3] (Tcw), cam_free [C]
  points  : xw [P,3]
  obs     : obs_cam [O], obs_pt [O] (int64), obs_uvr [O,3] (u_r < 0 = mono),
            obs_inv_sigma2 [O], obs_valid [O]
  pt_obs  : [P, Q] obs indices (-1 pad): every valid observation of each
            point, the dense path's reverse index.

This module holds the residual blocks every solver shares and the dense
reduced-camera solver (`_lm_step`, `ba_solve`, `make_local_ba`,
`make_global_ba`), which local mapping runs with `use_cg_local_ba=False`;
the conjugate-gradient solvers are in `optim/ba_cg.py`.

One dense LM step builds the camera blocks U, b_c as products with the
[O, C] camera one-hot, the point blocks V, b_p by gathering each point's
observations through pt_obs, and the Schur correction by moving each
point's [Q] terms into a [P, C, 6, 3] camera layout (one-hot over the
point's cameras) and contracting over P: no float atomics, so the CUDA and
CPU solves agree. The reduced [6C, 6C] system is solved minimum-norm by
`eigh` with a relative cutoff, which keeps a monocular window's scale
null space out of the step. With a process group (`group`), points and
observations are sharded per rank and the camera-side sums (U, b_c, the
Schur correction and its right-hand side, the costs) are all-reduced where
the reference psums them over its mesh axis.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.distributed as dist

from ..geometry.camera import PinholeCamera
from ..geometry.se3 import se3_compose, se3_exp
from ..xmath import smm, smv, souter, stmv
from .robust import (
    huber_weight,
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


def _inv3x3(A):
    """Closed-form (adjugate) batched 3x3 inverse."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
    adj = torch.stack([
        torch.stack([A11, A12, A13], -1),
        torch.stack([A21, A22, A23], -1),
        torch.stack([A31, A32, A33], -1),
    ], -2)
    return adj * inv_det[..., None, None]



def _cam_onehot(prob: BAProblem):
    """[O, C] float32 0/1 assignment matrix."""
    C = prob.R.shape[0]
    cams = torch.arange(C, dtype=prob.obs_cam.dtype, device=prob.obs_cam.device)
    return ((prob.obs_cam[:, None] == cams[None, :]) & prob.obs_valid[:, None]).to(torch.float32)


def _damp(H, lam, n: int):
    """H + lam * max(diag H, 1e-6) on the diagonal + 1e-8 I."""
    eye = torch.eye(n, dtype=H.dtype, device=H.device)
    diag = torch.clamp_min(torch.diagonal(H, dim1=1, dim2=2), 1e-6)
    return H + lam * eye[None] * diag[:, :, None] * eye[None] + 1e-8 * eye[None]


def _all_reduce(x, group):
    """Sum x over the ranks of `group` (the reference's psum); x itself
    without one."""
    if group is not None:
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


# The dense step's eigenproblem, one [6C, 6C] matrix per LM iteration, is
# solved in float64. The 1e-6 relative cutoff keeps modes whose float32
# eigenvalues carry percent errors: on a three-camera window padded to 128
# cameras a float32 solve ends millimetres (poses) and decimetres (points)
# from a float64 one on the same CPU, while on the card float64 costs about
# what float32 does (PERF.md, chip_smoke.py phase 19). float32 is the
# reference's precision: the parity tests set it.
EIG_DTYPE = torch.float64


def _delta2(prob: BAProblem, chi2, cfg):
    return torch.where(prob.obs_uvr[:, 2] >= 0, torch.full_like(chi2, cfg.chi2_stereo),
                       torch.full_like(chi2, cfg.chi2_mono))


def _lm_step(cam, prob: BAProblem, R, t, xw, active, lam, use_huber: bool, cfg, group=None):
    """One damped LM step with a dense solve of the reduced camera system.
    Returns (R, t, xw) of the candidate and (chi2, behind, delta2) at the
    current state."""
    C = prob.R.shape[0]
    P = prob.xw.shape[0]
    O = prob.obs_cam.shape[0]
    Q = prob.pt_obs.shape[1]

    r, Jc, Jp, chi2, behind = _residual_jacobians(cam, prob, R, t, xw)
    delta2 = _delta2(prob, chi2, cfg)
    wh = huber_weight(chi2, delta2) if use_huber else torch.ones_like(chi2)
    w = prob.obs_inv_sigma2 * wh * active

    # fixed cameras' Jacobians are zero, so their blocks never enter S
    Jc = Jc * prob.cam_free[prob.obs_cam][:, None, None]
    Jcw = Jc * w[:, None, None]
    Jpw = Jp * w[:, None, None]

    oh_t = _cam_onehot(prob).transpose(0, 1)                         # [C,O]
    U = _all_reduce((oh_t @ souter(Jcw, Jc).reshape(O, 36)).reshape(C, 6, 6), group)
    b_c = _all_reduce(oh_t @ stmv(Jcw, r), group)                    # [C,6]
    Wcp = souter(Jcw, Jp)                                            # [O,6,3]

    # per-point gathers through the reverse index
    po = prob.pt_obs
    po_valid = po >= 0
    po_safe = po.clamp_min(0)
    pv = po_valid.to(R.dtype)
    V = (souter(Jpw, Jp)[po_safe] * pv[..., None, None]).sum(dim=1)   # [P,3,3]
    b_p = (stmv(Jpw, r)[po_safe] * pv[..., None]).sum(dim=1)          # [P,3]

    U_d = _damp(U, lam, 6)
    V_inv = _inv3x3(_damp(V, lam, 3))

    # Schur correction S[a,b] = sum_p sum_{q in a, r in b} Y_q W_r^T with
    # Y = W V^-1: each point's terms summed into its cameras' slots
    cam_of = prob.obs_cam[po_safe]                                   # [P,Q]
    W_po = Wcp[po_safe] * pv[..., None, None]                        # [P,Q,6,3]
    Y = torch.einsum("pqik,pkl->pqil", W_po, V_inv)                  # [P,Q,6,3]
    cams = torch.arange(C, dtype=cam_of.dtype, device=cam_of.device)
    oh = ((cam_of[..., None] == cams) & po_valid[..., None]).to(R.dtype).transpose(1, 2)  # [P,C,Q]

    def camera_layout(X):                                            # [P,Q,6,3] -> [6C, 3P]
        A = torch.bmm(oh, X.reshape(P, Q, 18)).reshape(P, C, 6, 3)
        return A.permute(1, 2, 0, 3).reshape(6 * C, 3 * P)

    Wf, Yf = camera_layout(W_po), camera_layout(Y)
    S_corr = _all_reduce(Yf @ Wf.transpose(0, 1), group)             # [(a,i),(b,j)]
    b_corr = _all_reduce((Yf @ b_p.reshape(3 * P)).reshape(C, 6), group)
    eyeC = torch.eye(C, dtype=R.dtype, device=R.device)
    S = torch.einsum("cij,cd->cidj", U_d, eyeC).reshape(6 * C, 6 * C) - S_corr

    # minimum-norm solve: modes below 1e-6 of the largest are dropped (a
    # monocular window's scale gauge), fixed cameras collapse to identity
    free = torch.repeat_interleave(prob.cam_free, 6)
    S = torch.where(free[:, None] & free[None, :], S,
                    torch.eye(6 * C, dtype=R.dtype, device=R.device))
    rhs = torch.where(free, -(b_c - b_corr).reshape(-1), torch.zeros_like(free, dtype=R.dtype))
    eigw, eigv = torch.linalg.eigh((0.5 * (S + S.transpose(0, 1))).to(EIG_DTYPE))
    cutoff = torch.clamp_min(eigw.abs().max(), 1e-12) * 1e-6
    inv_w = torch.where(eigw > cutoff, 1.0 / eigw, torch.zeros_like(eigw))
    delta_c = (eigv @ (inv_w * (eigv.transpose(0, 1) @ rhs.to(EIG_DTYPE)))).to(R.dtype)
    delta_c = delta_c.reshape(C, 6) * prob.cam_free[:, None]

    # back-substitution: delta_p = -V^-1 (b_p + sum_q W_q^T delta_c)
    wt_dc = torch.einsum("pqik,pqi->pk", W_po, delta_c[cam_of])
    delta_p = -smv(V_inv, b_p + wt_dc)

    dR, dt = se3_exp(delta_c)
    R_new, t_new = se3_compose(dR, dt, R, t)
    return R_new, t_new, xw + delta_p, chi2, behind, delta2


def classify_inliers(cam, prob: BAProblem, R, t, xw, cfg):
    """obs_valid & chi2 <= delta^2 & in front of the camera."""
    chi2, behind = _residual_chi2(cam, prob, R, t, xw)
    return prob.obs_valid & (chi2 <= _delta2(prob, chi2, cfg)) & ~behind


def ba_solve(cam, prob: BAProblem, cfg, iters_phase1: int, iters_phase2: int, group=None):
    """Two-phase LM as LocalBundleAdjustment schedules it: Huber phase, chi2
    reclassification, inlier-only phase. Each step is accepted when it
    lowers the robust cost (summed over the ranks of `group`); lambda and
    the state stay on the device. Returns (R, t, xw, obs_inlier)."""

    def phase(R, t, xw, active, n_iters, use_huber):
        lam = torch.tensor(cfg.lm_lambda_init, dtype=torch.float32, device=R.device)
        for _ in range(n_iters):
            Rn, tn, xwn, chi2, _, delta2 = _lm_step(cam, prob, R, t, xw, active, lam,
                                                    use_huber, cfg, group)
            chi2_new, _ = _residual_chi2(cam, prob, Rn, tn, xwn)
            costs = _all_reduce(torch.stack([_total_cost(chi2, active, delta2, use_huber),
                                             _total_cost(chi2_new, active, delta2, use_huber)]),
                                group)
            improved = costs[1] < costs[0]
            R = torch.where(improved, Rn, R)
            t = torch.where(improved, tn, t)
            xw = torch.where(improved, xwn, xw)
            lam = torch.where(improved, lam * 0.5, lam * 4.0)
        return R, t, xw

    R, t, xw = phase(prob.R, prob.t, prob.xw, prob.obs_valid.to(torch.float32),
                     iters_phase1, True)
    inlier = classify_inliers(cam, prob, R, t, xw, cfg)
    R, t, xw = phase(R, t, xw, inlier.to(torch.float32), iters_phase2, False)
    return R, t, xw, classify_inliers(cam, prob, R, t, xw, cfg)


def make_local_ba(cfg):
    """ba_solve at local mapping's schedule: (cam, prob, group=None) ->
    (R, t, xw, inlier)."""
    return functools.partial(ba_solve, cfg=cfg, iters_phase1=cfg.local_ba_iters1,
                             iters_phase2=cfg.local_ba_iters2)


def make_global_ba(cfg):
    """ba_solve as one Huber phase of global_ba_iters iterations."""
    return functools.partial(ba_solve, cfg=cfg, iters_phase1=cfg.global_ba_iters,
                             iters_phase2=0)
