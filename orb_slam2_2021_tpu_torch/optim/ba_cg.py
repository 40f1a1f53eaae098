"""Bundle adjustment by LM with block-Jacobi PCG on the reduced camera
system (counterpart of orb_slam2_2021_tpu/optim/ba_cg.py): local BA and
global BA up to 128 cameras on the materialized system of the PQ layout
(`make_lm_chunk_pq` -> `_cg_lm_step_rcs`), global BA above that on the flat
layout with the system applied matrix-free (`make_gba_iteration` ->
`_cg_lm_step`).

Observations are laid out per point (obs index o = p*Q + q): point-side
reductions are a reshape-sum over Q and camera-side reductions a product
with the [O, C] one-hot assignment matrix. The one-hot form is kept on the
card rather than `index_add_`: float atomics are not deterministic, and the
CUDA and CPU solves must agree. Every accept/reject and PCG guard is a
`torch.where`, so a solve never waits on the device.

In the flat layout observations are in any order; camera-side sums are
again products with the [O, C] one-hot, and point-side sums gather each
point's observations through a [P, Qmax] table (`FlatIndex`) and sum over
Qmax. No float atomics either way, so the card repeats its solve exactly.
The flat solver takes an optional process group (`parallel/dist_ba.py`):
each rank then holds a landmark shard, and U, b_c, the Schur right-hand
side, the correction inside each PCG product and the costs are
all-reduced, the four places the reference psums over its mesh axis.

Not ported (ROADMAP.md): `_cg_lm_step_pq` (reached only through the
reference's `make_local_ba_cg_pq` / `make_lm_iteration_pq`, which the
System does not call) and `ba_solve_cg*`.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.se3 import se3_compose, se3_exp
from ..xmath import smv, souter, stmv
from .ba import (BAProblem, _all_reduce, _cam_onehot, _damp, _delta2, _inv3x3, _residual_chi2,
                 _residual_jacobians, _total_cost, classify_inliers)
from .robust import huber_weight


def _inv6x6_spd(M):
    """Batched 6x6 SPD inverse via the 3x3 block Schur complement."""
    A = M[..., :3, :3]
    B = M[..., :3, 3:]
    D = M[..., 3:, 3:]
    Ai = _inv3x3(A)
    AiB = torch.einsum("...ij,...jk->...ik", Ai, B)
    S = D - torch.einsum("...ji,...jk->...ik", B, AiB)
    Si = _inv3x3(S)
    TR = -torch.einsum("...ij,...jk->...ik", AiB, Si)
    TL = Ai - torch.einsum("...ij,...kj->...ik", TR, AiB)
    BL = TR.transpose(-1, -2)
    top = torch.cat([TL, TR], dim=-1)
    bot = torch.cat([BL, Si], dim=-1)
    return torch.cat([top, bot], dim=-2)


def _chol3x3(A):
    """Closed-form Cholesky A = L L^T of batched SPD 3x3 matrices."""
    a11, a21, a31 = A[..., 0, 0], A[..., 1, 0], A[..., 2, 0]
    a22, a32, a33 = A[..., 1, 1], A[..., 2, 1], A[..., 2, 2]
    l11 = torch.sqrt(torch.clamp_min(a11, 1e-20))
    l21 = a21 / l11
    l31 = a31 / l11
    l22 = torch.sqrt(torch.clamp_min(a22 - l21 * l21, 1e-20))
    l32 = (a32 - l31 * l21) / l22
    l33 = torch.sqrt(torch.clamp_min(a33 - l31 * l31 - l32 * l32, 1e-20))
    z = torch.zeros_like(l11)
    return torch.stack([
        torch.stack([l11, z, z], -1),
        torch.stack([l21, l22, z], -1),
        torch.stack([l31, l32, l33], -1),
    ], -2)


def _cg_lm_step_rcs(cam, prob: BAProblem, onehot_pq, R, t, xw, active, lam,
                    use_huber: bool, cfg, cg_iters: int):
    """One damped LM step: build S = U_d - W V^-1 W^T ([6C, 6C]) once, run
    `cg_iters` PCG iterations on it, back-substitute the points."""
    C = prob.R.shape[0]
    P = prob.xw.shape[0]
    O = prob.obs_cam.shape[0]
    Q = O // P

    r, Jc, Jp, chi2, behind = _residual_jacobians(cam, prob, R, t, xw)
    delta2 = _delta2(prob, chi2, cfg)
    wh = huber_weight(chi2, delta2) if use_huber else torch.ones_like(chi2)
    w = prob.obs_inv_sigma2 * wh * active

    free_o = prob.cam_free[prob.obs_cam]
    Jc = Jc * free_o[:, None, None]
    Jcw = Jc * w[:, None, None]

    oh_t = onehot_pq.transpose(0, 1)                                 # [C,O]
    U = (oh_t @ souter(Jcw, Jc).reshape(O, 36)).reshape(C, 6, 6)
    b_c = oh_t @ stmv(Jcw, r)                                        # [C,6]

    Jpw = Jp * w[:, None, None]
    V = souter(Jpw, Jp).reshape(P, Q, 3, 3).sum(dim=1)
    b_p = stmv(Jpw, r).reshape(P, Q, 3).sum(dim=1)

    Wcp = souter(Jcw, Jp)                                            # [O,6,3]

    U_d = _damp(U, lam, 6)
    V_d = _damp(V, lam, 3)
    eyeC = torch.eye(6, dtype=R.dtype, device=R.device)
    U_d = torch.where(prob.cam_free[:, None, None], U_d, eyeC[None])
    V_inv = _inv3x3(V_d)
    free = prob.cam_free[:, None]

    # V^-1 = F F^T; with Y_o = W_o F_p(o) and M~_p = sum_q onehot * Y, the
    # Schur correction is sum_p M~_p M~_p^T: one [P, C, 6, 3] intermediate
    F = _chol3x3(V_inv)
    Yr = torch.einsum("pqik,pkl->pqil", Wcp.reshape(P, Q, 6, 3), F)
    oh = onehot_pq.reshape(P, Q, C)
    Mt = torch.bmm(oh.transpose(1, 2), Yr.reshape(P, Q, 18)).reshape(P, C, 6, 3)
    Mf = Mt.permute(1, 2, 0, 3).reshape(6 * C, 3 * P)                # [(c,i),(p,k)]
    S4 = Mf @ Mf.transpose(0, 1)                                     # [6C,6C]
    U4 = torch.einsum("cij,cd->cidj", U_d, torch.eye(C, dtype=R.dtype, device=R.device))
    S = U4.reshape(6 * C, 6 * C) - S4

    u = torch.einsum("pkl,pk->pl", F, b_p)                           # F^T b_p
    b_corr = (Mf @ u.reshape(3 * P)).reshape(C, 6)
    rhs = (-(b_c - b_corr) * free).reshape(-1)

    # fixed cameras: their rows/cols collapse to identity
    free_flat = torch.repeat_interleave(prob.cam_free, 6)
    mask2 = free_flat[:, None] & free_flat[None, :]
    S = torch.where(mask2, S, torch.eye(6 * C, dtype=R.dtype, device=R.device))
    rhs = rhs * free_flat

    M_inv = _inv6x6_spd(U_d)

    def precond(v):
        return (smv(M_inv, v.reshape(C, 6)) * free).reshape(-1)

    x = torch.zeros_like(rhs)
    rr = rhs
    z = precond(rr)
    p = z
    rz = torch.sum(rr * z)
    tiny = torch.full_like(rz, 1e-20)
    zero = torch.zeros_like(rz)
    for _ in range(cg_iters):
        Sp = (S @ p) * free_flat
        pSp = torch.sum(p * Sp)
        alpha = rz / torch.where(torch.abs(pSp) < 1e-20, tiny, pSp)
        alive = rz > 1e-18
        alpha = torch.where(alive, alpha, zero)
        x = x + alpha * p
        rr = rr - alpha * Sp
        z = precond(rr)
        rz_new = torch.sum(rr * z)
        beta = torch.where(alive, rz_new / torch.where(rz < 1e-20, tiny, rz), zero)
        p = z + beta * p
        rz = rz_new
    delta_c = x.reshape(C, 6) * free

    # back-substitution: delta_p = -V^-1 (b_p + W^T delta_c)
    wt_dc = stmv(Wcp, delta_c[prob.obs_cam]).reshape(P, Q, 3).sum(dim=1)
    delta_p = -smv(V_inv, b_p + wt_dc)

    dR, dt = se3_exp(delta_c)
    R_new, t_new = se3_compose(dR, dt, R, t)
    return R_new, t_new, xw + delta_p, chi2, behind, delta2


def lm_chunk_pq(cam, prob: BAProblem, R, t, xw, lam, active, use_huber: bool,
                cfg, n_iters: int):
    """`n_iters` LM iterations on a PQ-layout problem (the reference's
    `make_lm_chunk_pq`), each accepted only when it lowers the robust cost.
    Returns (R, t, xw, lam, inlier) with the inlier classification at the
    exit state."""
    onehot = _cam_onehot(prob)
    for _ in range(n_iters):
        Rn, tn, xwn, chi2, _, delta2 = _cg_lm_step_rcs(
            cam, prob, onehot, R, t, xw, active, lam, use_huber, cfg, cfg.cg_iters)
        cost_old = _total_cost(chi2, active, delta2, use_huber)
        chi2_new, _ = _residual_chi2(cam, prob, Rn, tn, xwn)
        cost_new = _total_cost(chi2_new, active, delta2, use_huber)
        improved = cost_new < cost_old
        R = torch.where(improved, Rn, R)
        t = torch.where(improved, tn, t)
        xw = torch.where(improved, xwn, xw)
        lam = torch.where(improved, lam * 0.5, lam * 4.0)
    return R, t, xw, lam, classify_inliers(cam, prob, R, t, xw, cfg)


# ---------------------------------------------------------------------------
# flat layout: global BA above 128 cameras
# ---------------------------------------------------------------------------
class FlatIndex(NamedTuple):
    """Reduction operands of a flat-layout problem: the [O, C] camera
    one-hot and the [P, Qmax] observation table (-1 pads) of each point."""
    onehot: torch.Tensor
    pt_table: torch.Tensor


def flat_index(prob: BAProblem) -> FlatIndex:
    """Build the reduction operands once per problem (one device -> host
    read for the largest per-point observation count)."""
    P = prob.xw.shape[0]
    pts = torch.where(prob.obs_valid, prob.obs_pt, torch.full_like(prob.obs_pt, P))
    order = torch.argsort(pts, stable=True)                  # valid obs by point, in obs order
    counts = torch.bincount(pts, minlength=P + 1)[:P]
    q_max = max(int(counts.max()), 1) if P else 1
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(order.shape[0], device=pts.device) - starts[pts[order].clamp_max(P - 1)]
    table = torch.full((P + 1, q_max), -1, dtype=torch.int64, device=pts.device)
    keep = pts[order] < P
    table[pts[order][keep], rank[keep]] = order[keep]
    return FlatIndex(_cam_onehot(prob), table[:P])


def _to_points(index: FlatIndex, x):
    """Per-point sums of per-observation rows x [O, k] -> [P, k]."""
    t = index.pt_table
    return (x[t.clamp_min(0)] * (t >= 0)[..., None].to(x.dtype)).sum(dim=1)


def _blocks(cam, prob: BAProblem, index: FlatIndex, R, t, xw, active, lam,
            use_huber: bool, cfg, group=None):
    """Per-iteration block system: damped U, V^-1, per-observation W and the
    gradients (U and b_c summed over the ranks of `group`)."""
    C = prob.R.shape[0]
    P = prob.xw.shape[0]
    O = prob.obs_cam.shape[0]
    r, Jc, Jp, chi2, behind = _residual_jacobians(cam, prob, R, t, xw)
    delta2 = _delta2(prob, chi2, cfg)
    wh = huber_weight(chi2, delta2) if use_huber else torch.ones_like(chi2)
    w = prob.obs_inv_sigma2 * wh * active
    Jc = Jc * prob.cam_free[prob.obs_cam][:, None, None]
    Jcw = Jc * w[:, None, None]
    Jpw = Jp * w[:, None, None]
    oh_t = index.onehot.transpose(0, 1)
    U = _all_reduce((oh_t @ souter(Jcw, Jc).reshape(O, 36)).reshape(C, 6, 6), group)
    V = _to_points(index, souter(Jpw, Jp).reshape(O, 9)).reshape(P, 3, 3)
    b_c = _all_reduce(oh_t @ stmv(Jcw, r), group)
    b_p = _to_points(index, stmv(Jpw, r))
    Wcp = souter(Jcw, Jp)                                            # [O,6,3]
    U_d = _damp(U, lam, 6)
    U_d = torch.where(prob.cam_free[:, None, None], U_d,
                      torch.eye(6, dtype=R.dtype, device=R.device)[None])
    V_inv = _inv3x3(_damp(V, lam, 3))
    return Wcp, U_d, V_inv, b_c, b_p, chi2, behind, delta2


def _cg_lm_step(cam, prob: BAProblem, index: FlatIndex, R, t, xw, active, lam,
                use_huber: bool, cfg, cg_iters: int, group=None):
    """One damped LM step with PCG on the implicit reduced camera system.
    With `group`, points and observations are this rank's shard and every
    camera-side sum is all-reduced; the camera solve is then the same on
    every rank."""
    Wcp, U_d, V_inv, b_c, b_p, chi2, behind, delta2 = _blocks(
        cam, prob, index, R, t, xw, active, lam, use_huber, cfg, group)
    C = prob.R.shape[0]
    free = prob.cam_free[:, None]
    oh_t = index.onehot.transpose(0, 1)

    Vb = smv(V_inv, b_p)
    b_corr = _all_reduce(oh_t @ smv(Wcp, Vb[prob.obs_pt]), group)
    rhs = -(b_c - b_corr) * free

    def S_apply(x):
        """(U_d - W V^-1 W^T) x without materializing S."""
        wtx = _to_points(index, stmv(Wcp, x[prob.obs_cam]))
        corr = _all_reduce(oh_t @ smv(Wcp, smv(V_inv, wtx)[prob.obs_pt]), group)
        return (smv(U_d, x) - corr) * free

    M_inv = _inv6x6_spd(U_d)

    def precond(v):
        return smv(M_inv, v) * free

    x = torch.zeros_like(rhs)
    rr = rhs
    z = precond(rr)
    p = z
    rz = torch.sum(rr * z)
    tiny = torch.full_like(rz, 1e-20)
    zero = torch.zeros_like(rz)
    for _ in range(cg_iters):
        Sp = S_apply(p)
        pSp = torch.sum(p * Sp)
        alpha = rz / torch.where(torch.abs(pSp) < 1e-20, tiny, pSp)
        alive = rz > 1e-18
        alpha = torch.where(alive, alpha, zero)
        x = x + alpha * p
        rr = rr - alpha * Sp
        z = precond(rr)
        rz_new = torch.sum(rr * z)
        beta = torch.where(alive, rz_new / torch.where(rz < 1e-20, tiny, rz), zero)
        p = z + beta * p
        rz = rz_new
    delta_c = x.reshape(C, 6) * free

    wt_dc = _to_points(index, stmv(Wcp, delta_c[prob.obs_cam]))
    delta_p = -smv(V_inv, b_p + wt_dc)
    dR, dt = se3_exp(delta_c)
    R_new, t_new = se3_compose(dR, dt, R, t)
    return R_new, t_new, xw + delta_p, chi2, behind, delta2


def gba_iteration(cam, prob: BAProblem, index: FlatIndex, R, t, xw, lam, active,
                  use_huber: bool, cfg, group=None):
    """One LM iteration of flat-layout global BA (the reference's
    `make_gba_iteration` step), accepted only when it lowers the robust
    cost (summed over the ranks of `group`). Returns (R, t, xw, lam,
    cost_new)."""
    Rn, tn, xwn, chi2, _, delta2 = _cg_lm_step(
        cam, prob, index, R, t, xw, active, lam, use_huber, cfg, cfg.cg_iters, group)
    cost_old = _total_cost(chi2, active, delta2, use_huber)
    chi2_new, _ = _residual_chi2(cam, prob, Rn, tn, xwn)
    cost_new = _total_cost(chi2_new, active, delta2, use_huber)
    if group is not None:
        cost_old, cost_new = _all_reduce(torch.stack([cost_old, cost_new]), group).unbind()
    improved = cost_new < cost_old
    R = torch.where(improved, Rn, R)
    t = torch.where(improved, tn, t)
    xw = torch.where(improved, xwn, xw)
    lam = torch.where(improved, lam * 0.5, lam * 4.0)
    return R, t, xw, lam, cost_new
