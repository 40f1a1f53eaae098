"""Sim(3) optimizers: relative refinement and the essential-graph pose graph
(counterpart of orb_slam2_2021_tpu/optim/sim3_opt.py).

- optimize_sim3_relative: one 7-DoF similarity refined over bidirectional
  reprojection residuals, damped Gauss-Newton with Huber(sqrt(10)) and the
  chi2 > 10 outlier gate between rounds.
- essential_graph_solve: Sim3 pose graph over all keyframes. Per-edge
  residual e = log(S_meas^-1 S_i S_j^-1) with left-multiplicative updates;
  7x14 Jacobians by forward-mode autodiff; LM whose normal equations are
  solved by Jacobi-preconditioned CG over the [K, 7] tangent stack.
  Edge-to-vertex sums are products with the [E, K] one-hot incidence, so
  the solve repeats exactly on the card.

Forward mode (`_jacobian`) pushes the 7 basis tangents through the batched
function at once (`vmap` of `jvp`): each edge's residual depends only on its
own twist, so one pass gives every edge's 7x7 block. The reference's
`jax.jacfwd` under `vmap` computes the same blocks; `torch.func.jacfwd`
under `vmap` is not used because it promotes 0-dim per-sample tensors to
float64 when they meet Python scalars.

Every accept/reject is a `torch.where`: a solve never waits for the device.
fix_scale=True (stereo) zeroes the log-scale component of every update.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jvp, vmap

from ..geometry.sim3 import sim3_compose, sim3_exp, sim3_inverse, sim3_log


def _jacobian(f, x):
    """d f(x)[e] / d x[e] for a row-wise function f: [E, n] -> [E, m]:
    the [E, m, n] per-row Jacobians by forward mode."""
    n = x.shape[-1]
    basis = torch.eye(n, dtype=x.dtype, device=x.device)[:, None, :].expand(n, *x.shape)
    return vmap(lambda v: jvp(f, (x,), (v,))[1], out_dims=-1)(basis)


def optimize_sim3_relative(s0, R0, t0, x1, x2, uv1, uv2, inv_sigma2_1, inv_sigma2_2, valid,
                           fx, fy, cx, cy, fix_scale: bool, iters: int = 10,
                           chi2_th: float = 10.0):
    """Returns (s, R, t, inliers, n_inliers) with x1 ~ s R x2 + t."""

    def residuals(s, R, t):
        x2_in1 = s[..., None, None] * torch.einsum("...ij,nj->...ni", R, x2) + t[..., None, :]
        si, Ri, ti = sim3_inverse(s, R, t)
        x1_in2 = si[..., None, None] * torch.einsum("...ij,nj->...ni", Ri, x1) + ti[..., None, :]

        def proj(x):
            z = torch.where(torch.abs(x[..., 2]) < 1e-9, torch.full_like(x[..., 2], 1e-9), x[..., 2])
            return torch.stack([fx * x[..., 0] / z + cx, fy * x[..., 1] / z + cy], dim=-1)

        return uv1 - proj(x2_in1), uv2 - proj(x1_in2)

    def chi2s(s, R, t):
        r1, r2 = residuals(s, R, t)
        return torch.sum(r1 * r1, dim=-1) * inv_sigma2_1, torch.sum(r2 * r2, dim=-1) * inv_sigma2_2

    eye7 = torch.eye(7, dtype=x1.dtype, device=x1.device)
    w_is2 = torch.cat([inv_sigma2_1, inv_sigma2_2])

    def gn_round(s, R, t, active, n_iters, use_huber):
        lam = torch.tensor(1e-4, dtype=x1.dtype, device=x1.device)
        act2 = torch.cat([active, active])
        for _ in range(n_iters):
            def r_of_delta(delta):                                       # [1, 7] -> [1, 4N]
                r1, r2 = residuals(*sim3_compose(*sim3_exp(delta), s, R, t))
                return torch.cat([r1, r2], dim=-2).reshape(1, -1)

            zero = torch.zeros((1, 7), dtype=x1.dtype, device=x1.device)
            r0 = r_of_delta(zero).reshape(-1, 2)                         # [2N, 2]
            J = _jacobian(r_of_delta, zero).reshape(-1, 2, 7)            # [2N, 2, 7]
            chi = torch.sum(r0 * r0, dim=-1) * w_is2
            if use_huber:
                wh = torch.where(chi <= chi2_th, torch.ones_like(chi),
                                 torch.sqrt(chi2_th / torch.clamp_min(chi, 1e-12)))
            else:
                wh = torch.ones_like(chi)
            w = w_is2 * wh * act2
            H = torch.einsum("nik,n,nil->kl", J, w, J)
            b = torch.einsum("nik,n,ni->k", J, w, r0)
            if fix_scale:
                keep = torch.ones(7, dtype=x1.dtype, device=x1.device)
                keep[6] = 0.0
                H = H * keep[:, None] * keep[None, :] + torch.diag(1.0 - keep)
                b = b * keep
            delta = -torch.linalg.solve_ex(H + lam * eye7, b)[0]
            sn, Rn, tn = sim3_compose(*sim3_exp(delta), s, R, t)
            cost_old = torch.sum(chi * wh * act2)
            c1n, c2n = chi2s(sn, Rn, tn)
            cost_new = torch.sum(torch.cat([c1n, c2n]) * act2)
            improved = cost_new < cost_old
            s = torch.where(improved, sn, s)
            R = torch.where(improved, Rn, R)
            t = torch.where(improved, tn, t)
            lam = torch.where(improved, lam * 0.5, lam * 4.0)
        return s, R, t

    s, R, t = gn_round(s0, R0, t0, valid.to(x1.dtype), iters // 2, True)
    c1, c2 = chi2s(s, R, t)
    inlier = valid & (c1 <= chi2_th) & (c2 <= chi2_th)
    s, R, t = gn_round(s, R, t, inlier.to(x1.dtype), iters, False)
    c1, c2 = chi2s(s, R, t)
    inlier = valid & (c1 <= chi2_th) & (c2 <= chi2_th)
    return s, R, t, inlier, inlier.sum()


class PoseGraph(NamedTuple):
    s: torch.Tensor        # [K]
    R: torch.Tensor        # [K, 3, 3]  (S_iw: world -> camera i)
    t: torch.Tensor        # [K, 3]
    edge_i: torch.Tensor   # [E] int64
    edge_j: torch.Tensor   # [E] int64
    # measured relative S_ij = S_i S_j^-1 at edge creation
    m_s: torch.Tensor      # [E]
    m_R: torch.Tensor      # [E, 3, 3]
    m_t: torch.Tensor      # [E, 3]
    weight: torch.Tensor   # [E] float32 (0 = padding)
    fixed: torch.Tensor    # [K] bool


def _edge_residual(delta_i, delta_j, si, Ri, ti, sj, Rj, tj, ms, mR, mt):
    """e = log(M^-1 (exp(di) S_i) (exp(dj) S_j)^-1): [..., 7]."""
    s_i, R_i, t_i = sim3_compose(*sim3_exp(delta_i), si, Ri, ti)
    s_j, R_j, t_j = sim3_compose(*sim3_exp(delta_j), sj, Rj, tj)
    rel = sim3_compose(s_i, R_i, t_i, *sim3_inverse(s_j, R_j, t_j))
    return sim3_log(*sim3_compose(*sim3_inverse(ms, mR, mt), *rel))


def essential_graph_solve(g: PoseGraph, fix_scale: bool, n_lm_iters: int = 20,
                          cg_iters: int = 40):
    """LM over the Sim3 pose graph; returns the updated (s, R, t)."""
    K = g.s.shape[0]
    E = g.edge_i.shape[0]
    dev, dt_ = g.s.device, g.s.dtype
    zero = torch.zeros((E, 7), dtype=dt_, device=dev)
    verts = torch.arange(K, device=dev)
    inc_i = (g.edge_i[:, None] == verts[None, :]).to(dt_)               # [E, K]
    inc_j = (g.edge_j[:, None] == verts[None, :]).to(dt_)
    scale_mask = torch.ones(7, dtype=dt_, device=dev)
    if fix_scale:
        scale_mask[6] = 0.0
    mask = (~g.fixed).to(dt_)[:, None] * scale_mask[None]                # [K, 7]
    w = g.weight

    def edge_args(s, R, t):
        return (s[g.edge_i], R[g.edge_i], t[g.edge_i], s[g.edge_j], R[g.edge_j], t[g.edge_j],
                g.m_s, g.m_R, g.m_t)

    def to_vertices(xi, xj):
        return inc_i.transpose(0, 1) @ xi + inc_j.transpose(0, 1) @ xj

    s, R, t = g.s, g.R, g.t
    lam = torch.tensor(1e-4, dtype=dt_, device=dev)
    for _ in range(n_lm_iters):
        args = edge_args(s, R, t)
        r = _edge_residual(zero, zero, *args)                            # [E, 7]
        Ji = _jacobian(lambda d: _edge_residual(d, zero, *args), zero)   # [E, 7, 7]
        Jj = _jacobian(lambda d: _edge_residual(zero, d, *args), zero)
        grad = to_vertices(torch.einsum("eik,e,ei->ek", Ji, w, r),
                           torch.einsum("eik,e,ei->ek", Jj, w, r)) * mask
        raw_diag = to_vertices(torch.einsum("eik,e,eik->ek", Ji, w, Ji),
                               torch.einsum("eik,e,eik->ek", Jj, w, Jj))
        damp = lam * torch.clamp_min(raw_diag, 1e-6)
        diag = raw_diag + damp + 1e-8

        def Hv(v):
            v = v * mask
            u = (torch.einsum("eik,ek->ei", Ji, v[g.edge_i])
                 + torch.einsum("eik,ek->ei", Jj, v[g.edge_j])) * w[:, None]
            out = to_vertices(torch.einsum("eik,ei->ek", Ji, u), torch.einsum("eik,ei->ek", Jj, u))
            return (out + damp * v) * mask

        b = -grad
        x = torch.zeros_like(b)
        rr = b
        p = b / diag
        for _ in range(cg_iters):
            Ap = Hv(p)
            pAp = torch.sum(p * Ap)
            rz = torch.sum(rr * (rr / diag))
            alpha = rz / torch.clamp_min(pAp, 1e-12)
            x = x + alpha * p
            rr = rr - alpha * Ap
            rz_new = torch.sum(rr * (rr / diag))
            p = rr / diag + (rz_new / torch.clamp_min(rz, 1e-12)) * p
        delta = x * mask

        sn, Rn, tn = sim3_compose(*sim3_exp(delta), s, R, t)
        cost_old = torch.sum(torch.sum(r * r, dim=-1) * w)
        rn = _edge_residual(zero, zero, *edge_args(sn, Rn, tn))
        cost_new = torch.sum(torch.sum(rn * rn, dim=-1) * w)
        improved = cost_new < cost_old
        s = torch.where(improved, sn, s)
        R = torch.where(improved, Rn, R)
        t = torch.where(improved, tn, t)
        lam = torch.where(improved, lam * 0.5, lam * 4.0)
    return s, R, t
