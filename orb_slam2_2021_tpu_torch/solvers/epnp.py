"""Camera pose from scratch for relocalization: batched PnP RANSAC
(counterpart of orb_slam2_2021_tpu/solvers/epnp.py).

Every minimal sample of 6 matches yields two candidates: a normalized DLT
(12x12 symmetric eigenproblem) and a plane-induced homography decomposition
(9x9 eigenproblem), exact on planar scenes where the DLT's null space is
rank-deficient; the better-scoring one wins. All samples are one batched
pass over [n_hyps, 6] indices drawn on the host (`horn_sim3.sample_indices`),
then the winner is re-solved twice on its weighted inlier set.

A degenerate sample gives a rejected hypothesis: non-finite normal
equations are replaced by the identity before the decomposition, and the
candidate scores zero. The eigenproblems run in float64 (`EIG_DTYPE`);
everything else stays float32, as in the reference.
"""

from __future__ import annotations

import torch

from .horn_sim3 import procrustes

MIN_SAMPLE = 6
# The eigenproblems run in float64. In float32, cuSOLVER's batched (Jacobi)
# eigensolver loses the null vector of the badly scaled 12x12 DLT systems of
# minimal sets (eigenvalues over six decades): on an H100 the best of 256
# hypotheses scored 31 inliers where LAPACK's scored 434. In float64 both
# devices score every DLT hypothesis alike. float32 is the reference's
# precision: the parity tests set it to hold the algorithm to the reference.
EIG_DTYPE = torch.float64


def _safe_sym(A):
    """(A with non-finite matrices replaced by the identity, finite mask)."""
    ok = torch.isfinite(A).all(dim=-1).all(dim=-1)
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(A.shape)
    return torch.where(ok[..., None, None], A, eye), ok


def _pose_from_p(p, Xh):
    """Projective [..., 3, 4] -> (R, t, ok) by sign fix + orthonormalization."""
    z_proj = torch.einsum("...nj,...j->...n", Xh, p[..., 2, :])
    flip = torch.sum(z_proj > 0, dim=-1) < torch.sum(z_proj < 0, dim=-1)
    p = torch.where(flip[..., None, None], -p, p)
    R, S, ok = procrustes(p[..., :3])
    scale = S.mean(dim=-1)
    t = p[..., 3] / torch.clamp_min(scale, 1e-12)[..., None]
    return R, t, ok & (scale > 1e-9)


def _eigh(A):
    """eigh of symmetric matrices computed in EIG_DTYPE, returned in A's
    dtype."""
    lam, vecs = torch.linalg.eigh(A.to(EIG_DTYPE))
    return lam.to(A.dtype), vecs.to(A.dtype)


def _smallest_eigvec(AtA):
    """Eigenvector of the smallest eigenvalue of batched symmetric matrices."""
    A, ok = _safe_sym(AtA)
    _, vecs = _eigh(A)
    return vecs[..., :, 0], ok


def _dlt_pose_n(xw, xn, yn, w):
    """Weighted N-point DLT: [..., N, 3] world, [..., N] normalized pixel
    coordinates and weights (0 drops the row) -> (R, t, ok)."""
    ones = torch.ones_like(xn)[..., None]
    zeros = torch.zeros_like(xw[..., :1]).expand(*xw.shape[:-1], 4)
    Xh = torch.cat([xw, ones], dim=-1)                                    # [...,N,4]
    rows_u = torch.cat([Xh, zeros, -xn[..., None] * Xh], dim=-1)
    rows_v = torch.cat([zeros, Xh, -yn[..., None] * Xh], dim=-1)
    A = torch.cat([rows_u * w[..., None], rows_v * w[..., None]], dim=-2)  # [...,2N,12]
    v, ok = _smallest_eigvec(A.transpose(-1, -2) @ A)
    R, t, okp = _pose_from_p(v.reshape(*v.shape[:-1], 3, 4), Xh)
    return R, t, ok & okp


def _plane_frame(xw, w):
    """Weighted plane fit: (centroid, E [..., 3, 3] columns e1|e2|n,
    planarity = 1 - lam_min / lam_mid)."""
    ws = torch.clamp_min(w.sum(dim=-1), 1e-9)
    c = torch.sum(xw * w[..., None], dim=-2) / ws[..., None]
    d = (xw - c[..., None, :]) * w[..., None]
    C, _ = _safe_sym(d.transpose(-1, -2) @ d / ws[..., None, None])
    lam, V = _eigh(C)
    E = torch.stack([V[..., :, 2], V[..., :, 1], V[..., :, 0]], dim=-1)
    planarity = 1.0 - lam[..., 0] / torch.clamp_min(lam[..., 1], 1e-12)
    return c, E, planarity


def _homography_pose(xw, xn, yn, w):
    """Plane-induced pose: plane fit, 9x9 DLT homography plane ->
    normalized image, H = [r1 r2 t] decomposed into a rigid pose."""
    c, E, _ = _plane_frame(xw, w)
    uvp = torch.einsum("...ji,...nj->...ni", E, xw - c[..., None, :])     # E^T (x - c)
    a, b = uvp[..., 0], uvp[..., 1]
    ones = torch.ones_like(a)
    zer = torch.zeros_like(a)
    Ph = torch.stack([a, b, ones], dim=-1)
    rows_u = torch.stack([a, b, ones, zer, zer, zer, -xn * a, -xn * b, -xn], dim=-1)
    rows_v = torch.stack([zer, zer, zer, a, b, ones, -yn * a, -yn * b, -yn], dim=-1)
    A = torch.cat([rows_u * w[..., None], rows_v * w[..., None]], dim=-2)
    v, ok = _smallest_eigvec(A.transpose(-1, -2) @ A)
    H = v.reshape(*v.shape[:-1], 3, 3)
    z_proj = torch.einsum("...nj,...j->...n", Ph, H[..., 2, :])
    flip = torch.sum(z_proj > 0, dim=-1) < torch.sum(z_proj < 0, dim=-1)
    H = torch.where(flip[..., None, None], -H, H)
    h1, h2, h3 = H[..., :, 0], H[..., :, 1], H[..., :, 2]
    n1 = torch.linalg.vector_norm(h1, dim=-1)
    s = torch.sqrt(torch.clamp_min(n1 * torch.linalg.vector_norm(h2, dim=-1), 1e-18))
    r1 = h1 / torch.clamp_min(n1, 1e-12)[..., None]
    r2 = h2 - r1 * torch.sum(r1 * h2, dim=-1, keepdim=True)
    r2 = r2 / torch.clamp_min(torch.linalg.vector_norm(r2, dim=-1), 1e-12)[..., None]
    r3 = torch.linalg.cross(r1, r2, dim=-1)
    Rp = torch.stack([r1, r2, r3], dim=-1)
    tp = h3 / s[..., None]
    R = Rp @ E.transpose(-1, -2)
    t = tp - torch.einsum("...ij,...j->...i", R, c)
    return R, t, ok & (s > 1e-9)


def epnp_ransac(idx, xw, uv, sigma2, valid, fx, fy, cx, cy,
                chi2_th: float = 5.991, refine_rounds: int = 2):
    """PnP RANSAC over the minimal sets idx [H, 6], plus the inlier refine.
    Returns (R, t, inliers [N], n_inliers)."""
    xn_all = (uv[:, 0] - cx) / fx
    yn_all = (uv[:, 1] - cy) / fy

    def reproj_inliers(R, t):
        Xc = torch.einsum("...ij,nj->...ni", R, xw) + t[..., None, :]
        z = Xc[..., 2]
        zsafe = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        u = fx * Xc[..., 0] / zsafe + cx
        v = fy * Xc[..., 1] / zsafe + cy
        e = (u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2
        return valid & (z > 0) & (e < chi2_th * sigma2)

    def best_of_two(xs, xns, yns, w):
        Rd, td, okd = _dlt_pose_n(xs, xns, yns, w)
        Rh, th, okh = _homography_pose(xs, xns, yns, w)
        zero = torch.zeros_like(okd, dtype=torch.int64)
        cd = torch.where(okd, reproj_inliers(Rd, td).sum(dim=-1), zero)
        ch = torch.where(okh, reproj_inliers(Rh, th).sum(dim=-1), zero)
        use_h = ch > cd
        R = torch.where(use_h[..., None, None], Rh, Rd)
        t = torch.where(use_h[..., None], th, td)
        return torch.maximum(cd, ch), R, t

    w = torch.ones(idx.shape, dtype=xw.dtype, device=xw.device)
    counts, Rs, ts = best_of_two(xw[idx], xn_all[idx], yn_all[idx], w)
    best = torch.argmax(counts)
    R, t = Rs[best], ts[best]
    inl = reproj_inliers(R, t)

    # re-solve on the weighted inlier set; keep it unless it loses inliers
    for _ in range(refine_rounds):
        w = inl.to(xw.dtype) / torch.sqrt(sigma2)
        cn, Rn, tn = best_of_two(xw, xn_all, yn_all, w)
        better = cn >= inl.sum()
        R = torch.where(better, Rn, R)
        t = torch.where(better, tn, t)
        inl = reproj_inliers(R, t)
    return R, t, inl, inl.sum()
