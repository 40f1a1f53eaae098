"""Horn closed-form similarity alignment and batched Sim3 RANSAC
(counterpart of orb_slam2_2021_tpu/solvers/horn_sim3.py).

Given matched 3-D points in two camera frames, estimate S12 = (s, R, t) with
x1 ~ s R x2 + t: centroids, the 3x3 correlation, its SVD for the rotation,
the projection ratio for the scale; inliers by the bidirectional
image-space chi2 test.

RANSAC is split in two: `sample_indices` draws the minimal sets from an
explicit `torch.Generator` on the host, and `sim3_ransac` takes them as an
input and scores every hypothesis in one batched pass. The reference draws
its sets with JAX's threefry keys, a stream PyTorch cannot reproduce; the
parity tests feed this solver the reference's own sets.
"""

from __future__ import annotations

import numpy as np
import torch


def sample_indices(valid, m: int, n_hyps: int, generator: torch.Generator) -> torch.Tensor:
    """[n_hyps, m] distinct indices per row, drawn uniformly among the True
    entries of the host mask `valid` [n] (a random-key top-m, CPU int64)."""
    valid = torch.as_tensor(np.asarray(valid, bool))
    keys = torch.rand((n_hyps, valid.shape[0]), generator=generator)
    keys = torch.where(valid[None, :], keys, torch.full_like(keys, 2.0))
    return torch.topk(keys, m, dim=1, largest=False, sorted=True).indices


def det3(A):
    """Batched 3x3 determinant, closed form."""
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]))


def procrustes(M):
    """Rotation maximizing tr(R^T M) for batched [..., 3, 3] M, by SVD with
    the reflection fix. Returns (R, singular values, ok). A non-finite M is
    replaced by zeros and gets ok=False, so a degenerate sample is rejected
    instead of reaching the decomposition."""
    ok = torch.isfinite(M).all(dim=-1).all(dim=-1)
    M = torch.where(ok[..., None, None], M, torch.zeros_like(M))
    U, S, Vh = torch.linalg.svd(M)
    sgn = torch.sign(det3(U @ Vh))
    D = torch.ones(M.shape[:-1], dtype=M.dtype, device=M.device)
    D = torch.cat([D[..., :2], sgn[..., None]], dim=-1)
    return (U * D[..., None, :]) @ Vh, S, ok


def horn_align(x1, x2, fix_scale: bool):
    """Closed-form Sim3 from 3+ correspondences, batched over leading dims:
    x1, x2 [..., M, 3] -> (s, R, t, ok) with x1 ~ s R x2 + t."""
    c1 = x1.mean(dim=-2)
    c2 = x2.mean(dim=-2)
    p1 = x1 - c1[..., None, :]
    p2 = x2 - c2[..., None, :]
    R, _, ok = procrustes(torch.einsum("...ni,...nj->...ij", p1, p2))
    Rp2 = torch.einsum("...ij,...nj->...ni", R, p2)
    num = torch.sum(p1 * Rp2, dim=(-1, -2))
    den = torch.sum(p2 * p2, dim=(-1, -2))
    s = torch.ones_like(num) if fix_scale else num / torch.clamp_min(den, 1e-12)
    t = c1 - s[..., None] * torch.einsum("...ij,...j->...i", R, c2)
    return s, R, t, ok


def _project(fx, fy, cx, cy, x):
    z = torch.clamp_min(x[..., 2], 1e-9)
    return torch.stack([fx * x[..., 0] / z + cx, fy * x[..., 1] / z + cy], dim=-1)


def _inliers(s, R, t, x1, x2, uv1, uv2, sigma2_1, sigma2_2, valid, fx, fy, cx, cy, chi2_th):
    """Bidirectional reprojection inliers of S12 (batched over leading dims
    of s, R, t) -> [..., N] bool."""
    x2_in1 = s[..., None, None] * torch.einsum("...ij,nj->...ni", R, x2) + t[..., None, :]
    sinv = 1.0 / torch.clamp_min(s, 1e-12)
    Rinv = R.transpose(-1, -2)
    tinv = -sinv[..., None] * torch.einsum("...ij,...j->...i", Rinv, t)
    x1_in2 = sinv[..., None, None] * torch.einsum("...ij,nj->...ni", Rinv, x1) + tinv[..., None, :]
    e1 = torch.sum((uv1 - _project(fx, fy, cx, cy, x2_in1)) ** 2, dim=-1)
    e2 = torch.sum((uv2 - _project(fx, fy, cx, cy, x1_in2)) ** 2, dim=-1)
    return valid & (e1 < chi2_th * sigma2_1) & (e2 < chi2_th * sigma2_2)


def sim3_ransac(idx, x1, x2, uv1, uv2, sigma2_1, sigma2_2, valid,
                fx, fy, cx, cy, fix_scale: bool, chi2_th: float = 9.21):
    """3-point RANSAC over the minimal sets idx [H, 3], then a weighted Horn
    refit on the best hypothesis's inliers. Returns (s, R, t, inliers [N],
    n_inliers) with x1 ~ s R x2 + t."""
    args = (x1, x2, uv1, uv2, sigma2_1, sigma2_2, valid, fx, fy, cx, cy, chi2_th)
    s, R, t, ok = horn_align(x1[idx], x2[idx], fix_scale)               # [H], [H,3,3], [H,3]
    counts = torch.where(ok, _inliers(s, R, t, *args).sum(dim=1), torch.zeros_like(ok, dtype=torch.int64))
    best = torch.argmax(counts)
    inl = _inliers(s[best], R[best], t[best], *args)

    # weighted Horn on the best hypothesis's inliers
    w = inl.to(x1.dtype)
    wsum = torch.clamp_min(w.sum(), 3.0)
    c1 = torch.sum(x1 * w[:, None], dim=0) / wsum
    c2 = torch.sum(x2 * w[:, None], dim=0) / wsum
    p1 = (x1 - c1) * w[:, None]
    p2 = (x2 - c2) * w[:, None]
    Rr, _, _ = procrustes(p1.transpose(0, 1) @ p2)
    Rp2 = p2 @ Rr.transpose(0, 1)
    if fix_scale:
        sr = torch.ones((), dtype=x1.dtype, device=x1.device)
    else:
        sr = torch.sum(p1 * Rp2) / torch.clamp_min(torch.sum(p2 * p2), 1e-12)
    tr = c1 - sr * (Rr @ c2)
    inl = _inliers(sr, Rr, tr, *args)
    return sr, Rr, tr, inl, inl.sum()
