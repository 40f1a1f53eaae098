"""Monocular two-view bootstrap (counterpart of
orb_slam2_2021_tpu/solvers/two_view.py).

From matched keypoints of two frames: a homography H and a fundamental
matrix F for every minimal set of 8 matches in one batched pass, scored by
their symmetric transfer errors; H is chosen when SH / (SH + SF) > 0.40. The
chosen family's best hypothesis is refit on its inliers, decomposed (F into
the 4 motions of E = K^T F K, H into Faugeras' 8), and every motion is
checked for cheirality by triangulating all matches at once.

As in the other RANSAC solvers, the minimal sets are an input ([n_hyps, 8]
indices, drawn by the caller from a seeded `torch.Generator`): the
reference's threefry stream cannot be reproduced, and the parity tests feed
the reference's own sets. The eigenproblems run in `EIG_DTYPE` (float64);
everything else stays float32, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

SIGMA = 1.0
TH_H = 5.991
TH_F_SCORE = 5.991
TH_F = 3.841
MIN_SET = 8
# The minimal DLT systems are badly scaled (eigenvalues over many decades),
# the kind cuSOLVER's batched float32 eigensolver lost the null vector of in
# the EPnP RANSAC (solvers/epnp.py). float32 is the reference's precision:
# the parity tests set it to hold the algorithm to the reference.
EIG_DTYPE = torch.float64


class TwoViewResult(NamedTuple):
    ok: torch.Tensor       # scalar bool
    used_h: torch.Tensor   # scalar bool
    R: torch.Tensor        # [3, 3] pose of frame 2 in frame 1's coordinates
    t: torch.Tensor        # [3] unit-norm translation
    points: torch.Tensor   # [N, 3] triangulated in frame-1 coordinates
    good: torch.Tensor     # [N] bool


def _smallest_eigvec(A):
    """Eigenvector of the smallest eigenvalue of batched symmetric matrices,
    solved in EIG_DTYPE and returned in A's dtype."""
    _, vecs = torch.linalg.eigh(A.to(EIG_DTYPE))
    return vecs[..., :, 0].to(A.dtype)


def _normalize(p):
    """Hartley-style normalization: [N, 2] -> normalized points, 3x3 T."""
    mean = p.mean(dim=0)
    s = 1.0 / (torch.abs(p - mean).mean(dim=0) + 1e-9)
    one, zero = torch.ones_like(s[0]), torch.zeros_like(s[0])
    T = torch.stack([torch.stack([s[0], zero, -mean[0] * s[0]]),
                     torch.stack([zero, s[1], -mean[1] * s[1]]),
                     torch.stack([zero, zero, one])])
    return (p - mean) * s, T


def _dlt_h(p1, p2, w):
    """Homography DLT (p2 ~ H p1) over [..., n, 2] points with per-point
    weights [..., n]."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    z, o = torch.zeros_like(x1), torch.ones_like(x1)
    rows_a = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], dim=-1)
    rows_b = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    A = torch.cat([rows_a, rows_b], dim=-2)
    ww = torch.cat([w, w], dim=-1)
    v = _smallest_eigvec(torch.einsum("...ni,...n,...nj->...ij", A, ww, A))
    return v.reshape(*v.shape[:-1], 3, 3)


def _eight_point_f(p1, p2, w):
    """8-point fundamental matrix (p2^T F p1 = 0) over [..., n, 2] points
    with weights [..., n], rank 2 enforced."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    o = torch.ones_like(x1)
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, o], dim=-1)
    v = _smallest_eigvec(torch.einsum("...ni,...n,...nj->...ij", A, w, A))
    F = v.reshape(*v.shape[:-1], 3, 3)
    U, S, Vh = torch.linalg.svd(F)
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return (U * S[..., None, :]) @ Vh


def _hom(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _transfer(M, a):
    """[..., 3, 3] maps applied to [N, 2] points -> [..., N, 2]."""
    b = torch.einsum("...ij,nj->...ni", M, _hom(a))
    w = b[..., 2:3]
    return b[..., :2] / torch.where(torch.abs(w) < 1e-9, torch.full_like(w, 1e-9), w)


def _score_h(H, p1, p2, valid, sigma2):
    """CheckHomography: symmetric transfer chi2 score and inliers, batched
    over H's leading dims."""
    e12 = torch.sum((p2 - _transfer(H, p1)) ** 2, dim=-1) / sigma2
    e21 = torch.sum((p1 - _transfer(torch.linalg.inv(H), p2)) ** 2, dim=-1) / sigma2
    in12 = (e12 < TH_H) & valid
    in21 = (e21 < TH_H) & valid
    zero = torch.zeros_like(e12)
    score = torch.where(in12, TH_H - e12, zero).sum(dim=-1) + torch.where(in21, TH_H - e21, zero).sum(dim=-1)
    return score, in12 & in21


def _score_f(F, p1, p2, valid, sigma2):
    """CheckFundamental: epipolar distance chi2 score and inliers."""
    p1h, p2h = _hom(p1), _hom(p2)
    l2 = torch.einsum("...ij,nj->...ni", F, p1h)    # lines in image 2
    l1 = torch.einsum("...ji,nj->...ni", F, p2h)    # lines in image 1
    d2 = torch.sum(l2 * p2h, dim=-1) ** 2 / (l2[..., 0] ** 2 + l2[..., 1] ** 2 + 1e-12)
    d1 = torch.sum(l1 * p1h, dim=-1) ** 2 / (l1[..., 0] ** 2 + l1[..., 1] ** 2 + 1e-12)
    c2, c1 = d2 / sigma2, d1 / sigma2
    in2 = (c2 < TH_F) & valid
    in1 = (c1 < TH_F) & valid
    zero = torch.zeros_like(c1)
    score = (torch.where(in2, TH_F_SCORE - c2, zero).sum(dim=-1)
             + torch.where(in1, TH_F_SCORE - c1, zero).sum(dim=-1))
    return score, in1 & in2


def _normalize_h(H):
    h22 = H[..., 2:3, 2:3]
    return H / torch.where(torch.abs(h22) < 1e-9, torch.full_like(h22, 1e-9), h22)


def _check_rt(Rs, ts, xn1, xn2, valid, fx, fy, sigma2, th2=4.0):
    """CheckRT for M motions at once: triangulate every match (one 4x4
    eigenproblem each), count the good points (finite, in front of both
    cameras, reprojection error, parallax). Returns (n_good [M], good
    [M, N], X [M, N, 3], representative parallax cosine [M])."""
    M, N = Rs.shape[0], xn1.shape[0]
    P1 = torch.cat([torch.eye(3, dtype=Rs.dtype, device=Rs.device),
                    torch.zeros(3, 1, dtype=Rs.dtype, device=Rs.device)], dim=1)
    P2 = torch.cat([Rs, ts[..., None]], dim=2)                               # [M, 3, 4]
    A = torch.stack([
        xn1[:, 0:1] * P1[2] - P1[0],
        xn1[:, 1:2] * P1[2] - P1[1],
    ], dim=1).expand(M, N, 2, 4)
    B = torch.stack([
        xn2[None, :, 0:1] * P2[:, None, 2] - P2[:, None, 0],
        xn2[None, :, 1:2] * P2[:, None, 2] - P2[:, None, 1],
    ], dim=2)                                                                 # [M, N, 2, 4]
    A = torch.cat([A, B], dim=2)
    xh = _smallest_eigvec(A.transpose(-1, -2) @ A)                            # [M, N, 4]
    w = xh[..., 3]
    X = xh[..., :3] / torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)[..., None]
    z1 = X[..., 2]
    Xc2 = torch.einsum("mij,mnj->mni", Rs, X) + ts[:, None, :]
    z2 = Xc2[..., 2]
    finite = torch.isfinite(X).all(dim=-1)
    O2 = -torch.einsum("mji,mj->mi", Rs, ts)
    r2 = X - O2[:, None, :]
    cosp = torch.sum(X * r2, dim=-1) / (
        torch.linalg.vector_norm(X, dim=-1) * torch.linalg.vector_norm(r2, dim=-1) + 1e-12)
    e1 = ((X[..., 0] / torch.clamp_min(z1, 1e-9) - xn1[:, 0]) ** 2
          + (X[..., 1] / torch.clamp_min(z1, 1e-9) - xn1[:, 1]) ** 2) * fx * fy / sigma2
    e2 = ((Xc2[..., 0] / torch.clamp_min(z2, 1e-9) - xn2[:, 0]) ** 2
          + (Xc2[..., 1] / torch.clamp_min(z2, 1e-9) - xn2[:, 1]) ** 2) * fx * fy / sigma2
    good = valid & finite & (z1 > 0) & (z2 > 0) & (cosp < 0.99998) & (e1 < th2) & (e2 < th2)
    # representative parallax: the 50th smallest angle's cosine among the good
    cos_sorted = torch.sort(torch.where(good, cosp, torch.ones_like(cosp)), dim=-1).values
    n_good = good.sum(dim=-1)
    idx = torch.clamp(n_good - 1, 0, 50)
    pcos = torch.gather(cos_sorted, 1, idx[:, None])[:, 0]
    return n_good, good, X, pcos


def _motions_f(F, K):
    """The 4 motions of E = K^T F K (and 4 dead pad slots)."""
    E = K.T @ F @ K
    U, _, Vh = torch.linalg.svd(E)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]], dtype=F.dtype, device=F.device)
    Ra = U @ W @ Vh
    Rb = U @ W.T @ Vh
    Ra = Ra * torch.sign(torch.linalg.det(Ra))
    Rb = Rb * torch.sign(torch.linalg.det(Rb))
    tf = U[:, 2] / (torch.linalg.vector_norm(U[:, 2]) + 1e-12)
    eye = torch.eye(3, dtype=F.dtype, device=F.device)
    zero = torch.zeros_like(tf)
    Rs = torch.stack([Ra, Ra, Rb, Rb, eye, eye, eye, eye])
    ts = torch.stack([tf, -tf, tf, -tf, zero, zero, zero, zero])
    live = torch.tensor([1, 1, 1, 1, 0, 0, 0, 0], dtype=torch.int64, device=F.device)
    return Rs, ts, live


def _motions_h(H, K, Kinv):
    """Faugeras and Lustman's 8 motions of A = K^-1 H K."""
    U, d, Vh = torch.linalg.svd(Kinv @ H @ K)
    sdet = torch.linalg.det(U) * torch.linalg.det(Vh)
    d1, d2, d3 = d[0], d[1], d[2]
    denom = torch.clamp_min(d1 * d1 - d3 * d3, 1e-12)
    x1m = torch.sqrt(torch.clamp_min((d1 * d1 - d2 * d2) / denom, 1e-12))
    x3m = torch.sqrt(torch.clamp_min((d2 * d2 - d3 * d3) / denom, 1e-12))
    d2c = torch.clamp_min(d2, 1e-12)
    one, zero = torch.ones_like(d1), torch.zeros_like(d1)
    Rs, ts = [], []
    for plus in (True, False):
        for e1 in (1.0, -1.0):
            for e3 in (1.0, -1.0):
                x1, x3 = e1 * x1m, e3 * x3m
                if plus:   # d' = +d2
                    st = (d1 - d3) * x1 * x3 / d2c
                    ct = (d1 * x3 * x3 + d3 * x1 * x1) / d2c
                    Rp = torch.stack([torch.stack([ct, zero, -st]), torch.stack([zero, one, zero]),
                                      torch.stack([st, zero, ct])])
                    tp = torch.stack([x1, zero, -x3]) * (d1 - d3)
                else:      # d' = -d2
                    sp = (d1 + d3) * x1 * x3 / d2c
                    cp = (d3 * x1 * x1 - d1 * x3 * x3) / d2c
                    Rp = torch.stack([torch.stack([cp, zero, sp]), torch.stack([zero, -one, zero]),
                                      torch.stack([sp, zero, -cp])])
                    tp = torch.stack([x1, zero, x3]) * (d1 + d3)
                Rs.append(sdet * U @ Rp @ Vh)
                ts.append(U @ tp)
    ts = torch.stack(ts)
    ts = ts / (torch.linalg.vector_norm(ts, dim=1, keepdim=True) + 1e-12)
    return torch.stack(Rs), ts, torch.ones(8, dtype=torch.int64, device=H.device)


def two_view_init(idx, p1, p2, valid, fx, fy, cx, cy,
                  min_good: int = 50, min_parallax_cos: float = 0.9995) -> TwoViewResult:
    """The full bootstrap from matched pixels p1, p2 [N, 2] (frame 1, frame
    2) with their mask `valid` [N], over the minimal sets idx [n_hyps, 8]."""
    n = p1.shape[0]
    dt, dev = p1.dtype, p1.device
    sigma2 = SIGMA * SIGMA
    p1n, T1 = _normalize(p1)
    p2n, T2 = _normalize(p2)
    T2inv = torch.linalg.inv(T2)

    ones = torch.ones(idx.shape, dtype=dt, device=dev)
    Hs = _normalize_h(T2inv @ _dlt_h(p1n[idx], p2n[idx], ones) @ T1)          # [H, 3, 3]
    Fs = T2.T @ _eight_point_f(p1n[idx], p2n[idx], ones) @ T1
    sh, _ = _score_h(Hs, p1, p2, valid, sigma2)
    sf, _ = _score_f(Fs, p1, p2, valid, sigma2)
    bh, bf = torch.argmax(sh), torch.argmax(sf)
    H, F = Hs[bh], Fs[bf]
    use_h = sh[bh] / torch.clamp_min(sh[bh] + sf[bf], 1e-9) > 0.40

    # refit the selected hypotheses on all their inliers
    _, inl_h = _score_h(H, p1, p2, valid, sigma2)
    _, inl_f = _score_f(F, p1, p2, valid, sigma2)
    H = _normalize_h(T2inv @ _dlt_h(p1n, p2n, inl_h.to(dt)) @ T1)
    F = T2.T @ _eight_point_f(p1n, p2n, inl_f.to(dt)) @ T1
    _, inl_h = _score_h(H, p1, p2, valid, sigma2)
    _, inl_f = _score_f(F, p1, p2, valid, sigma2)

    K = torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], dtype=dt, device=dev)
    Kinv = torch.linalg.inv(K)
    xn1 = (_hom(p1) @ Kinv.T)[:, :2]
    xn2 = (_hom(p2) @ Kinv.T)[:, :2]

    f_Rs, f_ts, f_live = _motions_f(F, K)
    h_Rs, h_ts, h_live = _motions_h(H, K, Kinv)
    Rs = torch.where(use_h, h_Rs, f_Rs)
    ts = torch.where(use_h, h_ts, f_ts)
    live = torch.where(use_h, h_live, f_live)
    inl = torch.where(use_h, inl_h, inl_f)

    n_good, goods, Xs, pcos = _check_rt(Rs, ts, xn1, xn2, inl, fx, fy, sigma2)
    n_good = n_good * live  # dead pad slots never win
    best = torch.argmax(n_good)
    n_best = n_good[best]
    second = torch.sort(n_good).values[-2]
    ok = (n_best >= min_good) & (second < 0.75 * n_best) & (pcos[best] < min_parallax_cos)
    return TwoViewResult(ok=ok, used_h=use_h, R=Rs[best], t=ts[best], points=Xs[best], good=goods[best])
