"""Device steps of local mapping: triangulation and fusion (counterpart of
orb_slam2_2021_tpu/pipeline/mapping_steps.py).

- triangulate_pair: SearchForTriangulation's epipolar-gated descriptor
  matching fused with linear triangulation and the cheirality,
  reprojection and scale gates of CreateNewMapPoints, for one keyframe
  against T neighbour keyframes at once.
- fuse_project: ORBmatcher::Fuse's projection search of one point set into
  T keyframes at once; the host applies the merge/add decisions.

Both take the batched side with an explicit leading T axis (the reference
vmaps the per-pair function). The shared side makes the Hamming distances
one launch: `hamming_matrix(a [N, 8], b.reshape(T * M, 8))` viewed as
[N, T, M].
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry.camera import PinholeCamera
from ..ops.hamming import MAX_DIST, hamming_matrix

TH_LOW = 50
TH_HIGH = 100
_BIG = 2 ** 30


class KFView(NamedTuple):
    """One keyframe's features and pose, or T of them stacked on a leading
    axis."""
    xy: torch.Tensor        # [(T,) N, 2] float32
    ur: torch.Tensor        # [(T,) N]
    depth: torch.Tensor     # [(T,) N]
    octave: torch.Tensor    # [(T,) N] int32
    desc: torch.Tensor      # [(T,) N, 8] int32
    valid: torch.Tensor     # [(T,) N] bool (valid AND unbound, for triangulation)
    R: torch.Tensor         # [(T,) 3, 3] Tcw
    t: torch.Tensor         # [(T,) 3]


def _scale_arrays(cfg, device):
    s = torch.tensor([cfg.orb.scale_factor ** i for i in range(cfg.orb.n_levels)],
                     dtype=torch.float32, device=device)
    return s, s * s


def _kinv(cam: PinholeCamera) -> np.ndarray:
    """Inverse intrinsics in float32 as the reference's 3x3 LU gives them."""
    f32 = np.float32
    fx, fy, cx, cy = f32(cam.fx), f32(cam.fy), f32(cam.cx), f32(cam.cy)
    return np.array([[f32(1) / fx, 0, -(cx / fx)],
                     [0, f32(1) / fy, -(cy / fy)],
                     [0, 0, 1]], np.float32)


def _hamming_batched(a, b):
    """[N, 8] x [T, M, 8] -> [T, N, M] int16 in one kernel launch."""
    T, M = b.shape[0], b.shape[1]
    return hamming_matrix(a, b.reshape(T * M, 8)).view(a.shape[0], T, M).permute(1, 0, 2)


def _rows(x, idx):
    """x [T, M, ...] gathered at idx [T, N] -> [T, N, ...]."""
    tix = torch.arange(x.shape[0], device=x.device)[:, None]
    return x[tix, idx]


def _dedupe(best2, ok, bestd, n2: int):
    """Two kf1 features claiming one kf2 feature: keep the lower distance,
    then the lower kf1 index (per pair, along the last axis)."""
    idx = best2.long()
    d_sel = torch.where(ok, bestd.to(torch.int32), torch.full_like(best2, MAX_DIST))
    feat_min = torch.full((best2.shape[0], n2), MAX_DIST, dtype=torch.int32, device=idx.device)
    feat_min = feat_min.scatter_reduce(1, idx, d_sel, "amin", include_self=True)
    ok = ok & (d_sel == torch.gather(feat_min, 1, idx))
    qidx = torch.arange(best2.shape[1], dtype=torch.int32, device=idx.device).expand_as(best2)
    q = torch.where(ok, qidx, torch.full_like(qidx, _BIG))
    qmin = torch.full((best2.shape[0], n2), _BIG, dtype=torch.int32, device=idx.device)
    qmin = qmin.scatter_reduce(1, idx, q, "amin", include_self=True)
    return ok & (q == torch.gather(qmin, 1, idx))


def triangulate_pair(cam: PinholeCamera, kf1: KFView, kf2: KFView, cfg):
    """Match the unbound features of kf1 ([N], no T axis) against each of the
    T keyframes of kf2 ([T, M]) under the epipolar constraint, and
    triangulate. Returns (match2 [T, N] int32, xw [T, N, 3], ok [T, N] bool,
    baseline [T])."""
    dev = kf1.xy.device
    scale, sigma2 = _scale_arrays(cfg, dev)
    inv_sigma2 = 1.0 / sigma2
    T, N = kf2.xy.shape[0], kf1.xy.shape[0]

    R1, t1, R2, t2 = kf1.R, kf1.t, kf2.R, kf2.t
    C1 = -(t1 @ R1)                                   # world centre of kf1 [3]
    C2 = -torch.einsum("tj,tji->ti", t2, R2)          # [T, 3]
    baseline = torch.linalg.vector_norm(C2 - C1, dim=1)

    # fundamental matrix F12 = K^-T [t12]x R12 K^-1 (LocalMapping::ComputeF12)
    R12 = torch.matmul(R1, R2.transpose(1, 2))        # R1 R2^T [T,3,3]
    t12 = t1 - torch.einsum("tij,tj->ti", R12, t2)
    z0 = torch.zeros_like(t12[:, 0])
    tx = torch.stack([
        torch.stack([z0, -t12[:, 2], t12[:, 1]], -1),
        torch.stack([t12[:, 2], z0, -t12[:, 0]], -1),
        torch.stack([-t12[:, 1], t12[:, 0], z0], -1),
    ], -2)
    Kinv = torch.from_numpy(_kinv(cam)).to(dev)
    F12 = torch.matmul(torch.matmul(torch.matmul(Kinv.T, tx), R12), Kinv)

    # epipolar distance of kf2 candidates from kf1's lines l = p1^T F12
    ones1 = torch.ones((N, 1), dtype=torch.float32, device=dev)
    p1 = torch.cat([kf1.xy, ones1], dim=1)                              # [N,3]
    p2 = torch.cat([kf2.xy, torch.ones_like(kf2.xy[..., :1])], dim=2)   # [T,M,3]
    lines = torch.matmul(p1, F12)                                       # [T,N,3]
    num = torch.matmul(lines, p2.transpose(1, 2))                       # [T,N,M]
    den = lines[..., 0:1] ** 2 + lines[..., 1:2] ** 2
    dsqr = num * num / torch.clamp_min(den, 1e-12)
    epi_ok = dsqr < 3.84 * sigma2[kf2.octave.long()][:, None, :]

    # features must not lie too close to kf1's epipole in kf2
    C1_in2 = torch.einsum("tij,j->ti", R2, C1) + t2
    zc = torch.clamp_min(C1_in2[:, 2], 1e-9)
    ex = cam.fx * C1_in2[:, 0] / zc + cam.cx
    ey = cam.fy * C1_in2[:, 1] / zc + cam.cy
    de = (kf2.xy[..., 0] - ex[:, None]) ** 2 + (kf2.xy[..., 1] - ey[:, None]) ** 2
    epipole_ok = (kf2.ur >= 0) | (de >= 100.0 * scale[kf2.octave.long()] ** 2)

    mask = kf1.valid[None, :, None] & kf2.valid[:, None, :] & epi_ok & epipole_ok[:, None, :]
    dist = _hamming_batched(kf1.desc, kf2.desc)
    d = torch.where(mask, dist, torch.full_like(dist, MAX_DIST))
    best2 = torch.argmin(d, dim=2)                                      # [T,N]
    bestd = torch.gather(d, 2, best2[..., None])[..., 0]
    matched = bestd <= TH_LOW

    xy2 = _rows(kf2.xy, best2)
    oct2 = _rows(kf2.octave, best2)
    ur2 = _rows(kf2.ur, best2)
    depth2 = _rows(kf2.depth, best2)

    xn1 = torch.stack([(kf1.xy[:, 0] - cam.cx) / cam.fx, (kf1.xy[:, 1] - cam.cy) / cam.fy], dim=1)
    xn2 = torch.stack([(xy2[..., 0] - cam.cx) / cam.fx, (xy2[..., 1] - cam.cy) / cam.fy], dim=2)

    # parallax between the rays
    ray1 = torch.matmul(torch.cat([xn1, ones1], dim=1), R1)                   # [N,3]
    ray2 = torch.matmul(torch.cat([xn2, torch.ones_like(xn2[..., :1])], dim=2), R2)  # [T,N,3]
    cos_rays = torch.sum(ray1 * ray2, dim=2) / (
        torch.linalg.vector_norm(ray1, dim=1) * torch.linalg.vector_norm(ray2, dim=2) + 1e-12)
    # stereo parallax alternatives
    half_b = float(np.float32(np.float32(cam.bf) / np.float32(cam.fx)) / np.float32(2.0))
    d1 = kf1.depth
    cos_stereo1 = torch.where(d1 > 0, torch.cos(2.0 * torch.atan2(torch.full_like(d1, half_b), d1)),
                              torch.full_like(d1, 1.1))
    cos_stereo2 = torch.where(depth2 > 0,
                              torch.cos(2.0 * torch.atan2(torch.full_like(depth2, half_b), depth2)),
                              torch.full_like(depth2, 1.1))
    cos_stereo = torch.minimum(cos_stereo1, cos_stereo2)

    # linear triangulation (w = 1 gauge): min ||B x + c||^2 via the 3x3
    # normal equations and their adjugate
    P1 = torch.cat([R1, t1[:, None]], dim=1)                   # [3,4]
    P2 = torch.cat([R2, t2[:, :, None]], dim=2)                # [T,3,4]
    A = torch.stack([
        (xn1[:, 0:1] * P1[2] - P1[0][None]).expand(T, N, 4),
        (xn1[:, 1:2] * P1[2] - P1[1][None]).expand(T, N, 4),
        xn2[..., 0:1] * P2[:, None, 2] - P2[:, None, 0],
        xn2[..., 1:2] * P2[:, None, 2] - P2[:, None, 1],
    ], dim=2)                                                  # [T,N,4,4]
    B = A[..., :3]
    cvec = A[..., 3]
    M = torch.sum(B[..., :, :, None] * B[..., :, None, :], dim=-3)     # [T,N,3,3]
    rhs = -torch.sum(B * cvec[..., None], dim=-2)                       # [T,N,3]
    c00 = M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1]
    c01 = M[..., 0, 2] * M[..., 2, 1] - M[..., 0, 1] * M[..., 2, 2]
    c02 = M[..., 0, 1] * M[..., 1, 2] - M[..., 0, 2] * M[..., 1, 1]
    c11 = M[..., 0, 0] * M[..., 2, 2] - M[..., 0, 2] * M[..., 2, 0]
    c12 = M[..., 0, 2] * M[..., 1, 0] - M[..., 0, 0] * M[..., 1, 2]
    c22 = M[..., 0, 0] * M[..., 1, 1] - M[..., 0, 1] * M[..., 1, 0]
    det = M[..., 0, 0] * c00 + M[..., 0, 1] * c01 + M[..., 0, 2] * c02
    w_ok = torch.abs(det) > 1e-12
    inv_det = 1.0 / torch.where(w_ok, det, torch.ones_like(det))
    x_dlt = torch.stack([
        c00 * rhs[..., 0] + c01 * rhs[..., 1] + c02 * rhs[..., 2],
        c01 * rhs[..., 0] + c11 * rhs[..., 1] + c12 * rhs[..., 2],
        c02 * rhs[..., 0] + c12 * rhs[..., 1] + c22 * rhs[..., 2],
    ], dim=-1) * inv_det[..., None]

    use_dlt = (cos_rays < cos_stereo) & (cos_rays > 0) & (cos_rays < 0.9998) & w_ok
    # low parallax: unproject the stereo depth of the better view
    xw_s1 = torch.matmul(torch.cat([xn1 * d1[:, None], d1[:, None]], dim=1) - t1[None], R1)
    xw_s2 = torch.matmul(torch.cat([xn2 * depth2[..., None], depth2[..., None]], dim=2)
                         - t2[:, None], R2)
    use_s1 = ~use_dlt & (d1 > 0) & (cos_stereo1 < cos_stereo2)
    use_s2 = ~use_dlt & ~use_s1 & (depth2 > 0)
    xw = torch.where(use_dlt[..., None], x_dlt,
                     torch.where(use_s1[..., None], xw_s1.expand(T, N, 3), xw_s2))
    has_point = use_dlt | use_s1 | use_s2

    def reproj_ok(R, t, xy, ur, octv):
        """Cheirality and chi2 reprojection gate of xw in one view."""
        Xc = torch.matmul(xw, R.transpose(-1, -2)) + t
        z = Xc[..., 2]
        iz = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        u = cam.fx * Xc[..., 0] * iz + cam.cx
        v = cam.fy * Xc[..., 1] * iz + cam.cy
        urp = u - cam.bf * iz
        isv2 = inv_sigma2[octv.long()]
        e_mono = ((u - xy[..., 0]) ** 2 + (v - xy[..., 1]) ** 2) * isv2
        e_st = e_mono + (urp - ur) ** 2 * isv2
        return (z > 0) & torch.where(ur >= 0, e_st <= 7.8, e_mono <= 5.991)

    ok1 = reproj_ok(R1, t1, kf1.xy, kf1.ur, kf1.octave)
    ok2 = reproj_ok(R2, t2[:, None], xy2, ur2, oct2)

    # scale consistency
    dist1 = torch.linalg.vector_norm(xw - C1, dim=2)
    dist2 = torch.linalg.vector_norm(xw - C2[:, None], dim=2)
    ratio_dist = dist2 / torch.clamp_min(dist1, 1e-9)
    ratio_octave = scale[kf1.octave.long()] / scale[oct2.long()]
    rf = 1.5 * cfg.orb.scale_factor
    scale_ok = (ratio_dist * rf > ratio_octave) & (ratio_dist < ratio_octave * rf)

    ok = matched & has_point & ok1 & ok2 & scale_ok & (dist1 > 0) & (dist2 > 0)
    best2 = best2.to(torch.int32)
    ok = _dedupe(best2, ok, bestd, kf2.xy.shape[1])
    return best2, xw, ok, baseline


def fuse_project(cam: PinholeCamera, kf: KFView,
                 mp_pos, mp_normal, mp_min_dist, mp_max_dist, mp_desc, mp_valid,
                 cfg, radius_th: float = 3.0):
    """Fuse search of P points ([P] tensors) into each of the T keyframes of
    kf ([T, N]). Returns (best_feat [T, P] int32, accept [T, P],
    best_dist [T, P])."""
    dev = mp_pos.device
    scale, sigma2 = _scale_arrays(cfg, dev)
    inv_sigma2 = 1.0 / sigma2
    log_scale = torch.log(torch.tensor(cfg.orb.scale_factor, dtype=torch.float32, device=dev))
    n_levels = cfg.orb.n_levels

    R, t = kf.R, kf.t
    Xc = torch.matmul(mp_pos, R.transpose(1, 2)) + t[:, None]          # [T,P,3]
    z = Xc[..., 2]
    iz = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    u = cam.fx * Xc[..., 0] * iz + cam.cx
    v = cam.fy * Xc[..., 1] * iz + cam.cy
    ur = u - cam.bf * iz

    Ow = -torch.einsum("tj,tji->ti", t, R)
    po = mp_pos - Ow[:, None]
    dist3d = torch.linalg.vector_norm(po, dim=2) + 1e-9
    in_front = z > 0
    in_img = (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    band = (dist3d >= 0.8 * mp_min_dist) & (dist3d <= 1.2 * mp_max_dist)
    view_cos = torch.sum(po * mp_normal, dim=2) / dist3d
    visible = mp_valid & in_front & in_img & band & (view_cos > 0.5)

    pred = torch.ceil(torch.log(torch.clamp_min(mp_max_dist, 1e-9) / dist3d) / log_scale)
    pred = torch.clamp(pred, 0, n_levels - 1).to(torch.int32)
    r = radius_th * scale[pred.long()]

    kx, ky = kf.xy[:, None, :, 0], kf.xy[:, None, :, 1]                 # [T,1,N]
    du = torch.abs(kx - u[..., None])
    dv = torch.abs(ky - v[..., None])
    window = (du <= r[..., None]) & (dv <= r[..., None])
    koct = kf.octave[:, None, :]
    oct_ok = (koct >= pred[..., None] - 1) & (koct <= pred[..., None] + 1)
    # chi2 gate on the candidate
    e2_mono = (kx - u[..., None]) ** 2 + (ky - v[..., None]) ** 2
    e2_st = e2_mono + (kf.ur[:, None, :] - ur[..., None]) ** 2
    isv = inv_sigma2[kf.octave.long()][:, None, :]
    chi_ok = torch.where(kf.ur[:, None, :] >= 0, e2_st * isv <= 7.8, e2_mono * isv <= 5.99)

    mask = window & oct_ok & chi_ok & visible[..., None] & kf.valid[:, None, :]
    dist = _hamming_batched(mp_desc, kf.desc)
    d = torch.where(mask, dist, torch.full_like(dist, MAX_DIST))
    best_feat = torch.argmin(d, dim=2)
    best_dist = torch.gather(d, 2, best_feat[..., None])[..., 0]
    return best_feat.to(torch.int32), best_dist <= TH_LOW, best_dist
