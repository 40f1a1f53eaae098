"""The motion-only pose solve's wrapper and kernel design, held on the CPU.

`optim/pose.pose_optimize` checks its inputs, runs `pose_optimize_plain` on
a CPU tensor (bit for bit, no kernel launch) and refuses what the kernel
(`csrc/pose.cu`) does not take. A float32 numpy model of the kernel's
arithmetic (its expanded Jacobian rows, the solve for -step by LU with
partial pivoting, se3_exp with the small-angle branch, the accept/reject and
the reclassification) is held against the plain version at the card tests'
tolerances, and the wrapper's sizes and ctypes signature against the
source. tests/test_torch_cuda.py holds the kernel itself on the card.
"""

import os
import re

import numpy as np
import pytest
import torch

from chip_smoke import POSE_CASES, POSE_R_TOL, POSE_T_TOL, pose_case, pose_inputs
from orb_slam2_2021_tpu_torch.config import OptimConfig
from orb_slam2_2021_tpu_torch.geometry.camera import PinholeCamera
from orb_slam2_2021_tpu_torch.optim import pose as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = OptimConfig()
F = np.float32


@pytest.mark.parametrize("name", POSE_CASES)
def test_cpu_input_runs_the_plain_version(name):
    cam, R0, t0, obs = pose_inputs(name, "cpu")
    launches = P.POSE_KERNEL.launches
    got = P.pose_optimize(cam, R0, t0, obs, CFG)
    want = P.pose_optimize_plain(cam, R0, t0, obs, CFG)
    assert all(torch.equal(a, b) for a, b in zip(got, want)), "bit for bit"
    assert P.POSE_KERNEL.launches == launches, "no kernel on a CPU tensor"
    assert got[2].dtype == torch.bool and got[3].dtype == torch.int64 and got[3].dim() == 0


def test_plain_version_recovers_the_true_pose():
    _, _, _, _, valid, _, _, t_true = pose_case("stereo_2000")
    cam, R0, t0, obs = pose_inputs("stereo_2000", "cpu")
    R, t, inl, n_in = P.pose_optimize(cam, R0, t0, obs, CFG)
    assert 0.6 * valid.sum() < int(n_in) < valid.sum()
    assert np.abs(t.numpy() - t_true).max() < 0.05


def _bad(name):
    """pose_inputs("ragged_1337") with one argument spoiled."""
    cam, R0, t0, obs = pose_inputs("ragged_1337", "cpu")
    if name == "xw_float64":
        obs = obs._replace(xw=obs.xw.double())
    elif name == "uvr_shape":
        obs = obs._replace(uvr=obs.uvr[:, :2].contiguous())
    elif name == "inv_sigma2_strided":
        obs = obs._replace(inv_sigma2=torch.stack([obs.inv_sigma2] * 2, 1)[:, 0])
    elif name == "valid_uint8":
        obs = obs._replace(valid=obs.valid.to(torch.uint8))
    elif name == "valid_length":
        obs = obs._replace(valid=obs.valid[:-1])
    elif name == "R0_flat":
        R0 = R0.reshape(9)
    elif name == "R0_transposed":
        R0 = R0.t()
    elif name == "t0_float64":
        t0 = t0.double()
    elif name == "devices":
        t0 = t0.to("meta")
    elif name == "too_many":
        n = P.MAX_OBS + 1
        obs = P.PoseObs(torch.zeros(n, 3), torch.zeros(n, 3), torch.ones(n),
                        torch.ones(n, dtype=torch.bool))
    return cam, R0, t0, obs


@pytest.mark.parametrize("name", ["xw_float64", "uvr_shape", "inv_sigma2_strided", "valid_uint8",
                                  "valid_length", "R0_flat", "R0_transposed", "t0_float64",
                                  "devices", "too_many"])
def test_wrapper_refuses_what_the_kernel_does_not_take(name):
    with pytest.raises((TypeError, ValueError)):
        P.pose_optimize(*_bad(name), CFG)


def test_largest_input_is_taken():
    n = P.MAX_OBS
    obs = P.PoseObs(torch.zeros(n, 3), torch.zeros(n, 3), torch.ones(n), torch.zeros(n, dtype=torch.bool))
    R, t, inl, n_in = P.pose_optimize(PinholeCamera.create(500, 500, 320, 240, 40), torch.eye(3),
                                      torch.zeros(3), obs, CFG)
    assert int(n_in) == 0 and torch.equal(R, torch.eye(3))


# ------------------------------------------------------------ kernel model


def _project(cam, R, t, xw, uvr, stereo):
    fx, fy, cx, cy, bf = cam
    xc = xw @ R.T + t
    z = xc[:, 2]
    iz = F(1) / np.where(np.abs(z) < F(1e-9), F(1e-9), z)
    u = fx * xc[:, 0] * iz + cx
    v = fy * xc[:, 1] * iz + cy
    r = np.stack([uvr[:, 0] - u, uvr[:, 1] - v,
                  np.where(stereo, uvr[:, 2] - (u - bf * iz), F(0))], 1)
    return xc, iz, r


def _robust(chi, d2, huber):
    if not huber:
        return chi
    return np.where(chi <= d2, chi, F(2) * np.sqrt(d2 * np.maximum(chi, F(1e-12))) - d2)


def _solve6(A, y):
    """The kernel's solve6: LU with partial pivoting (first largest pivot),
    back substitution, in float32."""
    A, y = A.astype(F).copy(), y.astype(F).copy()
    for c in range(6):
        piv = c + int(np.argmax(np.abs(A[c:, c])))
        A[[c, piv], c:] = A[[piv, c], c:]
        y[[c, piv]] = y[[piv, c]]
        inv = F(1) / A[c, c]
        for r in range(c + 1, 6):
            f = A[r, c] * inv
            A[r, c + 1:] -= f * A[c, c + 1:]
            y[r] -= f * y[c]
    x = np.zeros(6, F)
    for c in range(5, -1, -1):
        x[c] = (y[c] - np.dot(A[c, c + 1:], x[c + 1:]).astype(F)) / A[c, c]
    return x


def _candidate(H, g, lam, R, t):
    A = H.copy()
    A[np.diag_indices(6)] = (np.diag(H) + lam * np.diag(H)) + F(1e-8)
    xi = _solve6(A, g)  # = -step
    v, w = xi[:3], xi[3:]
    theta2 = F(np.sum(w * w))
    theta = np.sqrt(theta2 + F(1e-16))
    if theta2 < F(1e-8):
        a, b, c = F(1) - theta2 / F(6), F(0.5) - theta2 / F(24), F(1 / 6) - theta2 / F(120)
    else:
        a, b, c = np.sin(theta) / theta, (F(1) - np.cos(theta)) / theta2, (theta - np.sin(theta)) / (theta2 * theta)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]], F)
    W2 = W @ W
    dR = np.eye(3, dtype=F) + a * W + b * W2
    dt = (np.eye(3, dtype=F) + b * W + c * W2) @ v
    return dR @ R, dR @ t + dt


def kernel_model(cam, R0, t0, xw, uvr, s2, valid, cfg):
    """csrc/pose.cu's arithmetic in float32 numpy (its sums in another
    order): G = d (u, v, u_r) / d xi row by row, H = sum w G^T G over the
    inliers, g = sum w G^T r, H + lambda diag(H) + 1e-8 I solved for g."""
    fx, fy, cx, cy, bf = (F(c) for c in cam)
    stereo = uvr[:, 2] >= 0
    rows = np.where(stereo, 3, 2)
    d2 = np.where(stereo, F(cfg.chi2_stereo), F(cfg.chi2_mono)).astype(F)
    R, t, inlier = R0.astype(F), t0.astype(F), valid.copy()

    def chi2(R, t):
        xc, _, r = _project((fx, fy, cx, cy, bf), R, t, xw, uvr, stereo)
        return np.sum(r * r, 1) * s2, xc[:, 2]

    for rnd in range(cfg.pose_rounds):
        huber = rnd < 2
        lam = F(cfg.lm_lambda_init)
        for _ in range(cfg.pose_iters):
            xc, iz, r = _project((fx, fy, cx, cy, bf), R, t, xw, uvr, stereo)
            x, y, z = xc[:, 0], xc[:, 1], xc[:, 2]
            iz2 = iz * iz
            a, e = fx * iz, fy * iz
            pu, pv = -fx * x * iz2, -fy * y * iz2
            pr = pu + bf * iz2
            zero = np.zeros_like(a)
            G = np.stack([np.stack([a, zero, pu, pu * y, a * z - pu * x, -a * y], 1),
                          np.stack([zero, e, pv, pv * y - e * z, -pv * x, e * x], 1),
                          np.stack([a, zero, pr, pr * y, a * z - pr * x, -a * y], 1)], 1)
            G[rows == 2, 2] = 0
            chi = np.sum(r * r, 1) * s2
            wh = np.where(huber & ~(chi <= d2), np.sqrt(d2 / np.maximum(chi, F(1e-12))), F(1))
            w = np.where(inlier, s2 * wh, F(0)).astype(F)
            H = np.einsum("nik,n,nil->kl", G, w, G).astype(F)
            g = np.einsum("nik,n,ni->k", G, w, r).astype(F)
            err = F(np.sum(np.where(inlier, _robust(chi, d2, huber), F(0))))
            Rc, tc = _candidate(H, g, lam, R, t)
            chi_c, _ = chi2(Rc, tc)
            err_new = F(np.sum(np.where(inlier, _robust(chi_c, d2, huber), F(0))))
            if err_new < err:
                R, t, lam = Rc.astype(F), tc.astype(F), lam * F(0.5)
            else:
                lam = lam * F(4)
        chi, z = chi2(R, t)
        inlier = valid & (chi <= d2) & ~(z <= 0)
    return R, t, inlier


@pytest.mark.parametrize("name", POSE_CASES)
def test_kernel_model_matches_the_plain_version(name):
    cam, xw, uvr, s2, valid, R0, t0, _ = pose_case(name)
    R, t, inl = kernel_model(cam, R0, t0, xw, uvr, s2, valid, CFG)
    pcam, tR0, tt0, obs = pose_inputs(name, "cpu")
    Rp, tp, inlp, n_p = P.pose_optimize_plain(pcam, tR0, tt0, obs, CFG)
    assert np.array_equal(inl, inlp.numpy()), "inlier flags identical"
    assert np.abs(R - Rp.numpy()).max() < POSE_R_TOL, "R: 1e-5"
    assert np.abs(t - tp.numpy()).max() < POSE_T_TOL, "t: 1e-4 m"


def test_kernel_sizes_match_the_source():
    with open(os.path.join(REPO, "orb_slam2_2021_tpu_torch", "csrc", "pose.cu")) as f:
        src = f.read()
    consts = {m[1]: int(m[2]) for m in re.finditer(r"constexpr int (\w+) = (\d+);", src)}
    params = {m[1]: len(m[2].split(",")) for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src)}
    assert P.MAX_OBS == consts["kThreads"] * consts["kMaxPer"]
    assert len(P.POSE_KERNEL.argtypes) == params[P.POSE_KERNEL.symbol]
