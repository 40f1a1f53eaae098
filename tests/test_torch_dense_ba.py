"""The dense local BA of the PyTorch port (`optim/ba.py`: `_lm_step`,
`ba_solve`, `make_local_ba`; local mapping with `use_cg_local_ba=False`)
held against the JAX reference on identical inputs: one damped step and the
two-phase solve on the reference's synthetic problems (stereo, monocular
with its scale gauge, more fixed cameras, gross outliers), the local BA of
a real map's window at small capacities, and the System over a short
320x240 drive with two dense local BA solves.

The eigenproblem runs in float32 here, as in the reference (`EIG_DTYPE`;
the port's default is float64)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orb_slam2_2021_tpu.config import synthetic_config
from orb_slam2_2021_tpu.io.synthetic import SyntheticStereoWorld, forward_trajectory
from orb_slam2_2021_tpu.optim import ba as jba
from orb_slam2_2021_tpu.pipeline import local_mapping as jlm_mod
from orb_slam2_2021_tpu_torch.convert import ba_problem_from_reference, config_from_reference
from orb_slam2_2021_tpu_torch.geometry.camera import PinholeCamera as TCam
from orb_slam2_2021_tpu_torch.optim import ba as tba
from orb_slam2_2021_tpu_torch.pipeline import local_mapping as tlm_mod

from test_ba import CAM, CFG, build_problem
from test_torch_ba import synthetic_map
from test_torch_local_mapping import _clone

torch.set_num_threads(1)

TCAM = TCam.create(400.0, 400.0, 320.0, 240.0, bf=80.0, width=640, height=480)

# (build_problem arguments, tolerances of the step, of the solve): the
# monocular problem keeps a near-null scale mode whose kept/dropped status
# sits at the 1e-6 cutoff, so it gets the wider bounds
CASES = {
    "stereo": ({}, (1e-4, 5e-4, 1e-3), (1e-5, 1e-5, 1e-4)),
    "mono": ({"stereo": False, "n_fixed": 1}, (2e-3, 1e-2, 2e-2), (2e-4, 5e-3, 2e-2)),
    "fixed": ({"n_fixed": 4}, (1e-4, 5e-4, 1e-3), (1e-5, 1e-5, 1e-4)),
    "outliers": ({}, (1e-4, 5e-4, 1e-3), (1e-5, 1e-5, 1e-4)),
}


@pytest.fixture(autouse=True)
def reference_eig_dtype(monkeypatch):
    monkeypatch.setattr(tba, "EIG_DTYPE", torch.float32)


def _problem(name):
    rng = np.random.default_rng(3)
    kw, _, _ = CASES[name]
    prob, R_gt, t_gt, _ = build_problem(rng, **kw)
    if name == "outliers":
        uvr = np.asarray(prob.obs_uvr).copy()
        bad = rng.choice(len(uvr), 25, replace=False)
        uvr[bad, :2] += rng.uniform(15, 40, (25, 2))
        prob = prob._replace(obs_uvr=jnp.asarray(uvr))
    return prob, t_gt


def _max_abs(ref, port):
    return [float(np.abs(np.asarray(a) - b.numpy()).max()) for a, b in zip(ref, port)]


@pytest.mark.parametrize("name", list(CASES))
def test_lm_step_matches_reference(name):
    """One Huber step from the perturbed start: the candidate R, t, xw
    within the case's tolerances; chi2 at the start within 1e-4 relative."""
    prob, _ = _problem(name)
    tp = ba_problem_from_reference(prob, "cpu")
    j = jba._lm_step(CAM, prob, prob.R, prob.t, prob.xw, prob.obs_valid.astype(jnp.float32),
                     jnp.float32(CFG.lm_lambda_init), jnp.bool_(True), CFG)
    p = tba._lm_step(TCAM, tp, tp.R, tp.t, tp.xw, tp.obs_valid.float(),
                     torch.tensor(CFG.lm_lambda_init), True, CFG)
    dR, dt, dx = _max_abs(j[:3], p[:3])
    tol = CASES[name][1]
    assert dR < tol[0] and dt < tol[1] and dx < tol[2], (dR, dt, dx, tol)
    assert np.abs(np.asarray(j[1]) - np.asarray(prob.t)).max() > 0.05, "the step moves the cameras"
    chi2_j, chi2_p = np.asarray(j[3]), p[3].numpy()
    assert np.abs(chi2_p - chi2_j).max() <= 1e-4 * np.abs(chi2_j).max()
    assert np.array_equal(np.asarray(j[4]), p[4].numpy())


@pytest.mark.parametrize("name", list(CASES))
def test_ba_solve_matches_reference(name):
    """5 Huber + 10 plain iterations: inlier flags identical, R, t, xw
    within the case's tolerances, and the true poses recovered."""
    prob, t_gt = _problem(name)
    R, t, xw, inl = jba.make_local_ba(CFG)(CAM, prob)
    Rp, tp_, xp, inlp = tba.make_local_ba(CFG)(TCAM, ba_problem_from_reference(prob, "cpu"))
    assert np.array_equal(np.asarray(inl), inlp.numpy()), "inlier flags: identical"
    dR, dt, dx = _max_abs((R, t, xw), (Rp, tp_, xp))
    tol = CASES[name][2]
    assert dR < tol[0] and dt < tol[1] and dx < tol[2], (dR, dt, dx, tol)
    assert np.abs(tp_.numpy() - t_gt).max() < 5e-2, "recovers the true poses within 5 cm"
    if name == "outliers":
        assert inlp.sum() < len(inlp) - 15, "the gross outliers are classified out"


def test_make_global_ba_matches_reference():
    """`make_global_ba` on the outlier case: one Huber phase of
    global_ba_iters iterations, then the reclassification. Inlier flags
    identical, R within 1e-5, t within 1e-4 m, points within 5e-3 m: the
    gross outliers keep their Huber weight to the end (the local schedule
    drops them for its last phase), so their points stay less determined
    (measured 3.1e-6, 3.5e-5 m, 2.9e-3 m)."""
    prob, _ = _problem("outliers")
    R, t, xw, inl = jba.make_global_ba(CFG)(CAM, prob)
    Rp, tp_, xp, inlp = tba.make_global_ba(CFG)(TCAM, ba_problem_from_reference(prob, "cpu"))
    assert np.array_equal(np.asarray(inl), inlp.numpy()), "inlier flags: identical"
    dR, dt, dx = _max_abs((R, t, xw), (Rp, tp_, xp))
    assert dR < 1e-5 and dt < 1e-4 and dx < 5e-3, (dR, dt, dx)


SMALL = dict(local_ba_max_cams=4, local_ba_max_fixed=4, local_ba_max_points=256,
             local_ba_max_obs=2048, use_cg_local_ba=False)


def test_dense_local_ba_on_a_real_window(monkeypatch):
    """`LocalMapping._local_ba` of the last keyframe of a five-keyframe map
    through both packages at small static capacities (C=8, P=256, O=2048,
    Q=8): the same window, then poses, points and erased observations on
    the two maps."""
    cfg = synthetic_config(width=320, height=240)
    cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, **SMALL))
    m0 = synthetic_map(np.random.default_rng(1), cfg)
    m_ref, m_port = _clone(m0), _clone(m0)
    calls = []
    for mod in (jlm_mod, tlm_mod):
        orig = mod.assemble_ba_problem

        def rec(*a, _orig=orig, **kw):
            out = _orig(*a, **kw)
            calls.append((a[1:4], kw, out[0]))
            return out
        monkeypatch.setattr(mod, "assemble_ba_problem", rec)
    jlm_mod.LocalMapping(cfg, m_ref)._local_ba(4)
    tlm = tlm_mod.LocalMapping(config_from_reference(cfg), m_port, "cpu")
    tlm._local_ba(4)
    (ja, jk, jp), (ta, tk, tp_) = calls
    for a, b in zip(ja, ta):
        assert np.array_equal(a, b), "window cameras, free flags and points: identical"
    assert (tp_.R.shape[0], tp_.xw.shape[0], tp_.obs_cam.shape[0], tp_.pt_obs.shape[1]) == (8, 256, 2048, 8)
    for name, a, b in zip(jp._fields, jp, tp_):
        assert np.array_equal(np.asarray(a), b), f"{name}: identical"
    assert len(tlm.ba_solve_times) == 1
    assert np.array_equal(m_port.kf_mp, m_ref.kf_mp), "erased outlier observations: identical"
    assert np.array_equal(m_port.mp_obs_kf, m_ref.mp_obs_kf)
    assert np.abs(m_port.kf_t - m_ref.kf_t).max() < 1e-4, "keyframe t: tolerance 1e-4 m"
    assert np.abs(m_port.kf_R - m_ref.kf_R).max() < 1e-5, "keyframe R: tolerance 1e-5"
    live = m_ref.mp_valid
    assert np.abs(m_port.mp_pos[live] - m_ref.mp_pos[live]).max() < 1e-3, "points: tolerance 1 mm"
    assert np.abs(m_port.kf_t - m0.kf_t).max() > 1e-4, "the solve moved the keyframes"


def test_dense_system_matches_reference():
    """29 frames at 320x240 with mapping on and loop closing off, dense
    local BA at the default capacities (C=128, P=4096, O=32768, Q=8):
    keyframes at frames 0, 15, 19 and 28 on both sides, two local BA
    solves, poses within 1 mm / 1e-3 (measured 1.9e-4)."""
    from orb_slam2_2021_tpu.pipeline.system import System as JSystem
    from orb_slam2_2021_tpu.place.bundle import PACKAGED_VOCAB_SMALL, PlaceRecognition
    from orb_slam2_2021_tpu.place.vocab import BinaryVocabulary
    from orb_slam2_2021_tpu_torch.pipeline.system import System as TSystem

    n = 29
    cfg = synthetic_config(width=320, height=240)
    cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, use_cg_local_ba=False))
    world = SyntheticStereoWorld(cfg, seed=3)
    ref = JSystem(cfg, enable_mapping=True, enable_loop_closing=False,
                  place_rec=PlaceRecognition(BinaryVocabulary.load(PACKAGED_VOCAB_SMALL)))
    port = TSystem(config_from_reference(cfg), enable_mapping=True, enable_loop_closing=False,
                   device="cpu")
    worst = 0.0
    for i, (R, t) in enumerate(forward_trajectory(n, step=0.12)):
        left, right = world.render(R, t)
        pr = ref.track_stereo(left, right, timestamp=0.1 * i)
        pt = port.track_stereo(left, right, timestamp=0.1 * i)
        assert (pr is None) == (pt is None), f"frame {i}: tracked flags differ"
        assert port.map.n_kf == ref.map.n_kf, f"frame {i}: keyframe counts differ"
        if pr is not None:
            worst = max(worst, np.abs(pt[1] - pr[1]).max(), np.abs(pt[0] - pr[0]).max())
    ref.shutdown()
    port.shutdown()
    assert worst < 1e-3, f"poses differ by {worst:.2e} (tolerance 1 mm / 1e-3)"
    assert [m["keyframe"] for m in port.metrics] == [m["keyframe"] for m in ref.metrics]
    assert np.nonzero([m["keyframe"] for m in port.metrics])[0].tolist() == [0, 15, 19, 28]
    assert len(port.local_mapper.ba_solve_times) == len(ref.local_mapper.ba_solve_times) == 2
    assert np.array_equal(port.map.kf_valid, ref.map.kf_valid)
    for k in np.nonzero(ref.map.kf_valid)[0]:
        assert np.abs(port.map.kf_t[k] - ref.map.kf_t[k]).max() < 1e-3, "keyframe t: 1 mm"
