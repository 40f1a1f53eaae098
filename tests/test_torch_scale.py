"""The scale proof's twin, scripts/torch_scale_1500kf.py, held against the
reference's scripts/scale_1500kf.py and the JAX package on the CPU at 100
keyframes (the first curve row).

The twin draws from default_rng(0) in the reference's order, so its map is
the reference's bit for bit. The counts are those the reference script gives
on this tree's reference code (33,222 points at i = 99), which the test runs;
SCALE_1500KF.json's 33,217 was recorded before the reference's add_keyframe
began re-validating bindings of culled points, and no code of this tree
reproduces it.
"""

import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orb_slam2_2021_tpu.config import kitti_stereo_config as ref_kitti_config
from orb_slam2_2021_tpu.geometry.camera import PinholeCamera as RefCamera
from orb_slam2_2021_tpu.mapping.map_store import MapStore as RefMapStore
from orb_slam2_2021_tpu.optim.assemble import assemble_ba_problem as ref_assemble
from orb_slam2_2021_tpu.optim.assemble import global_problem_shapes as ref_shapes
from orb_slam2_2021_tpu.optim.ba_cg import make_gba_iteration as ref_gba_iteration
from orb_slam2_2021_tpu.pipeline.loop_closing import LoopClosing as RefLoopClosing
from orb_slam2_2021_tpu.place.bundle import PlaceRecognition as RefPlace
from orb_slam2_2021_tpu_torch.config import kitti_stereo_config
from orb_slam2_2021_tpu_torch.mapping.map_store import MapStore
from orb_slam2_2021_tpu_torch.place.bundle import PlaceRecognition

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "scripts"))
import torch_scale_1500kf as twin  # noqa: E402

N_KF = 100
POSE_TOL = 1e-4  # m and rotation entries


@pytest.fixture(scope="module")
def places():
    return RefPlace.load_default(), PlaceRecognition.load_default("cpu")


def _grow(places):
    """Both packages' maps grown by the twin's loop: (ref cfg, ref map, ref
    kfdb, port cfg, port map, port kfdb, port curves)."""
    ref_place, port_place = places
    out = []
    for cfg, store, place in ((ref_kitti_config(), RefMapStore, ref_place),
                              (kitti_stereo_config(), MapStore, port_place)):
        place.kfdb.clear()
        m = store(cfg)
        m.on_kf_erased = place.kfdb.erase
        curves = twin.grow(cfg, m, place.kfdb, place.voc.n_words, N_KF, log=lambda *a: None)
        out.append((cfg, m, place.kfdb, curves))
    return out


def test_twin_growth_gives_the_reference_scripts_curve(places, tmp_path):
    """The reference script itself at 100 keyframes (its JSON written in a
    scratch directory) against the twin's growth: every curve row's counts
    and the final keyframe, point and observation counts."""
    env = dict(os.environ, SCALE_PLATFORM="cpu", JAX_PLATFORMS="cpu")
    res = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "scale_1500kf.py"), str(N_KF)],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    ref = json.loads((tmp_path / "SCALE_1500KF.json").read_text())
    (_, _, _, _), (cfg, m, _, curves) = _grow(places)
    assert [(r["n_kf"], r["n_mp"]) for r in curves] == [(r["n_kf"], r["n_mp"]) for r in ref["curves"]]
    assert curves[0]["n_kf"] == 98 and curves[0]["n_mp"] == 33222
    mp = np.nonzero(m.mp_valid)[0]
    mp = mp[m.mp_obs_n[mp] > 0]
    got = (m.n_kf, int(m.mp_valid.sum()), int(np.count_nonzero(m.mp_obs_kf[mp] >= 0)))
    assert got == (ref["n_kf_final"], ref["n_mp_final"], ref["n_obs_final"])


def test_twin_map_equals_the_reference_map(places):
    """covis, kf_valid and mp_obs_kf (and the rest of the growth's arrays)
    bit for bit against the reference's MapStore on the same stream."""
    (_, rm, rdb, _), (_, m, db, _) = _grow(places)
    for name in ("covis", "kf_valid", "mp_obs_kf", "mp_obs_feat", "mp_obs_n", "mp_valid", "mp_pos",
                 "kf_mp", "kf_R", "kf_t", "parent"):
        assert np.array_equal(getattr(m, name), getattr(rm, name)), name
    assert sorted(db.words) == sorted(rdb.words)
    assert sorted(db.inverted) == sorted(rdb.inverted)


def test_three_gba_iterations_take_the_references_steps(places):
    """Three Huber gba_iteration steps on the 100-keyframe map against the
    reference's make_gba_iteration: the same accept/reject path (the final
    damping) and the same poses; the robust cost never rises. On this map
    (random observations) both reject all three steps: the cost stays."""
    (rcfg, rm, _, _), (cfg, m, _, _) = _grow(places)
    out = twin.global_ba(cfg, m, torch.device("cpu"), log=lambda *a: None)
    kfs = np.nonzero(rm.kf_valid)[0]
    mp = np.nonzero(rm.mp_valid)[0]
    mp = mp[rm.mp_obs_n[mp] > 0]
    n_obs = int(np.count_nonzero(rm.mp_obs_kf[mp] >= 0))
    prob, _, _, _ = ref_assemble(rm, kfs, kfs != kfs[0], mp, *ref_shapes(len(kfs), len(mp), n_obs))
    cam = RefCamera.create(rcfg.fx, rcfg.fy, rcfg.cx, rcfg.cy, rcfg.bf, rcfg.width, rcfg.height)
    step = ref_gba_iteration(rcfg.optim)
    R, t, xw = prob.R, prob.t, prob.xw
    lam = jnp.float32(rcfg.optim.lm_lambda_init)
    active = prob.obs_valid.astype(jnp.float32)
    for _ in range(3):
        R, t, xw, lam, _ = step(cam, prob, R, t, xw, lam, active, jnp.bool_(True))
    assert (out["C"], out["P"], out["O"]) == (len(kfs), len(mp), n_obs)
    assert np.isclose(out["lam"], float(lam), rtol=1e-6)
    assert np.abs(out["R"] - np.asarray(R)).max() < POSE_TOL
    assert np.abs(out["t"] - np.asarray(t)).max() < POSE_TOL
    assert np.isfinite(out["costs"]).all() and np.isfinite(out["cost_before"])
    assert out["cost_after"] <= out["cost_before"]


def test_essential_graph_matches_the_reference(places):
    """LoopClosing._optimize_essential_graph over every keyframe (the
    reference script's loop edge, last to first) on both maps: poses and
    points within 1e-4 of the reference's; the edge cost does not rise."""
    (rcfg, rm, rdb, _), (cfg, m, db, _) = _grow(places)
    out = twin.essential_graph(cfg, m, db, torch.device("cpu"), log=lambda *a: None)
    kfs = np.nonzero(rm.kf_valid)[0]
    lc = RefLoopClosing(rcfg, rm, rdb)
    lc.loop_edges.setdefault(int(kfs[-1]), set()).add(int(kfs[0]))
    lc._optimize_essential_graph(int(kfs[-1]), int(kfs[0]),
                                 {int(kfs[-1]): (1.0, rm.kf_R[kfs[-1]].copy(), rm.kf_t[kfs[-1]].copy())},
                                 {}, {})
    assert out["K"] == len(kfs) and out["E"] == len(kfs)  # the spanning tree and the loop edge
    assert out["incidence_bytes"] == 2 * out["E_pad"] * out["K_pad"] * 4
    assert np.abs(m.kf_R - rm.kf_R).max() < POSE_TOL
    assert np.abs(m.kf_t - rm.kf_t).max() < POSE_TOL
    assert np.abs(m.mp_pos - rm.mp_pos).max() < POSE_TOL
    assert out["cost_after"] <= out["cost_before"]


def test_main_writes_the_record(tmp_path):
    """`torch_scale_1500kf.py 12 --device cpu --out F` writes the record;
    SCALE_1500KF.json is refused as --out."""
    path = tmp_path / "scale.json"
    twin.main(["12", "--device", "cpu", "--out", str(path)])
    rec = json.loads(path.read_text())
    assert rec["n_kf_final"] == 12 and rec["curves"] == [] and rec["platform"] == "cpu"
    assert rec["poses_finite"] and len(rec["gba_iter_s"]) == 3
    assert rec["essential_graph"]["launches"] is None and rec["peak_memory_bytes"] is None
    with pytest.raises(SystemExit):
        twin.main(["12", "--device", "cpu", "--out", os.path.join(REPO, "SCALE_1500KF.json")])
