"""Loop closing of the PyTorch port against the JAX reference, system level,
on the CPU: both Systems at their defaults (mapping, loop closing, packaged
vocabulary, synchronous) over the cylinder-world orbit of
tests/test_loop.py, cut to its first 110 frames. The reference closes its
loop at frame 103 (keyframe 16 against keyframe 4); the run stops 7 frames
later, past the frames that track against the corrected map.

The reference drive runs in a child process while this process drives the
port. The child also saves map checkpoints at the entry of the reference's
successful `_compute_sim3` and of its `_correct_loop`, with their arguments
and its RANSAC key; both are replayed here through the port and the
reference, the port's RANSAC fed the reference's samples.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orb_slam2_2021_tpu.config import synthetic_config
from orb_slam2_2021_tpu.io.persistence import load_map
from orb_slam2_2021_tpu.io.synthetic import SyntheticCylinderWorld, orbit_trajectory
from orb_slam2_2021_tpu.io.trajectory import ate_rmse
from orb_slam2_2021_tpu_torch.convert import config_from_reference
from orb_slam2_2021_tpu_torch.io.persistence import load_map as port_load_map
from orb_slam2_2021_tpu_torch.pipeline.system import System as TSystem

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 110
LOOP_FRAME, LOOP_KF, LOOP_MATCH = 103, 16, 4

REFERENCE_DRIVE = textwrap.dedent("""
    import os, pickle, sys
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_default_matmul_precision", "highest")
    import numpy as np
    from orb_slam2_2021_tpu.config import synthetic_config
    from orb_slam2_2021_tpu.io.persistence import save_map
    from orb_slam2_2021_tpu.io.synthetic import SyntheticCylinderWorld, orbit_trajectory
    from orb_slam2_2021_tpu.pipeline.system import System

    out, n = sys.argv[1], int(sys.argv[2])
    cfg = synthetic_config(320, 240)
    world = SyntheticCylinderWorld(cfg, seed=3)
    s = System(cfg)
    lc = s.loop_closer
    rec = {"tracked": [], "n_kf": [], "n_loops": [], "poses": [], "replay": [], "rebase": [],
           "sim3": None, "correct": None}
    sim3, correct, process_new, rebase = (lc._compute_sim3, lc._correct_loop,
                                          s.grid_mapper.process_new,
                                          s.tracker._rebase_on_map_correction)

    def hooked_sim3(k, candidates):
        path = os.path.join(out, "sim3_entry.npz")
        save_map(path, lc.map)
        key = np.asarray(lc._key)
        res = sim3(k, candidates)
        if res is not None:
            rec["sim3"] = dict(k=k, candidates=list(candidates), key=key, result=res,
                               frame=len(rec["tracked"]))
            os.replace(path, os.path.join(out, "sim3_ok.npz"))
        return res

    def hooked_correct(k, loop_kf, scw, matched):
        save_map(os.path.join(out, "correct_entry.npz"), lc.map)
        rec["correct"] = dict(k=k, loop_kf=loop_kf, scw=scw, matched=matched.copy(),
                              frame=len(rec["tracked"]))
        return correct(k, loop_kf, scw, matched)

    def hooked_process_new(loop_closed=False):
        rec["replay"][-1] = rec["replay"][-1] or bool(loop_closed)
        return process_new(loop_closed)

    def hooked_rebase():
        r = rebase()
        rec["rebase"][-1] = rec["rebase"][-1] or r
        return r

    lc._compute_sim3, lc._correct_loop = hooked_sim3, hooked_correct
    s.grid_mapper.process_new = hooked_process_new
    s.tracker._rebase_on_map_correction = hooked_rebase
    for i, (R, t) in enumerate(orbit_trajectory(128, total_deg=560.0, r_orbit=1.5)[:n]):
        rec["replay"].append(False)
        rec["rebase"].append(False)
        p = s.track_stereo(*world.render(R, t), timestamp=0.1 * i)
        rec["tracked"].append(p is not None)
        rec["n_kf"].append(int(s.map.n_kf))
        rec["n_loops"].append(lc.n_loops)
        rec["poses"].append(None if p is None else (p[0].copy(), p[1].copy()))
    s.shutdown()
    rec["traj"] = s.trajectory_kitti()
    rec["kf_frame_id"] = s.map.kf_frame_id[: s.map.next_kf].copy()
    rec["loop_edges"] = {k: set(v) for k, v in s.map.loop_edges.items()}
    rec["gba_iters"] = len(lc.gba_iter_times)
    pickle.dump(rec, open(os.path.join(out, "reference.pkl"), "wb"))
""")


def _drive_port(n):
    cfg = synthetic_config(320, 240)
    world = SyntheticCylinderWorld(cfg, seed=3)
    s = TSystem(config_from_reference(cfg), device="cpu")
    rec = {"tracked": [], "n_kf": [], "n_loops": [], "poses": [], "replay": [], "rebase": []}
    process_new, rebase = s.grid_mapper.process_new, s.tracker._rebase_on_map_correction

    def hooked_process_new(loop_closed=False):
        rec["replay"][-1] = rec["replay"][-1] or bool(loop_closed)
        return process_new(loop_closed)

    def hooked_rebase():
        r = rebase()
        rec["rebase"][-1] = rec["rebase"][-1] or r
        return r

    s.grid_mapper.process_new = hooked_process_new
    s.tracker._rebase_on_map_correction = hooked_rebase
    for i, (R, t) in enumerate(orbit_trajectory(128, total_deg=560.0, r_orbit=1.5)[:n]):
        rec["replay"].append(False)
        rec["rebase"].append(False)
        p = s.track_stereo(*world.render(R, t), timestamp=0.1 * i)
        rec["tracked"].append(p is not None)
        rec["n_kf"].append(int(s.map.n_kf))
        rec["n_loops"].append(s.loop_closer.n_loops)
        rec["poses"].append(None if p is None else (p[0].copy(), p[1].copy()))
    s.shutdown()
    rec["traj"] = s.trajectory_kitti()
    rec["kf_frame_id"] = s.map.kf_frame_id[: s.map.next_kf].copy()
    rec["loop_edges"] = {k: set(v) for k, v in s.map.loop_edges.items()}
    runs = s.loop_closer.gba_runs
    rec["gba_iters"] = runs[-1]["iters"] if runs else 0
    rec["occupied"] = int((s.occupancy_grid().data == 100).sum())
    return rec


@pytest.fixture(scope="module")
def drives(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("loop"))
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               JAX_PLATFORMS="cpu")
    child = subprocess.Popen([sys.executable, "-c", REFERENCE_DRIVE, out, str(N_FRAMES)],
                             cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    try:
        port = _drive_port(N_FRAMES)
    finally:
        _, err = child.communicate(timeout=900)
    assert child.returncode == 0, err.decode()[-3000:]
    ref = pickle.load(open(os.path.join(out, "reference.pkl"), "rb"))
    return ref, port, out


def _gt_in_slam_frame(n):
    gt = orbit_trajectory(128, total_deg=560.0, r_orbit=1.5)[:n]
    T0 = np.eye(4)
    T0[:3, :3], T0[:3, 3] = gt[0]
    out = []
    for R, t in gt:
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        out.append(np.linalg.inv(T0) @ T)
    return out


def test_port_closes_the_reference_loop(drives):
    """Same tracked flags and keyframe counts on every frame, the same
    keyframes, one loop between the same pair at the same frame, the grid
    replayed on the same frame, the frame after the loop re-anchored, poses
    within 5 cm (measured 2.5 cm: float32 chains drift apart over 100
    frames) and unaligned ATE within 2 cm of the reference's."""
    ref, port, _ = drives
    assert port["tracked"] == ref["tracked"] and all(ref["tracked"])
    assert port["n_kf"] == ref["n_kf"]
    assert np.array_equal(port["kf_frame_id"], ref["kf_frame_id"])
    assert ref["correct"]["frame"] == LOOP_FRAME
    assert (ref["correct"]["k"], ref["correct"]["loop_kf"]) == (LOOP_KF, LOOP_MATCH)
    first = [i for i, n in enumerate(port["n_loops"]) if n > 0]
    assert first and first[0] == LOOP_FRAME and port["n_loops"] == ref["n_loops"]
    assert port["loop_edges"] == ref["loop_edges"] == {LOOP_KF: {LOOP_MATCH}, LOOP_MATCH: {LOOP_KF}}
    assert port["gba_iters"] == ref["gba_iters"] == 10
    replay = np.nonzero(port["replay"])[0].tolist()
    assert replay == np.nonzero(ref["replay"])[0].tolist() == [LOOP_FRAME]
    assert port["rebase"][LOOP_FRAME + 1] and ref["rebase"][LOOP_FRAME + 1]
    assert port["occupied"] > 50
    worst = max(max(np.abs(a[0] - b[0]).max(), np.abs(a[1] - b[1]).max())
                for a, b in zip(port["poses"], ref["poses"]))
    assert worst < 0.05, f"poses differ by {worst:.4f} (tolerance 5 cm / 0.05)"
    gt = _gt_in_slam_frame(N_FRAMES)
    ate_p = ate_rmse(port["traj"], gt, align=False)
    ate_r = ate_rmse(ref["traj"], gt, align=False)
    assert np.isfinite(ate_p) and abs(ate_p - ate_r) < 0.02, \
        f"unaligned ATE {ate_p:.4f} m vs the reference's {ate_r:.4f} m (margin 2 cm)"


def _reference_sim3_sampler(key):
    """Replays the reference's RANSAC draws: one key split per candidate
    that reaches RANSAC, the sets drawn over its power-of-two padding."""
    state = {"key": jnp.asarray(key, jnp.uint32)}

    def sampler(valid, m, n_hyps):
        n = len(valid)
        pad = max(64, int(2 ** np.ceil(np.log2(max(n, 2)))))
        state["key"], sub = jax.random.split(state["key"])
        probs = jnp.asarray(np.arange(pad) < n, jnp.float32)
        probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
        idx = jax.vmap(lambda k: jax.random.choice(k, pad, shape=(m,), replace=False, p=probs))(
            jax.random.split(sub, n_hyps))
        return torch.from_numpy(np.asarray(idx).astype(np.int64))

    return sampler


def _port_loop_closer(m, cfg):
    from orb_slam2_2021_tpu_torch.pipeline.local_mapping import LocalMapping
    from orb_slam2_2021_tpu_torch.pipeline.loop_closing import LoopClosing
    from orb_slam2_2021_tpu_torch.place.bundle import PACKAGED_VOCAB_SMALL, PlaceRecognition
    from orb_slam2_2021_tpu_torch.place.vocab import BinaryVocabulary

    pr = PlaceRecognition(BinaryVocabulary.load(PACKAGED_VOCAB_SMALL), device="cpu")
    cfg = config_from_reference(cfg)
    lc = LoopClosing(cfg, m, pr.kfdb, "cpu")
    lc.local_mapper = LocalMapping(cfg, m, "cpu")
    lc.local_mapper.loop_closer = lc
    return lc


def test_compute_sim3_from_checkpoint(drives):
    """The port's _compute_sim3 on the reference's map at the loop, with the
    reference's RANSAC samples: the same loop keyframe and the same matched
    map points; Scw within 1e-4 (R) and 1 mm (t)."""
    ref, _, out = drives
    cfg = synthetic_config(320, 240)
    c = ref["sim3"]
    m, _ = port_load_map(os.path.join(out, "sim3_ok.npz"), config_from_reference(cfg))
    lc = _port_loop_closer(m, cfg)
    lc.sampler = _reference_sim3_sampler(c["key"])
    res = lc._compute_sim3(c["k"], c["candidates"])
    assert res is not None
    loop_kf, (s, R, t), matched = res
    r_kf, (rs, rR, rt), r_matched = c["result"]
    assert loop_kf == r_kf == LOOP_MATCH
    assert np.array_equal(matched, r_matched) and (matched >= 0).sum() >= 40
    assert s == rs == 1.0
    assert np.abs(R - rR).max() < 1e-4 and np.abs(t - rt).max() < 1e-3


def test_correct_loop_from_checkpoint(drives):
    """The reference's and the port's _correct_loop on two copies of the
    reference's map at the loop, same arguments: identical bindings, loop
    edges and keyframe set; keyframe poses within 1e-3 (R) and 5 mm (t),
    map points within 2 cm (global BA moves weakly constrained points)."""
    from orb_slam2_2021_tpu.pipeline.local_mapping import LocalMapping as JLM
    from orb_slam2_2021_tpu.pipeline.loop_closing import LoopClosing as JLC
    from orb_slam2_2021_tpu.place.bundle import PACKAGED_VOCAB_SMALL, PlaceRecognition
    from orb_slam2_2021_tpu.place.vocab import BinaryVocabulary

    ref, _, out = drives
    cfg = synthetic_config(320, 240)
    c = ref["correct"]
    path = os.path.join(out, "correct_entry.npz")
    mj, _ = load_map(path, cfg)
    mt, _ = port_load_map(path, config_from_reference(cfg))
    jlc = JLC(cfg, mj, PlaceRecognition(BinaryVocabulary.load(PACKAGED_VOCAB_SMALL)).kfdb)
    jlc.local_mapper = JLM(cfg, mj)
    tlc = _port_loop_closer(mt, cfg)
    args = (c["k"], c["loop_kf"], c["scw"], c["matched"])
    jlc._correct_loop(*args)
    tlc._correct_loop(*args)
    assert mt.loop_edges == mj.loop_edges
    assert np.array_equal(mt.kf_valid, mj.kf_valid) and np.array_equal(mt.mp_valid, mj.mp_valid)
    assert np.array_equal(mt.kf_mp, mj.kf_mp), "bindings: identical"
    assert np.array_equal(mt.mp_replaced_by, mj.mp_replaced_by)
    kfs = np.nonzero(mj.kf_valid)[0]
    dR = np.abs(mt.kf_R[kfs] - mj.kf_R[kfs]).max()
    dt = np.abs(mt.kf_t[kfs] - mj.kf_t[kfs]).max()
    assert dR < 1e-3 and dt < 5e-3, f"keyframe poses differ by {dR:.2e} (R), {dt:.2e} m (t)"
    mps = np.nonzero(mj.mp_valid)[0]
    dp = np.abs(mt.mp_pos[mps] - mj.mp_pos[mps]).max()
    assert dp < 0.02, f"map points differ by {dp:.4f} m (tolerance 2 cm)"
    assert tlc.n_loops == jlc.n_loops == 1 and tlc.gba_runs[-1]["iters"] == len(jlc.gba_iter_times) == 10
    assert mt.mp_pos.dtype == mj.mp_pos.dtype == np.float32
    assert mt.kf_R.dtype == mj.kf_R.dtype == np.float32
