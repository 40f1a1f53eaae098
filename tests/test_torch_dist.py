"""The port's multi-GPU layer (`orb_slam2_2021_tpu_torch/parallel/`) held
against the JAX reference's: `shard_ba_problem` identical for 2, 4 and 8
shards; then two gloo ranks on the CPU (tests/torch_dist_ranks.py, file
rendezvous, one spawn for the whole module) run the sharded dense BA, three
sharded global-BA iterations and the lockstep service with a stopped solve,
each held against the reference's 8-device mesh and against the port's
single-process solver on the same numpy inputs; and the port's twins of
__graft_entry__ run (a second spawn, three ranks). The dense eigenproblem
runs in float32 there, as in the reference (the port's default is float64).
"""

import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from orb_slam2_2021_tpu.config import OptimConfig as JOptim
from orb_slam2_2021_tpu.optim.ba import BAProblem as JProb
from orb_slam2_2021_tpu.parallel import dist_ba as jdist
from orb_slam2_2021_tpu_torch.config import OptimConfig
from orb_slam2_2021_tpu_torch.convert import ba_problem_from_reference
from orb_slam2_2021_tpu_torch.geometry.camera import PinholeCamera as TCam
from orb_slam2_2021_tpu_torch.optim import ba as tba
from orb_slam2_2021_tpu_torch.optim.ba import ba_solve
from orb_slam2_2021_tpu_torch.optim.ba_cg import flat_index, gba_iteration
from orb_slam2_2021_tpu_torch import graft_entry
from orb_slam2_2021_tpu_torch.parallel import dist_ba as tdist

from test_ba import CAM, CFG, build_problem
from test_torch_gba import _flat_problem
from torch_dist_ranks import spawn_ranks

torch.set_num_threads(1)

CAM_ARGS = (400.0, 400.0, 320.0, 240.0, 80.0, 640, 480)
TCAM = TCam.create(*CAM_ARGS)
GBA_CFG = JOptim(cg_iters=16)


@pytest.fixture(autouse=True)
def reference_eig_dtype(monkeypatch):
    monkeypatch.setattr(tba, "EIG_DTYPE", torch.float32)


def _dense_problem():
    prob, *_ = build_problem(np.random.default_rng(0), n_cams=6, n_pts=128, noise=0.05)
    return prob


def _gba_problem():
    return _flat_problem(np.random.default_rng(0), P=304)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_shard_ba_problem_matches_reference(n):
    """Integer arrays identical, float arrays identical, and every valid
    pt_obs entry points at an observation of its point."""
    for prob in (_dense_problem(), JProb(*(jnp.asarray(x) for x in _gba_problem()))):
        ref = jdist.shard_ba_problem(prob, n)
        out = tdist.shard_ba_problem(JProb(*(np.asarray(x) for x in prob)), n)
        for name, a, b in zip(JProb._fields, ref, out):
            assert np.array_equal(np.asarray(a), b) and np.asarray(a).dtype == b.dtype, name
        po = out.pt_obs
        ok = po >= 0
        assert np.array_equal(out.obs_pt[po[ok]], np.nonzero(ok)[0])
        assert out.obs_valid.sum() == np.asarray(prob.obs_valid).sum()


def test_local_shard_is_the_slice_in_its_own_numbering():
    packed = tdist.shard_ba_problem(JProb(*(np.asarray(x) for x in _dense_problem())), 2)
    P_loc, O_loc = 64, packed.obs_cam.shape[0] // 2
    for r in range(2):
        sh = tdist.local_shard(packed, r, 2)
        assert sh.xw.shape[0] == P_loc and sh.obs_cam.shape[0] == O_loc
        assert sh.obs_pt.min() >= 0 and sh.obs_pt.max() < P_loc
        ok = sh.pt_obs >= 0
        assert np.array_equal(sh.obs_pt[sh.pt_obs[ok]], np.nonzero(ok)[0])
        assert np.array_equal(sh.R, packed.R) and np.array_equal(sh.cam_free, packed.cam_free)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Two gloo ranks' outputs (rank0, rank1) and the inputs they got."""
    tmp = tmp_path_factory.mktemp("dist")
    dense = tdist.shard_ba_problem(JProb(*(np.asarray(x) for x in _dense_problem())), 2)
    flat = tdist.shard_ba_problem(_gba_problem(), 2)
    inp = str(tmp / "in.npz")
    np.savez(inp, cam=np.array(CAM_ARGS), iters=np.array([CFG.local_ba_iters1, CFG.local_ba_iters2]),
             cg_iters=np.array(GBA_CFG.cg_iters),
             **{"dense_" + f: v for f, v in zip(JProb._fields, dense)},
             **{"gba_" + f: v for f, v in zip(JProb._fields, flat)})
    spawn_ranks(2, str(tmp / "rendezvous"), inp, str(tmp))
    out = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(2)]
    return out, dense, flat, tmp


def _mesh():
    return Mesh(np.array(jax.devices()[:8]), (jdist.AXIS,))


def _by_pair(prob, flags):
    """{(camera, point): flag} over the valid observations."""
    cam, pt, valid = (np.asarray(x) for x in (prob.obs_cam, prob.obs_pt, prob.obs_valid))
    return {(int(c), int(p)): bool(f) for c, p, v, f in zip(cam, pt, valid, np.asarray(flags)) if v}


def test_dist_ba_two_ranks_matches_reference_mesh_and_single_process(ranks):
    """The sharded dense BA over two ranks against the reference's on its
    8-device mesh and against the port's `ba_solve` in one process: R
    within 1e-5, t within 1e-5 m, points within 1e-4 m, inlier flags of
    every observation identical; both ranks hold the same cameras."""
    (r0, r1), dense, _, _ = ranks
    prob = _dense_problem()
    jsh = jdist.shard_ba_problem(prob, 8)
    jR, jt, jx, jin = jdist.make_dist_ba(CFG, _mesh())(CAM, jsh)
    sR, st, sx, sin = ba_solve(TCAM, ba_problem_from_reference(prob, "cpu"), OptimConfig(),
                               CFG.local_ba_iters1, CFG.local_ba_iters2)
    assert np.array_equal(r0["dense_R"], r1["dense_R"]) and np.array_equal(r0["dense_t"], r1["dense_t"])
    for R, t, xw in ((jR, jt, jx), (sR.numpy(), st.numpy(), sx.numpy())):
        assert np.abs(r0["dense_R"] - np.asarray(R)).max() < 1e-5, "R: tolerance 1e-5"
        assert np.abs(r0["dense_t"] - np.asarray(t)).max() < 1e-5, "t: tolerance 1e-5 m"
        assert np.abs(r0["dense_xw"] - np.asarray(xw)).max() < 1e-4, "xw: tolerance 1e-4 m"
    port = _by_pair(dense, r0["dense_inlier"])
    assert port == _by_pair(jsh, jin) == _by_pair(prob, sin.numpy()), "inlier flags: identical"
    assert sum(port.values()) > 0.9 * len(port)


def test_dist_gba_iteration_two_ranks_matches_reference_mesh_and_single_process(ranks):
    """Three sharded global-BA iterations over two ranks against the
    reference's `make_dist_gba_iteration` on its 8-device mesh and the
    port's `gba_iteration` in one process: R within 1e-5, t within 1e-4 m,
    points within 1e-3 m, the costs within 1e-4 relative, lambda equal."""
    (r0, r1), _, _, _ = ranks
    flat = _gba_problem()
    jp = JProb(*(jnp.asarray(x) for x in flat))
    jsh = jdist.shard_ba_problem(jp, 8)
    jstep = jdist.make_dist_gba_iteration(GBA_CFG, _mesh(), CAM)
    tp = ba_problem_from_reference(flat, "cpu")
    index = flat_index(tp)
    jR, jt, jx, jlam = jsh.R, jsh.t, jsh.xw, jnp.float32(GBA_CFG.lm_lambda_init)
    R, t, xw, lam = tp.R, tp.t, tp.xw, torch.tensor(GBA_CFG.lm_lambda_init)
    cfg = OptimConfig(cg_iters=GBA_CFG.cg_iters)
    for i in range(3):
        jR, jt, jx, jlam, jcost = jstep(jsh, jR, jt, jx, jlam, jsh.obs_valid.astype(jnp.float32),
                                        jnp.bool_(True))
        R, t, xw, lam, cost = gba_iteration(TCAM, tp, index, R, t, xw, lam, tp.obs_valid.float(),
                                            True, cfg)
        assert abs(float(r0["gba_costs"][i]) - float(jcost)) <= 1e-4 * float(jcost)
        assert abs(float(r0["gba_costs"][i]) - float(cost)) <= 1e-4 * float(cost)
    assert float(r0["gba_lam"]) == float(jlam) == float(lam)
    assert np.array_equal(r0["gba_t"], r1["gba_t"]) and np.array_equal(r0["gba_xw"], r1["gba_xw"])
    for Rr, tr, xr in ((jR, jt, jx), (R.numpy(), t.numpy(), xw.numpy())):
        assert np.abs(r0["gba_R"] - np.asarray(Rr)).max() < 1e-5, "R: tolerance 1e-5"
        assert np.abs(r0["gba_t"] - np.asarray(tr)).max() < 1e-4, "t: tolerance 1e-4 m"
        assert np.abs(r0["gba_xw"] - np.asarray(xr)).max() < 1e-3, "xw: tolerance 1e-3 m"
    assert np.abs(r0["gba_t"] - flat.t).max() > 0.01, "the solve moved the cameras"


def test_gba_service_lockstep_and_stop(ranks):
    """The leader's first solve (4 iterations, 2 chunks) equals four of the
    port's single-process iterations (R 1e-5, t 1e-4 m, xw 1e-3 m); the
    second, stopped at its second chunk, returns None after 2 iterations;
    the server saw both problems and returned on shutdown."""
    (r0, r1), _, flat, tmp = ranks
    tp = ba_problem_from_reference(_gba_problem(), "cpu")
    index = flat_index(tp)
    cfg = OptimConfig(cg_iters=GBA_CFG.cg_iters)
    R, t, xw, lam = tp.R, tp.t, tp.xw, torch.tensor(cfg.lm_lambda_init)
    for _ in range(4):
        R, t, xw, lam, _ = gba_iteration(TCAM, tp, index, R, t, xw, lam, tp.obs_valid.float(), True, cfg)
    assert np.abs(r0["svc_R"] - R.numpy()).max() < 1e-5
    assert np.abs(r0["svc_t"] - t.numpy()).max() < 1e-4
    assert r0["svc_xw"].shape == (304, 3) and np.abs(r0["svc_xw"] - xw.numpy()).max() < 1e-3
    assert bool(r0["svc_stopped"]) and int(r0["svc_stop_iters"]) == 2
    assert int(r1["svc_solved"]) == 2
    work = os.path.join(tmp, "work")
    assert sorted(f for f in os.listdir(work) if f.startswith("chunk_1")) == ["chunk_1_0.json", "chunk_1_1.json"]


@pytest.fixture(scope="module")
def graft_ranks():
    """The summaries of one three-rank gloo dry run (one spawn)."""
    return graft_entry.dryrun_multichip(3, "cpu")


def test_graft_entry_twins(graft_ranks):
    """The twins of __graft_entry__: entry() builds a KITTI-size stereo
    frame; dryrun_multichip(3) runs three gloo ranks (one spawn), each with
    the sharded BA step and the extraction of its own image (keypoint count
    all-reduced), then rank 0's `_run_global_ba` through the group, written
    back, while ranks 1 and 2 serve it."""
    fn, (images,) = graft_entry.entry("cpu")
    assert tuple(images.shape) == (2, 376, 1241)
    frame = fn(images)
    assert frame.kp.xy.shape == (2000, 2) and int(frame.kp.valid.sum()) > 500
    ranks = graft_ranks
    assert [r["rank"] for r in ranks] == [0, 1, 2]
    assert all(r["backend"] == "gloo" and r["ba_points"] == 66 for r in ranks)
    assert len({r["keypoints_all_ranks"] for r in ranks}) == 1 and ranks[0]["keypoints_all_ranks"] > 0
    assert ranks[0]["gba"] == "written" and ranks[1]["gba_served"] == ranks[2]["gba_served"] == 1


def test_graft_ranks_leave_nothing_holding_the_group(graft_ranks):
    """After `finish_process` no rank's garbage collector tracks a GbaClient,
    a GbaServer or anything that refers to a ProcessGroup, garbage included:
    the client and the servers drop the group themselves (no reference
    cycle keeps it for the interpreter's exit to destroy)."""
    assert [r["group_holders"] for r in graft_ranks] == [[], [], []]


@pytest.fixture
def group_of_one(tmp_path):
    """A gloo group of this process alone (file rendezvous), torn down
    after the test."""
    from orb_slam2_2021_tpu_torch.parallel.multihost import finish_process, init_process

    group, _ = init_process(f"file://{tmp_path}/rendezvous", 1, 0, device="cpu")
    yield group
    finish_process(group)


def test_run_global_ba_through_a_group_of_one(group_of_one, tmp_path):
    """`_run_global_ba` with a GbaClient over a group of one (the sharded
    step in process, the port's counterpart of System(mesh=...)) against
    the reference's mesh branch on its 8-device mesh, on two identically
    built maps: keyframe R within 1e-5, t within 1e-4 m, points within
    1e-3 m, written back; then a stopped run and a superseded one leave the
    map as it was."""
    from orb_slam2_2021_tpu.config import synthetic_config
    from orb_slam2_2021_tpu.pipeline.loop_closing import LoopClosing as JLC
    from orb_slam2_2021_tpu.place.kf_database import KeyFrameDatabase as JDB
    from orb_slam2_2021_tpu.place.vocab import BinaryVocabulary as JVoc
    from orb_slam2_2021_tpu_torch.convert import camera_from_config
    from orb_slam2_2021_tpu_torch.parallel.gba_service import GbaClient
    from orb_slam2_2021_tpu_torch.pipeline import loop_closing as tloop
    from orb_slam2_2021_tpu_torch.place.kf_database import KeyFrameDatabase as TDB
    from orb_slam2_2021_tpu_torch.place.vocab import BinaryVocabulary as TVoc
    from test_torch_gba import _stereo_map

    cfg = synthetic_config(width=320, height=240)
    mj, mt = _stereo_map(cfg), _stereo_map(cfg)
    voc = JVoc(2, 2, np.zeros((7, 8), np.uint32), np.ones(4, np.float32))
    jlc = JLC(cfg, mj, JDB(voc))
    jlc.mesh = _mesh()
    jlc._run_global_ba(idx=jlc.full_ba_idx)
    assert jlc._dist_step is not None, "the reference took its mesh branch"
    tlc = tloop.LoopClosing(cfg, mt, TDB(TVoc(2, 2, voc.node_desc, voc.word_idf)), "cpu")
    tlc.dist_gba = GbaClient(group_of_one, cfg.optim, camera_from_config(cfg), str(tmp_path / "work"), "cpu")
    t_before = mt.kf_t[:6].copy()
    tlc._run_global_ba()
    assert [g["outcome"] for g in tlc.gba_runs] == ["written"]
    assert tlc.gba_runs[-1]["iters"] == len(jlc.gba_iter_times) == cfg.optim.global_ba_iters
    assert sum(n for n, _ in tlc.gba_runs[-1]["chunks"]) == cfg.optim.global_ba_iters
    assert np.abs(mt.kf_R[:6] - mj.kf_R[:6]).max() < 1e-5
    assert np.abs(mt.kf_t[:6] - mj.kf_t[:6]).max() < 1e-4
    ids = np.nonzero(mj.mp_valid)[0]
    assert np.abs(mt.mp_pos[ids] - mj.mp_pos[ids]).max() < 1e-3
    assert np.abs(mt.kf_t[1:6] - t_before[1:]).max() > 0.005, "the solve moved the keyframes"

    after = mt.kf_t.copy(), mt.mp_pos.copy()
    tlc.stop_gba = True
    tlc._run_global_ba()
    tlc.stop_gba = False
    tlc._run_global_ba(idx=tlc.full_ba_idx - 1)
    assert [g["outcome"] for g in tlc.gba_runs] == ["written", "aborted", "superseded"]
    assert np.array_equal(mt.kf_t, after[0]) and np.array_equal(mt.mp_pos, after[1])
