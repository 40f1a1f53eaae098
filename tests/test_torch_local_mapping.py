"""Local mapping of the PyTorch port held against the JAX reference: one
`_process(k)` (point culling, triangulation, fusion, local BA, keyframe
culling) on two identical copies of a real map, one through each
LocalMapping; and the local BA problem of that keyframe assembled and
solved by both packages.

The map is the reference System's (mapping on, 320x240, synthetic stereo
world) just before it processes its third keyframe, which is the first
with a local BA.
"""

import copy
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orb_slam2_2021_tpu.config import synthetic_config
from orb_slam2_2021_tpu.geometry.camera import PinholeCamera
from orb_slam2_2021_tpu.io.synthetic import SyntheticStereoWorld, forward_trajectory
from orb_slam2_2021_tpu.mapping.map_store import MapStore
from orb_slam2_2021_tpu.optim import ba_cg as jcg
from orb_slam2_2021_tpu.pipeline import local_mapping as jlm_mod
from orb_slam2_2021_tpu_torch.convert import ba_problem_from_reference, camera_from_config
from orb_slam2_2021_tpu_torch.optim import assemble as tasm
from orb_slam2_2021_tpu_torch.pipeline import local_mapping as tlm_mod

torch.set_num_threads(1)

CFG = synthetic_config(width=320, height=240)
K_BA = 2  # the third keyframe (frame 19): the first local BA


class _Captured(Exception):
    pass


def _clone(m: MapStore) -> MapStore:
    """An independent copy of a MapStore (its lock is not copyable)."""
    c = MapStore.__new__(MapStore)
    for name, v in m.__dict__.items():
        if name == "lock":
            c.lock = threading.RLock()
        elif name == "on_kf_erased":
            c.on_kf_erased = None
        else:
            setattr(c, name, v.copy() if isinstance(v, np.ndarray) else copy.deepcopy(v))
    return c


@pytest.fixture(scope="module")
def before_ba():
    """(map, recent) of the reference System right before _process(K_BA)."""
    from orb_slam2_2021_tpu.pipeline.system import System as JSystem
    from orb_slam2_2021_tpu.place.bundle import PACKAGED_VOCAB_SMALL, PlaceRecognition
    from orb_slam2_2021_tpu.place.vocab import BinaryVocabulary

    world = SyntheticStereoWorld(CFG, seed=3)
    ref = JSystem(CFG, enable_mapping=True, enable_loop_closing=False,
                  place_rec=PlaceRecognition(BinaryVocabulary.load(PACKAGED_VOCAB_SMALL)))
    lm = ref.local_mapper
    process = lm._process
    cap = {}

    def capture(k, words=None):
        if k == K_BA:
            cap["map"], cap["recent"] = _clone(ref.map), dict(lm.recent)
            raise _Captured
        process(k, words)

    lm._process = capture
    for i, (R, t) in enumerate(forward_trajectory(20, step=0.12)):
        try:
            ref.track_stereo(*world.render(R, t), timestamp=0.1 * i)
        except _Captured:
            break
    assert "map" in cap, "the reference reached its third keyframe"
    return cap["map"], cap["recent"]


def _record(module, name, calls):
    orig = getattr(module, name)

    def rec(*args, **kw):
        out = orig(*args, **kw)
        calls.append((args, kw, out))
        return out
    return orig, rec


def test_process_keyframe_matches_reference(before_ba, monkeypatch):
    m0, recent = before_ba
    m_ref, m_port = _clone(m0), _clone(m0)
    j_calls, t_calls = [], []
    monkeypatch.setattr(jlm_mod, "assemble_ba_problem",
                        _record(jlm_mod, "assemble_ba_problem", j_calls)[1])
    monkeypatch.setattr(tlm_mod, "assemble_ba_problem",
                        _record(tlm_mod, "assemble_ba_problem", t_calls)[1])
    jlm = jlm_mod.LocalMapping(CFG, m_ref)
    jlm.recent = dict(recent)
    jlm._process(K_BA)
    tlm = tlm_mod.LocalMapping(CFG, m_port, "cpu")
    tlm.recent = dict(recent)
    tlm._process(K_BA)

    # the same BA window and padding on both sides
    assert len(j_calls) == len(t_calls) == 1
    (ja, jk, _), (ta, tk, _) = j_calls[0], t_calls[0]
    for a, b in zip(ja[1:4], ta[1:4]):
        assert np.array_equal(a, b), "BA cameras, free flags and points: identical"
    assert all(jk[x] == tk[x] for x in ("C_pad", "P_pad", "Q_pad")), "BA buckets: identical"

    n_new = m_ref.next_mp - m0.next_mp
    assert n_new > 20 and m_port.next_mp == m_ref.next_mp, "created points: identical count"
    assert np.array_equal(m_port.kf_mp, m_ref.kf_mp), "feature bindings: identical"
    assert np.array_equal(m_port.mp_valid, m_ref.mp_valid), "live points: identical"
    assert np.array_equal(m_port.kf_valid, m_ref.kf_valid), "culled keyframes: identical"
    assert np.array_equal(m_port.mp_obs_kf, m_ref.mp_obs_kf), "observations: identical"
    assert m_port.write_epoch == m_ref.write_epoch
    assert tlm.recent == jlm.recent
    # measured: t 9.5e-6 m, R 5.1e-7, live points 4.8e-4 m (128 new points)
    live = m_ref.mp_valid
    assert np.abs(m_port.kf_t - m_ref.kf_t).max() < 1e-4, "keyframe t: tolerance 1e-4 m"
    assert np.abs(m_port.kf_R - m_ref.kf_R).max() < 1e-5, "keyframe R: tolerance 1e-5"
    assert np.abs(m_port.mp_pos[live] - m_ref.mp_pos[live]).max() < 5e-3, "points: tolerance 5 mm"
    assert len(tlm.ba_solve_times) == len(jlm.ba_solve_times) == 1


def test_real_map_ba_problem_matches_reference(before_ba, monkeypatch):
    """The local BA problem of keyframe K_BA, assembled by both packages
    from the real map and solved by both LM chunks (5 Huber + 10 plain)."""
    m0, recent = before_ba
    assemble = jlm_mod.assemble_ba_problem
    calls = []

    def both(m, cams, free, mp, **kw):
        """The reference's assembly and the port's, on the map as it is
        when the reference assembles (after triangulation and fusion)."""
        ref = assemble(m, cams, free, mp, **kw)
        assert kw["pq_layout"] and not kw["device"]
        kw = {k: v for k, v in kw.items() if k != "device"}
        calls.append((ref, tasm.assemble_ba_problem(m, cams, free, mp, **kw)))
        return ref

    monkeypatch.setattr(jlm_mod, "assemble_ba_problem", both)
    jlm = jlm_mod.LocalMapping(CFG, _clone(m0))
    jlm.recent = dict(recent)
    jlm._process(K_BA)
    ref, out = calls[0]
    for name, a, b in zip(ref[0]._fields, ref[0], out[0]):
        assert np.array_equal(np.asarray(a), b), f"{name}: identical"
    for a, b in zip(ref[1:], out[1:]):
        assert np.array_equal(a, b), "observation sources: identical"

    prob_j = jcg.BAProblem(*(jnp.asarray(x) for x in ref[0]))
    ocfg = CFG.optim
    jcam = PinholeCamera.create(CFG.fx, CFG.fy, CFG.cx, CFG.cy, CFG.bf, CFG.width, CFG.height)
    lam = jnp.float32(ocfg.lm_lambda_init)
    R, t, xw, lam, inl = jcg.make_lm_chunk_pq(ocfg, ocfg.local_ba_iters1)(
        jcam, prob_j, prob_j.R, prob_j.t, prob_j.xw, lam,
        prob_j.obs_valid.astype(jnp.float32), jnp.bool_(True))
    R, t, xw, _, inl = jcg.make_lm_chunk_pq(ocfg, ocfg.local_ba_iters2)(
        jcam, prob_j, R, t, xw, lam, inl.astype(jnp.float32), jnp.bool_(False))

    prob_t = ba_problem_from_reference(ref[0], "cpu")
    tl = tlm_mod.LocalMapping(CFG, _clone(m0), "cpu")
    Rt, tt, xt, it = tl._solve_ba_abortable(prob_t)
    assert tl.cam == camera_from_config(CFG)
    assert np.array_equal(it.numpy(), np.asarray(inl)), "inlier mask: identical"
    assert (~np.asarray(inl) & ref[0].obs_valid).sum() > 0, "the solve found outliers"
    # measured: R 4.4e-7, t 8.8e-6 m, xw 5.2e-4 m (C=32, P=512, Q=4)
    assert np.abs(Rt.numpy() - np.asarray(R)).max() < 1e-5, "R: tolerance 1e-5"
    assert np.abs(tt.numpy() - np.asarray(t)).max() < 1e-4, "t: tolerance 1e-4 m"
    assert np.abs(xt.numpy() - np.asarray(xw)).max() < 5e-3, "xw: tolerance 5 mm"


def test_tracking_follows_map_corrections():
    """The two tracking paths mapping wakes, on the port alone: after the
    local BA of frame 19 moves the reference keyframe, the next frame
    re-anchors the cached poses (_rebase_on_map_correction) and rebuilds the
    local-map snapshot for the new write epoch; after the reference keyframe
    is culled, tracking goes on through its parent."""
    from orb_slam2_2021_tpu.io.trajectory import ate_rmse
    from orb_slam2_2021_tpu_torch.pipeline.system import System

    world = SyntheticStereoWorld(CFG, seed=3)
    gt = forward_trajectory(26, step=0.12)
    sys_ = System(CFG, enable_mapping=True, enable_loop_closing=False, device="cpu")
    tr = sys_.tracker
    events = []
    rebase, refresh = tr._rebase_on_map_correction, tr._refresh_snapshot
    tr._rebase_on_map_correction = lambda: events.append(("rebase", rebase())) or events[-1][1]
    tr._refresh_snapshot = lambda kfs: events.append(
        ("snapshot", refresh(kfs), sys_.map.write_epoch)) or events[-1][1]
    poses = []
    for i, (R, t) in enumerate(gt):
        if i == 24:
            # cull the reference keyframe as KeyFrameCulling would
            k = tr.ref_kf
            assert k > 0
            sys_.map.erase_keyframe(k)
            sys_.map.write_epoch += 1
            assert not sys_.map.kf_valid[k]
        events.append(("frame", i))
        poses.append(sys_.track_stereo(*world.render(R, t), timestamp=0.1 * i))
    sys_.shutdown()
    assert all(p is not None for p in poses), "26/26 frames tracked"
    kf_frames = [r["frame_id"] for r in sys_.metrics if r["keyframe"]]
    assert kf_frames[:3] == [0, 15, 19] and len(sys_.local_mapper.ba_solve_times) >= 1

    def after(frame):
        i = events.index(("frame", frame))
        j = events.index(("frame", frame + 1)) if ("frame", frame + 1) in events else len(events)
        return events[i + 1:j]

    # frame 20: the keyframe of frame 19 was moved by its local BA
    ev20 = after(20)
    assert ("rebase", True) in ev20, ev20
    snaps = [e for e in ev20 if e[0] == "snapshot"]
    assert snaps and snaps[0][1] is True, "snapshot rebuilt after the mapping epoch bump"
    # frames 24, 25: the culled reference keyframe resolves through its parent
    assert all(e != ("rebase", True) for e in after(24))
    est = [T for _, T in tr.trajectory()]
    gt_mats = []
    for R, t in gt:
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        gt_mats.append(T)
    # 320x240 drifts in the reference too (measured here 0.164 m over 3 m);
    # the bound catches a teleport after a correction, not drift
    assert ate_rmse(est, gt_mats) < 0.1 * 0.12 * (len(gt) - 1)


def test_keyframe_store_copies_the_frame():
    """A keyframe's device rows are a copy: the lane may drop or overwrite
    the frame's tensors afterwards without touching the keyframe."""
    from orb_slam2_2021_tpu_torch.frontend.features import Keypoints
    from orb_slam2_2021_tpu_torch.frontend.frame import Frame

    n = CFG.orb.n_features
    g = torch.Generator().manual_seed(0)
    kp = Keypoints(xy=torch.rand((n, 2), generator=g), response=torch.rand(n, generator=g),
                   octave=torch.randint(0, 4, (n,), generator=g, dtype=torch.int32),
                   angle=torch.rand(n, generator=g),
                   desc=torch.randint(-2 ** 31, 2 ** 31 - 1, (n, 8), generator=g, dtype=torch.int32),
                   valid=torch.ones(n, dtype=torch.bool))
    frame = Frame(kp=kp, u_right=torch.rand(n, generator=g), depth=torch.rand(n, generator=g),
                  sad_dist=torch.zeros(n))
    store = tlm_mod.DeviceKFStore(4, n, "cpu")
    store.set_from_frame(2, frame)
    kept = [x.clone() for x in (store.desc[2], store.xy[2], store.ur[2], store.depth[2], store.octave[2])]
    for x in (kp.desc, kp.xy, frame.u_right, frame.depth, kp.octave):
        x.zero_()
    for a, b in zip(kept, (store.desc[2], store.xy[2], store.ur[2], store.depth[2], store.octave[2])):
        assert torch.equal(a, b) and a.abs().sum() > 0
    view = store.gather_views(np.array([2, 2]), np.ones((2, n), bool), np.tile(np.eye(3), (2, 1, 1)),
                              np.zeros((2, 3)))
    assert torch.equal(view.desc[1], kept[0]) and view.R.dtype == torch.float32
