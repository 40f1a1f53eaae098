"""Map save/load and BoW relocalization of the PyTorch port against the JAX
reference on the CPU: the reference System drives the sequence of
tests/test_persistence.py and saves its map; both Systems boot from that
file (BoW recomputed, tracker LOST) and are shown the frame at gt[8]."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orb_slam2_2021_tpu.config import synthetic_config
from orb_slam2_2021_tpu.io.synthetic import SyntheticStereoWorld, forward_trajectory
from orb_slam2_2021_tpu_torch.convert import config_from_reference, samples_from_reference
from orb_slam2_2021_tpu_torch.pipeline.system import System as TSystem

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def saved_map(tmp_path_factory):
    from orb_slam2_2021_tpu.pipeline.system import System as JSystem

    cfg = synthetic_config(width=320, height=240)
    world = SyntheticStereoWorld(cfg, seed=6)
    gt = forward_trajectory(28, step=0.12)
    s = JSystem(cfg)
    for i, (R, t) in enumerate(gt):
        s.track_stereo(*world.render(R, t), timestamp=i * 0.1)
    path = str(tmp_path_factory.mktemp("map") / "map.npz")
    s.save_map(path)
    s.shutdown()
    return cfg, path, world.render(*gt[8]), int(s.map.n_kf)


def _reference_samples(valid, m, n_hyps, seed):
    """The minimal sets the reference's EPnP draws for a candidate."""
    probs = jnp.asarray(valid, jnp.float32)
    probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
    keys = jax.random.split(jax.random.PRNGKey(seed), n_hyps)
    idx = jax.vmap(lambda k: jax.random.choice(k, len(valid), shape=(m,), replace=False, p=probs))(keys)
    return samples_from_reference(np.asarray(idx), "cpu")


def _relocalize(sys_, frame):
    """Feed one frame; returns (pose, keyframe the BoW relocalization
    landed on or None)."""
    tr = sys_.tracker
    landed = {}
    bow = tr._relocalize_bow

    def hooked(*a):
        ok = bow(*a)
        landed["kf"] = tr.ref_kf if ok else None
        return ok

    tr._relocalize_bow = hooked
    return sys_.track_stereo(*frame, timestamp=99.0), landed.get("kf")


@pytest.mark.parametrize("samples", ["reference", "own"])
def test_relocalize_against_reloaded_map(saved_map, samples):
    """Both relocalize through the keyframe database onto the same keyframe
    and end in state OK. With the reference's EPnP samples the poses agree
    within 1 mm and 1e-3; with the port's own samples within 2 cm and 1e-2
    (a different RANSAC winner polished by the same refine)."""
    from orb_slam2_2021_tpu.pipeline.system import System as JSystem

    cfg, path, frame, n_kf = saved_map
    ref = JSystem.from_map_file(cfg, path)
    port = TSystem.from_map_file(config_from_reference(cfg), path, device="cpu")
    assert int(port.map.kf_valid.sum()) == n_kf and len(port.place.kfdb.bow) == n_kf
    for k in ref.place.kfdb.bow:
        assert np.array_equal(port.place.kfdb.bow[k][0], ref.place.kfdb.bow[k][0])
    assert port.tracker.state.name == ref.tracker.state.name == "LOST"
    if samples == "reference":
        port.tracker.reloc_sampler = _reference_samples
    pr, kr = _relocalize(ref, frame)
    pt, kt = _relocalize(port, frame)
    assert pr is not None and pt is not None
    assert kr is not None and kt == kr, f"relocalized on keyframe {kt}, the reference on {kr}"
    assert port.tracker.state.name == ref.tracker.state.name == "OK"
    tol_t, tol_R = (1e-3, 1e-3) if samples == "reference" else (2e-2, 1e-2)
    dt = np.abs(pt[1] - pr[1]).max()
    dR = np.abs(pt[0] - pr[0]).max()
    assert dt < tol_t and dR < tol_R, f"poses differ by {dt:.2e} m, {dR:.2e} in R"
    assert port.tracker.last_reloc_frame_id == ref.tracker.last_reloc_frame_id
