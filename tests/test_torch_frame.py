"""Stereo frame build of the PyTorch port held against the JAX reference on a
rendered SyntheticStereoWorld pair at 320x240.

The whole chain cannot be bit-identical: the pyramid resize sums float32
products in another order (a rare canvas pixel moves one bf16 step) and an
IC angle can differ by an ulp, which can move a BRIEF rotation bin. So the
chain is held to rates, and stereo matching alone is held on identical
inputs.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from orb_slam2_2021_tpu.config import synthetic_config
from orb_slam2_2021_tpu.frontend import features as jfeat
from orb_slam2_2021_tpu.frontend import frame as jframe
from orb_slam2_2021_tpu.io.synthetic import SyntheticStereoWorld, forward_trajectory
from orb_slam2_2021_tpu_torch.convert import desc_to_numpy, keypoints_from_reference
from orb_slam2_2021_tpu_torch.frontend import features as tfeat
from orb_slam2_2021_tpu_torch.frontend import frame as tframe

torch.set_num_threads(1)

CFG = synthetic_config(width=320, height=240)


@pytest.fixture(scope="module")
def pair():
    world = SyntheticStereoWorld(CFG, seed=3)
    R, t = forward_trajectory(3, step=0.12)[2]
    left, right = world.render(R, t)
    return np.clip(np.stack([left, right]), 0, 255).astype(np.uint8)


def _kp_np(kp, eye):
    return {f: np.asarray(getattr(kp, f))[eye] for f in kp._fields}


def test_extraction_rates(pair):
    images = pair.astype(np.float32)
    jkp, jstack = jax.jit(jfeat.extract_orb_batched, static_argnums=1)(jnp.asarray(images), CFG.orb)
    tkp, tstack = tfeat.extract_orb_batched(torch.from_numpy(images), CFG.orb)
    canvas_same = (np.asarray(jstack.astype(jnp.float32)) == tstack.float().numpy()).mean()
    assert canvas_same > 0.9999, f"canvas: >= 99.99% identical pixels, got {canvas_same:.6f}"
    for eye in range(2):
        r = _kp_np(jkp, eye)
        t = {f: getattr(tkp, f)[eye].numpy() for f in tkp._fields}
        t["desc"] = desc_to_numpy(tkp.desc[eye])
        same_kp = (
            (r["xy"] == t["xy"]).all(1) & (r["octave"] == t["octave"]) & (r["valid"] == t["valid"])
        ).mean()
        assert same_kp > 0.99, f"eye {eye}: >= 99% identical keypoint slots, got {same_kp:.4f}"
        assert r["valid"].sum() > 0.9 * CFG.orb.n_features
        same_desc = (r["desc"] == t["desc"]).all(1).mean()
        assert same_desc > 0.97, f"eye {eye}: >= 97% identical descriptors, got {same_desc:.4f}"
        ang = np.abs(r["angle"] - t["angle"])
        assert np.median(ang) < 1e-6, "angles: median difference < 1e-6 rad"


def test_stereo_match_on_identical_inputs(pair):
    """The reference's keypoints and canvas into both stereo matchers."""
    images = pair.astype(np.float32)
    jkp, jstack = jax.jit(jfeat.extract_orb_batched, static_argnums=1)(jnp.asarray(images), CFG.orb)
    kpl = jax.tree.map(lambda x: x[0], jkp)
    kpr = jax.tree.map(lambda x: x[1], jkp)
    shapes = [(s[0], s[1]) for s in tfeat.pyramid_shapes(240, 320, CFG.orb.n_levels, CFG.orb.scale_factor)]
    lh = np.asarray([s[0] for s in shapes], np.int32)
    lw = np.asarray([s[1] for s in shapes], np.int32)
    ref = jax.jit(jframe.stereo_match, static_argnums=6)(
        kpl, kpr, jstack[0], jstack[1], jnp.asarray(lh), jnp.asarray(lw), CFG)
    stack = torch.from_numpy(np.array(jstack.astype(jnp.float32))).to(torch.bfloat16)
    out = tframe.stereo_match(
        keypoints_from_reference(kpl, "cpu"), keypoints_from_reference(kpr, "cpu"),
        stack[0], stack[1], torch.from_numpy(lh), torch.from_numpy(lw), CFG)
    ur_r, d_r, _ = (np.asarray(x) for x in ref)
    ur_t, d_t, _ = (x.numpy() for x in out)
    matched_r, matched_t = ur_r >= 0, ur_t >= 0
    assert matched_r.sum() > 200
    agree = (matched_r == matched_t).mean()
    assert agree > 0.995, f"stereo matched flags: >= 99.5% agree, got {agree:.4f}"
    both = matched_r & matched_t
    assert np.abs(ur_t[both] - ur_r[both]).max() < 1e-3, "u_right: tolerance 1e-3 px"
    rel = np.abs(d_t[both] - d_r[both]) / d_r[both]
    assert rel.max() < 1e-4, "depth: tolerance 1e-4 relative"


def test_frame_build_rates(pair):
    ref = jframe.make_stereo_frame_u8_fn(CFG)(jnp.asarray(pair))
    out = tframe.build_stereo_frame_from_u8(torch.from_numpy(pair), CFG)
    assert out.kp.desc.dtype == torch.int32 and out.u_right.dtype == torch.float32
    same = (np.asarray(ref.kp.xy) == out.kp.xy.numpy()).all(1).mean()
    assert same > 0.99, f"left keypoints: >= 99% identical, got {same:.4f}"
    same_desc = (np.asarray(ref.kp.desc) == desc_to_numpy(out.kp.desc)).all(1).mean()
    assert same_desc > 0.97, f"left descriptors: >= 97% identical, got {same_desc:.4f}"
    ur_r, ur_t = np.asarray(ref.u_right), out.u_right.numpy()
    agree = ((ur_r >= 0) == (ur_t >= 0)).mean()
    assert agree > 0.97, f"stereo matched flags: >= 97% agree, got {agree:.4f}"
    both = (ur_r >= 0) & (ur_t >= 0)
    close = np.abs(ur_t[both] - ur_r[both]) < 1e-3
    assert close.mean() > 0.97, f"u_right within 1e-3 px on >= 97% of common matches, got {close.mean():.4f}"
    d_r, d_t = np.asarray(ref.depth), out.depth.numpy()
    rel = np.abs(d_t[both] - d_r[both]) / d_r[both]
    assert np.median(rel) < 1e-5, "depth: median relative difference < 1e-5"
