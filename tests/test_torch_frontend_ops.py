"""Front-end ops of the PyTorch port held against the JAX reference on
identical inputs: blur, FAST, selection, BRIEF pattern and bits, IC angles,
the pyramid resize weights.

Inputs are made with numpy from a seed (or by the reference itself, then
handed over as numpy) at 320x240 sizes. bf16 tensors cross over through
float32, which holds every bf16 value exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orb_slam2_2021_tpu.config import synthetic_config
from orb_slam2_2021_tpu.frontend import features as jfeat
from orb_slam2_2021_tpu.io.synthetic import SyntheticStereoWorld
from orb_slam2_2021_tpu.ops import brief as jbrief
from orb_slam2_2021_tpu.ops import fast as jfast
from orb_slam2_2021_tpu.ops import image as jimage
from orb_slam2_2021_tpu.ops import orientation as jorient
from orb_slam2_2021_tpu.ops import select as jselect
from orb_slam2_2021_tpu_torch.convert import desc_to_numpy
from orb_slam2_2021_tpu_torch.frontend import features as tfeat
from orb_slam2_2021_tpu_torch.ops import brief as tbrief
from orb_slam2_2021_tpu_torch.ops import fast as tfast
from orb_slam2_2021_tpu_torch.ops import image as timage
from orb_slam2_2021_tpu_torch.ops import orientation as torient
from orb_slam2_2021_tpu_torch.ops import select as tselect

torch.set_num_threads(1)

CFG = synthetic_config(width=320, height=240)


def _to_torch_bf16(x):
    return torch.from_numpy(np.array(jnp.asarray(x).astype(jnp.float32))).to(torch.bfloat16)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else jnp.asarray(x).astype(jnp.float32))


@pytest.fixture(scope="module")
def canvas():
    """The reference's bf16 pyramid canvas of one rendered stereo pair."""
    world = SyntheticStereoWorld(CFG, seed=3)
    left, right = world.render(np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    images = np.clip(np.stack([left, right]), 0, 255).astype(np.uint8).astype(np.float32)
    stack, ext_h, ext_w = jfeat.build_pyramid_stack(jnp.asarray(images), CFG.orb)
    return images, stack, ext_h, ext_w


def test_gaussian_blur_bf16_bit_identical(canvas):
    _, stack, _, _ = canvas
    ref = _np(jimage.gaussian_blur_batched(stack))
    out = _np(timage.gaussian_blur_batched(_to_torch_bf16(stack)))
    assert np.array_equal(out, ref), "blur on the bf16 canvas: tolerance 0 (bit-identical)"


def test_fast_maps_identical(canvas):
    _, stack, ext_h, ext_w = canvas
    B, L, Hc, Wc = stack.shape
    eh, ew = np.tile(ext_h, B), np.tile(ext_w, B)
    args = (float(CFG.orb.ini_fast_th), float(CFG.orb.min_fast_th), CFG.orb.edge_threshold)
    rs, rr = jfast.fast_detect_batched(stack.reshape(B * L, Hc, Wc), *args,
                                       jnp.asarray(eh), jnp.asarray(ew))
    ts, tr = tfast.fast_detect_batched(_to_torch_bf16(stack).reshape(B * L, Hc, Wc), *args,
                                       torch.from_numpy(eh), torch.from_numpy(ew))
    assert np.array_equal(_np(ts), _np(rs)), "FAST strict map: tolerance 0"
    assert np.array_equal(_np(tr), _np(rr)), "FAST relaxed map: tolerance 0"
    assert (_np(rs) > 0).sum() > 500, "the canvas must produce corners"


def test_selection_identical(canvas):
    _, stack, ext_h, ext_w = canvas
    B, L, Hc, Wc = stack.shape
    strict, relaxed = jfast.fast_detect_batched(
        stack.reshape(B * L, Hc, Wc), float(CFG.orb.ini_fast_th), float(CFG.orb.min_fast_th),
        CFG.orb.edge_threshold, jnp.asarray(np.tile(ext_h, B)), jnp.asarray(np.tile(ext_w, B)))
    n_top = max(jfeat.level_feature_counts(CFG.orb.n_features, L, CFG.orb.scale_factor))
    ref = jselect.select_keypoints_batched(strict, relaxed, n_top, CFG.orb.cell_size)
    out = tselect.select_keypoints_batched(
        _to_torch_bf16(strict), _to_torch_bf16(relaxed), n_top, CFG.orb.cell_size)
    for name, r, o in zip(("ys", "xs", "score", "valid"), ref, out):
        assert np.array_equal(o.numpy(), np.asarray(r)), f"selection {name}: tolerance 0"


def test_brief_pattern_and_bin_offsets_equal_reference():
    assert np.array_equal(tbrief.brief_pattern(), jbrief.brief_pattern()), "pattern: tolerance 0"
    off = tbrief.brief_bin_offsets()
    D = np.zeros((tbrief.N_BINS, 961, 256), np.int8)
    for b in range(tbrief.N_BINS):
        for i in range(256):
            D[b, off[b, i, 1], i] += 1
            D[b, off[b, i, 0], i] -= 1
    assert np.array_equal(D, jbrief.brief_bin_matrices()), "two-hot matrices: tolerance 0"
    assert np.array_equal(timage.gaussian_taps(), jimage._gaussian_kernel(7, 2.0)), \
        "Gaussian taps: tolerance 0"
    assert np.array_equal(torient.moment_matrix(), jorient._moment_matrix()), \
        "moment weights: tolerance 0"


def _patches(seed, n=300):
    """bf16-exact 31x31 patches with smooth structure (plus equal samples)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[-15:16, -15:16].astype(np.float32)
    g = rng.normal(size=(n, 2)).astype(np.float32)
    base = 128 + 40 * (g[:, :1] * xx.reshape(1, -1) + g[:, 1:] * yy.reshape(1, -1)) / 15
    p = np.clip(base + rng.normal(0, 12, (n, 961)), 0, 255).astype(np.float32)
    p[:5] = 77.0  # flat patches: every pair ties
    return np.asarray(jnp.asarray(p).astype(jnp.bfloat16).astype(jnp.float32))


def test_brief_bits_identical_given_reference_angles():
    p = _patches(4)
    pj = jnp.asarray(p).astype(jnp.bfloat16)
    angles = jorient.angles_from_patches(pj)
    ref = np.asarray(jbrief.brief_from_patches(pj, angles))
    out = tbrief.brief_from_patches(torch.from_numpy(p).bfloat16(), torch.from_numpy(np.asarray(angles)))
    assert out.dtype == torch.int32
    assert np.array_equal(desc_to_numpy(out), ref), "BRIEF words: tolerance 0"


def test_angles_within_ulps():
    p = _patches(5)
    ref = np.asarray(jorient.angles_from_patches(jnp.asarray(p).astype(jnp.bfloat16)))
    out = torient.angles_from_patches(torch.from_numpy(p).bfloat16()).numpy()
    ulp = np.spacing(np.abs(ref).astype(np.float32))
    err = np.abs(out - ref) / ulp
    # moments sum exact products in another order, and atan2 differs by up
    # to one rounding between the two libraries
    assert err.max() <= 4, f"IC angle: tolerance 4 ulp, got {err.max()}"


@pytest.mark.parametrize("sizes", [(240, 200), (320, 267), (1241, 1034), (376, 313)])
def test_resize_weights_match_reference(sizes):
    from jax._src.image.scale import _fill_triangle_kernel, compute_weight_mat

    a, b = sizes
    ref = np.asarray(compute_weight_mat(a, b, b / a, 0.0, _fill_triangle_kernel, True))
    out = timage.resize_weights(a, b)
    diff = np.abs(out - ref)
    # column sums run in another order in XLA at the larger sizes: a few
    # weights differ by one float32 ulp
    assert diff.max() <= 1.2e-7, "resize weights: tolerance 1.2e-7 (one float32 ulp at 1.0)"
    assert (diff > 0).mean() < 1e-3, "resize weights: at most 0.1% off by that ulp"


def test_pyramid_canvas_rate(canvas):
    images, stack, ext_h, ext_w = canvas
    out, oh, ow = tfeat.build_pyramid_stack(torch.from_numpy(images), CFG.orb)
    assert np.array_equal(oh, ext_h) and np.array_equal(ow, ext_w)
    ref = _np(stack)
    o = _np(out)
    assert np.array_equal(o[:, 0], ref[:, 0]), "level 0 (a cast of uint8 values): tolerance 0"
    differ = (o != ref).mean()
    # float32 contractions sum in another order than XLA's; after the bf16
    # cast a rare pixel lands one bf16 step away
    assert differ < 1e-4, f"canvas: at most 0.01% of pixels differ, got {differ:.2e}"
    assert np.abs(o - ref).max() <= 1.0, "canvas: a differing pixel is off by one bf16 step (<= 1)"
