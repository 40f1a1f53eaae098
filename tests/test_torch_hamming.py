"""Hamming distances of the PyTorch port held against the JAX reference.

The reference has one Pallas kernel, the packed-descriptor Hamming matrix;
the port's `hamming_matrix` is a hand-written CUDA kernel on the card and its
plain PyTorch version on the CPU. All outputs are integers, so every
comparison here is exact (tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from chip_smoke import hamming_inputs  # shared with the card-only checks
from orb_slam2_2021_tpu.ops import hamming as jham
from orb_slam2_2021_tpu.ops.hamming_pallas import hamming_matrix_pallas
from orb_slam2_2021_tpu_torch.convert import desc_from_numpy, desc_to_numpy
from orb_slam2_2021_tpu_torch.ops import hamming as tham

torch.set_num_threads(1)

RAGGED = [(1, 1), (127, 129), (200, 150), (257, 64)]


def _descs(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


@pytest.mark.parametrize("n,m", RAGGED)
def test_hamming_matches_reference_and_pallas(n, m):
    rng = np.random.default_rng(n * 1000 + m)
    a, b = _descs(rng, n), _descs(rng, m)
    # near-duplicates so small distances occur too
    b[: min(n, m) // 2] = a[: min(n, m) // 2] ^ (rng.random((min(n, m) // 2, 8)) < 0.03)
    ref = np.asarray(jham.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    pallas = np.asarray(hamming_matrix_pallas(jnp.asarray(a), jnp.asarray(b), interpret=True))
    out = tham.hamming_matrix(desc_from_numpy(a, "cpu"), desc_from_numpy(b, "cpu"))
    assert out.dtype == torch.int16 and tuple(out.shape) == (n, m)
    assert np.array_equal(out.numpy(), ref), "port vs XLA formula: tolerance 0"
    assert np.array_equal(out.numpy(), pallas), "port vs Pallas kernel (interpret): tolerance 0"


def test_descriptor_bits_round_trip():
    rng = np.random.default_rng(1)
    a = _descs(rng, 64)
    a[0, :] = 0xFFFFFFFF  # bit 31 set: the int32 view is negative
    t = desc_from_numpy(a, "cpu")
    assert t.dtype == torch.int32 and int(t[0, 0]) == -1
    assert np.array_equal(desc_to_numpy(t), a), "uint32 <-> int32 bits: tolerance 0"


def test_masked_best2_and_best_two_exact():
    rng = np.random.default_rng(2)
    dist = rng.integers(0, 40, (96, 70)).astype(np.int16)  # many ties
    mask = rng.random((96, 70)) < 0.3
    best, best_idx, second = jham.masked_best2(jnp.asarray(dist), jnp.asarray(mask))
    tb, tbi, ts = tham.masked_best2(torch.from_numpy(dist), torch.from_numpy(mask))
    assert np.array_equal(tb.numpy(), np.asarray(best)), "best: tolerance 0"
    assert np.array_equal(tbi.numpy(), np.asarray(best_idx)), "best index: tolerance 0"
    assert np.array_equal(ts.numpy(), np.asarray(second)), "second: tolerance 0"

    # best_two == the first two entries of the reference's stable argsort
    d = np.where(mask, dist, jham.MAX_DIST).astype(np.int16)
    order = np.asarray(jnp.argsort(jnp.asarray(d), axis=1))[:, :2]
    i1, v1, i2, v2 = tham.best_two(torch.from_numpy(d))
    assert np.array_equal(i1.numpy(), order[:, 0]) and np.array_equal(i2.numpy(), order[:, 1]), \
        "best-two indices vs stable argsort: tolerance 0"
    assert np.array_equal(v1.numpy(), np.take_along_axis(d, order[:, :1], 1)[:, 0])
    assert np.array_equal(v2.numpy(), np.take_along_axis(d, order[:, 1:2], 1)[:, 0])


def test_rotation_histogram_filter_exact():
    rng = np.random.default_rng(3)
    n = 400
    a = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    # a dominant rotation plus clutter, with bin-count ties
    b = np.where(rng.random(n) < 0.6, a - 0.3, rng.uniform(-np.pi, np.pi, n)).astype(np.float32)
    matched = rng.random(n) < 0.8
    ref = np.asarray(jham.rotation_histogram_filter(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(matched), 30, 3))
    out = tham.rotation_histogram_filter(
        torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(matched), 30, 3)
    assert np.array_equal(out.numpy(), ref), "rotation histogram: tolerance 0"


def test_wrapper_rejects_bad_inputs():
    good = torch.zeros((4, 8), dtype=torch.int32)
    with pytest.raises(TypeError):
        tham.hamming_matrix(good.to(torch.int64), good)
    with pytest.raises(ValueError):
        tham.hamming_matrix(torch.zeros((4, 7), dtype=torch.int32), good)
    with pytest.raises(ValueError):
        tham.hamming_matrix(torch.zeros((8, 4), dtype=torch.int32).t(), good)
    launches = tham.HAMMING_KERNEL.launches
    tham.hamming_matrix(good, good)
    assert tham.HAMMING_KERNEL.launches == launches, "a CPU call launches no kernel"


def _ref_best2(a, b, mask, pallas=False):
    """The reference side of hamming_best2: the JAX Hamming matrix (XLA
    formula, or the Pallas kernel in interpret mode), jnp.where with
    MAX_DIST, then the first-occurrence rule: best = argmin, second = argmin
    with the best entry set above every distance."""
    hm = (lambda x, y: hamming_matrix_pallas(x, y, interpret=True)) if pallas else jham.hamming_matrix
    bs = b[None] if b.ndim == 2 else b
    ms = mask[None] if mask.ndim == 2 else mask
    outs = []
    for bt, mt in zip(bs, ms):
        d = jnp.where(jnp.asarray(mt), hm(jnp.asarray(a), jnp.asarray(bt)), jham.MAX_DIST)
        i1 = jnp.argmin(d, axis=1)
        v1 = jnp.take_along_axis(d, i1[:, None], axis=1)[:, 0]
        d2 = d.at[jnp.arange(d.shape[0]), i1].set(jham.MAX_DIST + 1)
        i2 = jnp.argmin(d2, axis=1)
        v2 = jnp.take_along_axis(d, i2[:, None], axis=1)[:, 0]
        outs.append([np.asarray(x) for x in (i1, v1, i2, v2)])
    out = [np.stack(x) for x in zip(*outs)]
    return [x[0] for x in out] if b.ndim == 2 else out


def _best2_inputs(rng, n, m, t, density):
    """chip_smoke's edge-case inputs (near-copies, duplicated columns for
    ties, an all-masked, an all-open and a one-column row) on the CPU, as
    numpy: uint32 words and a bool mask."""
    a, b, mask = hamming_inputs(rng, n, m, t, density, "cpu")
    return a.numpy().view(np.uint32), b.numpy().view(np.uint32), mask.numpy()


BEST2_CASES = [(70, 90, None), (129, 1, None), (40, 200, None), (33, 57, 3), (20, 1, 4)]


@pytest.mark.parametrize("n,m,t", BEST2_CASES)
def test_best2_plain_matches_reference(n, m, t):
    rng = np.random.default_rng(n * 31 + m + (t or 0))
    a, b, mask = _best2_inputs(rng, n, m, t, 0.3)
    ref = _ref_best2(a, b, mask)
    out = tham.hamming_best2_plain(desc_from_numpy(a, "cpu"), desc_from_numpy(b, "cpu"),
                                   torch.from_numpy(mask))
    lead = (n,) if t is None else (t, n)
    for name, x, y, dt in zip(("best_idx", "best", "second_idx", "second"), out, ref,
                              (torch.int64, torch.int16, torch.int64, torch.int16)):
        assert x.dtype == dt and tuple(x.shape) == lead, name
        assert np.array_equal(x.numpy(), y), f"{name} vs reference: tolerance 0"
    if m == 1:
        assert torch.equal(out[0], out[2]) and torch.equal(out[1], out[3]), "M == 1: second = best"
    assert (out[1].numpy()[..., 0] == jham.MAX_DIST).all(), "an all-masked row's best is MAX_DIST"


@pytest.mark.parametrize("t", [None, 2])
def test_best2_plain_matches_pallas_reference(t):
    rng = np.random.default_rng(40 + (t or 0))
    a, b, mask = _best2_inputs(rng, 130, 140, t, 0.4)
    ref = _ref_best2(a, b, mask, pallas=True)
    out = tham.hamming_best2(desc_from_numpy(a, "cpu"), desc_from_numpy(b, "cpu"), torch.from_numpy(mask))
    for x, y in zip(out, ref):
        assert np.array_equal(x.numpy(), y), "port vs Pallas kernel (interpret) chain: tolerance 0"


def test_best2_wrapper_cpu_and_rejects_bad_inputs():
    rng = np.random.default_rng(8)
    a, b, mask = _best2_inputs(rng, 20, 30, None, 0.5)
    ta, tb, tm = desc_from_numpy(a, "cpu"), desc_from_numpy(b, "cpu"), torch.from_numpy(mask)
    launches = tham.HAMMING_BEST2_KERNEL.launches
    for x, y in zip(tham.hamming_best2(ta, tb, tm), tham.hamming_best2_plain(ta, tb, tm)):
        assert torch.equal(x, y)
    assert tham.HAMMING_BEST2_KERNEL.launches == launches, "a CPU call launches no kernel"
    with pytest.raises(ValueError):
        tham.hamming_best2(ta, tb, tm.to(torch.uint8))
    with pytest.raises(ValueError):
        tham.hamming_best2(ta, tb, tm[:, :29])
    with pytest.raises(ValueError):
        tham.hamming_best2(ta, tb, torch.from_numpy(np.ascontiguousarray(mask.T)).t())
    with pytest.raises(ValueError):
        tham.hamming_best2(ta, tb[:0], tm[:, :0])
    with pytest.raises(ValueError):
        tham.hamming_best2(ta, tb[None, None], tm)
