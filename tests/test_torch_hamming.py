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
