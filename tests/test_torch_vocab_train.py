"""The port's vocabulary training and writing (`place/vocab.py`:
`train_vocabulary`, `_kmeans_binary`, `BinaryVocabulary.transform_np` /
`.save`, `save_orbvoc_text`) held against the JAX package on the CPU.

Training is host numpy on one RNG stream on both sides, so trees, idf and
written files must be identical, bit for bit and byte for byte, at k=4 L=3
as in tests/test_orbvoc_format.py.
"""

import os

import numpy as np
import pytest
import torch

from orb_slam2_2021_tpu.place import vocab as jvocab
from orb_slam2_2021_tpu_torch import convert
from orb_slam2_2021_tpu_torch.place import vocab as tvocab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _descs(seed, n, dup=False):
    rng = np.random.default_rng(seed)
    d = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    if dup:  # a corpus of a few repeated descriptors: the coincident-seed branch
        d = d[rng.integers(0, 3, n)]
    return d


@pytest.fixture(scope="module")
def trained():
    corpus = _descs(5, 4000)
    return corpus, jvocab.train_vocabulary(corpus, k=4, L=3, seed=0)


@pytest.mark.parametrize("k,L,n,seed,dup", [(4, 3, 4000, 0, False), (3, 3, 20, 1, False),
                                              (4, 2, 300, 2, True)])
def test_train_vocabulary_equals_reference(k, L, n, seed, dup):
    corpus = _descs(10 + seed, n, dup)
    ref = jvocab.train_vocabulary(corpus, k=k, L=L, seed=seed)
    port = tvocab.train_vocabulary(corpus, k=k, L=L, seed=seed)
    assert (port.k, port.L) == (k, L) and port.node_desc.dtype == np.uint32
    assert np.array_equal(port.node_desc, ref.node_desc)
    assert port.word_idf.dtype == np.float32 and np.array_equal(port.word_idf, ref.word_idf)


def test_training_helpers_equal_reference():
    a, b = _descs(1, 300), _descs(2, 17)
    assert np.array_equal(tvocab._popcount_np(a), jvocab._popcount_np(a))
    assert np.array_equal(tvocab._hamming_np(a, b), jvocab._hamming_np(a, b))
    assert np.array_equal(tvocab._hamming_np(a, b, chunk=64), jvocab._hamming_np(a, b, chunk=64))
    assert np.array_equal(tvocab._hamming_np(a, b, chunk=64), tvocab._hamming_np(a, b))
    for n in (1, 2, 5, 300):
        assert np.array_equal(tvocab._majority_centroid(a[:n]), jvocab._majority_centroid(a[:n]))
    for n, k in ((300, 6), (4, 6), (0, 3)):
        got = tvocab._kmeans_binary(a[:n], k, np.random.default_rng(7))
        want = jvocab._kmeans_binary(a[:n], k, np.random.default_rng(7))
        assert got.shape == (k, 8) and np.array_equal(got, want)


def test_save_orbvoc_text_byte_identical(trained, tmp_path):
    _, ref = trained
    port = convert.vocabulary_from_reference(ref)
    assert isinstance(port, tvocab.BinaryVocabulary)
    pj, pt = tmp_path / "ref.txt", tmp_path / "port.txt"
    jvocab.save_orbvoc_text(ref, str(pj))
    tvocab.save_orbvoc_text(port, str(pt))
    assert pt.read_bytes() == pj.read_bytes()
    back = tvocab.load_orbvoc_text(str(pt))
    assert np.array_equal(back.node_desc, ref.node_desc)
    assert np.array_equal(back.word_idf, jvocab.load_orbvoc_text(str(pj)).word_idf)


def test_save_load_round_trip(trained, tmp_path):
    corpus, ref = trained
    port = tvocab.train_vocabulary(corpus, k=4, L=3, seed=0)
    path = str(tmp_path / "voc.npz")
    port.save(path)
    for back in (tvocab.BinaryVocabulary.load(path), jvocab.BinaryVocabulary.load(path)):
        assert (back.k, back.L) == (4, 3)
        assert np.array_equal(back.node_desc, ref.node_desc)
        assert np.array_equal(back.word_idf, ref.word_idf)
    ref_path = str(tmp_path / "ref.npz")
    ref.save(ref_path)
    again = tvocab.BinaryVocabulary.load(ref_path)
    assert np.array_equal(again.node_desc, port.node_desc) and np.array_equal(again.word_idf, port.word_idf)


@pytest.mark.parametrize("source", ["trained", "packaged_k10_L4"])
def test_transform_np_equals_device_descent(trained, source):
    if source == "trained":
        voc = convert.vocabulary_from_reference(trained[1])
    else:
        voc = tvocab.BinaryVocabulary.load(os.path.join(REPO, "orb_slam2_2021_tpu", "data", "vocab_k10_L4.npz"))
    q = _descs(9, 700)
    valid = np.random.default_rng(3).random(len(q)) < 0.9
    words = voc.transform_np(q)
    chunked = voc.transform_np(q, chunk=100)
    ref = jvocab.BinaryVocabulary(voc.k, voc.L, voc.node_desc, voc.word_idf).transform_np(q)
    assert np.array_equal(words, ref) and np.array_equal(chunked, ref)
    dev = tvocab.vocab_transform(convert.vocab_tree_from_numpy(voc.node_desc, "cpu"),
                                 convert.desc_from_numpy(q, "cpu"), torch.from_numpy(valid),
                                 voc.k, voc.L).numpy()
    assert np.array_equal(dev, np.where(valid, words, -1))
