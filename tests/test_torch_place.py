"""Place recognition of the PyTorch port, held against the JAX reference on
the CPU: the vocabulary descent (words identical) on the packaged L4 and L6
trees, the keyframe database's loop and relocalization candidates and
scores (identical) on the same word streams, the text vocabulary loader and
the default vocabulary choice."""

import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from orb_slam2_2021_tpu.config import synthetic_config
from orb_slam2_2021_tpu.io.synthetic import SyntheticStereoWorld, forward_trajectory
from orb_slam2_2021_tpu.place import bundle as jbundle
from orb_slam2_2021_tpu.place.kf_database import KeyFrameDatabase as JDB
from orb_slam2_2021_tpu.place.vocab import (
    BinaryVocabulary as JVoc, load_orbvoc_text as j_load_txt, save_orbvoc_text,
    vocab_transform as j_transform,
)
from orb_slam2_2021_tpu_torch.convert import desc_from_numpy, vocab_tree_from_numpy
from orb_slam2_2021_tpu_torch.frontend.frame import build_stereo_frame_from_u8
from orb_slam2_2021_tpu_torch.place import bundle as tbundle
from orb_slam2_2021_tpu_torch.place.kf_database import KeyFrameDatabase as TDB
from orb_slam2_2021_tpu_torch.place.vocab import (
    BinaryVocabulary as TVoc, load_orbvoc_text, vocab_transform,
)

torch.set_num_threads(1)


def _rendered_descriptors(n_frames=2):
    """ORB descriptors (uint32 words) and valid masks of rendered frames."""
    cfg = synthetic_config(width=320, height=240)
    world = SyntheticStereoWorld(cfg, seed=3)
    out = []
    for R, t in forward_trajectory(n_frames, step=0.5):
        pair = np.clip(np.stack(world.render(R, t)), 0, 255).astype(np.uint8)
        f = build_stereo_frame_from_u8(torch.from_numpy(pair), cfg)
        out.append((f.kp.desc.numpy().view(np.uint32), f.kp.valid.numpy()))
    return out


@pytest.mark.parametrize("path", [jbundle.PACKAGED_VOCAB_SMALL, jbundle.PACKAGED_VOCAB_L6],
                         ids=["L4", "L6"])
def test_vocab_transform_words_identical(path):
    voc = JVoc.load(path)
    tree_j = jnp.asarray(voc.node_desc)
    tree_t = vocab_tree_from_numpy(voc.node_desc, "cpu")
    rng = np.random.default_rng(0)
    seeded = rng.integers(0, 2 ** 32, (1500, 8), dtype=np.uint32)
    inputs = [(seeded, rng.random(1500) < 0.9)] + _rendered_descriptors()
    for desc, valid in inputs:
        ref = np.asarray(j_transform(tree_j, jnp.asarray(desc), jnp.asarray(valid), voc.k, voc.L))
        got = vocab_transform(tree_t, desc_from_numpy(desc, "cpu"), torch.from_numpy(valid),
                              voc.k, voc.L).numpy()
        assert got.dtype == np.int32 and np.array_equal(got, ref), "words: tolerance 0"
        assert (got[~valid] == -1).all() and (got[valid] >= 0).all()


def _word_streams(rng, n_kf=14, n_feat=600, pool=4000):
    """Per-keyframe word arrays where keyframe i shares many words with its
    neighbours and with keyframe i - 7 (a revisit), -1 for invalid slots."""
    base = [rng.integers(0, pool, n_feat) for _ in range(7)]
    streams = []
    for i in range(n_kf):
        w = base[i % 7].copy()
        swap = rng.random(n_feat) < 0.35 + 0.03 * (i // 7)
        w[swap] = rng.integers(0, pool, swap.sum())
        w[rng.random(n_feat) < 0.05] = -1
        streams.append(w.astype(np.int32))
    return streams


def test_keyframe_database_matches_reference():
    """Same word streams into both databases: BoW vectors, scores, loop and
    relocalization candidate lists identical, also after erasing keyframes."""
    voc = JVoc.load(jbundle.PACKAGED_VOCAB_SMALL)
    tvoc = TVoc(voc.k, voc.L, voc.node_desc, voc.word_idf)
    rng = np.random.default_rng(1)
    streams = _word_streams(rng)
    jdb, tdb = JDB(voc), TDB(tvoc)

    def covis(x):
        return [y for y in (x - 1, x + 1, x - 2) if 0 <= y < len(streams)]

    for k, w in enumerate(streams):
        for db in (jdb, tdb):
            db.add_bow(k, w)
        for a, b in zip(jdb.bow[k], tdb.bow[k]):
            assert np.array_equal(a, b)
        if k >= 2:
            connected = {k - 1, k - 2}
            scores_j = [jdb.score(k, nb) for nb in sorted(connected)]
            scores_t = [tdb.score(k, nb) for nb in sorted(connected)]
            assert scores_j == scores_t, "scores: tolerance 0"
            min_score = min(scores_j)
            cj = jdb.detect_loop_candidates(k, min_score, connected, covis)
            ct = tdb.detect_loop_candidates(k, min_score, connected, covis)
            assert cj == ct, f"keyframe {k}: loop candidates {ct} vs {cj}"
        for db in (jdb, tdb):
            db.add_to_index(k)
    assert any(jdb.detect_loop_candidates(k, 0.0, {k - 1, k - 2}, covis) for k in range(7, 14))
    query = streams[9].copy()
    query[:100] = rng.integers(0, 4000, 100)
    assert jdb.detect_reloc_candidates(query, covis) == tdb.detect_reloc_candidates(query, covis) != []
    for k in (2, 9, 9, 40):
        jdb.erase(k)
        tdb.erase(k)
    assert dict(jdb.inverted) == dict(tdb.inverted)
    assert jdb.detect_reloc_candidates(query, covis) == tdb.detect_reloc_candidates(query, covis)
    jdb.clear()
    tdb.clear()
    assert not tdb.bow and not tdb.inverted


def test_load_default_picks_the_reference_file():
    ref = jbundle.PlaceRecognition.load_default()
    got = tbundle.PlaceRecognition.load_default()
    assert (got.voc.k, got.voc.L) == (ref.voc.k, ref.voc.L) == (10, 6)
    assert np.array_equal(got.voc.node_desc, ref.voc.node_desc)
    assert np.array_equal(got.voc.word_idf, ref.voc.word_idf)
    assert os.path.samefile(tbundle.PACKAGED_VOCAB_L6, jbundle.PACKAGED_VOCAB_L6)
    assert os.path.samefile(tbundle.PACKAGED_VOCAB_SMALL, jbundle.PACKAGED_VOCAB_SMALL)


def test_text_vocabulary_loads_like_reference(tmp_path):
    """A DBoW2 text vocabulary written by the reference from the L4 tree
    loads into the same layout as with the reference's loader."""
    voc = JVoc.load(jbundle.PACKAGED_VOCAB_SMALL)
    path = str(tmp_path / "voc.txt")
    save_orbvoc_text(voc, path)
    ref = j_load_txt(path)
    got = load_orbvoc_text(path)
    assert (got.k, got.L) == (ref.k, ref.L)
    assert np.array_equal(got.node_desc, ref.node_desc)
    assert np.array_equal(got.word_idf, ref.word_idf)
    assert np.array_equal(got.node_desc, voc.node_desc)
    pr = tbundle.PlaceRecognition.from_file(path)
    assert pr.voc.n_words == 10 ** 4 and pr.voc.n_nodes() == ref.n_nodes()
