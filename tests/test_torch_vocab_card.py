"""The vocabulary builder on the card, held on the CPU: the plain versions of
its three kernels (`ops/vocab_kernels.py`) against the reference's host
numpy, the level-batched trainer (`place/vocab.train_vocabulary`,
device="cpu") against the JAX package's `train_vocabulary`, and the twins
of the reference's training scripts (`scripts/torch_train_vocab*.py`)
against the reference's generators.

Every comparison is exact: the trainer calls the reference's one RNG stream
in the reference's order, and the kernels compute integers, or float64 in
numpy's own order.
"""

import ast
import os
import sys

import numpy as np
import pytest
import torch

from orb_slam2_2021_tpu.place import vocab as jvocab
from orb_slam2_2021_tpu_torch.ops import vocab_kernels as vk
from orb_slam2_2021_tpu_torch.place import vocab as tvocab

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")


def _descs(rng, n):
    return rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)


def _t(a):
    """uint32 words -> the port's int32 descriptor tensor (same bits)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _offsets(sizes):
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)


@pytest.mark.parametrize("k", [1, 3, 10, 16])
def test_assign_plain_equals_reference_argmin(k):
    """Per group the reference's `_hamming_np(sub, centers).argmin(axis=1)`,
    with tied centres (duplicates, and rows equidistant from two centres)."""
    rng = np.random.default_rng(k)
    sizes = [0, 1, 7, 40, 300]
    rows = _descs(rng, sum(sizes))
    centers = _descs(rng, len(sizes) * k).reshape(len(sizes), k, 8)
    if k > 1:
        centers[:, -1] = centers[:, 0]            # a duplicate centre: the first wins
        centers[3, 1] = rows[sizes[0] + sizes[1] + sizes[2]]  # a row at distance 0
        rows[-5:] = centers[4, 0] ^ np.uint32(1)  # distance 1 from centres 0 and k-1
    group = np.repeat(np.arange(len(sizes)), sizes)
    idx, dist = vk.vocab_assign(_t(rows), torch.from_numpy(group), _t(centers))
    assert idx.dtype == torch.int64 and dist.dtype == torch.int32
    off = _offsets(sizes)
    for g in range(len(sizes)):
        sub = rows[off[g]: off[g + 1]]
        d = jvocab._hamming_np(sub, centers[g])
        assert np.array_equal(idx[off[g]: off[g + 1]].numpy(), d.argmin(axis=1))
        assert np.array_equal(dist[off[g]: off[g + 1]].numpy(), d.min(axis=1))


def test_majority_plain_equals_reference_centroid():
    """Each cluster's centroid is the reference's `_majority_centroid` of its
    rows, at sizes 1 and 2 and with even-count ties (2 * count == size packs
    a 1); sizes are the cluster sizes; an empty cluster packs all ones."""
    rng = np.random.default_rng(4)
    k = 5
    sizes = [1, 2, 4, 9, 300, 0]
    rows = _descs(rng, sum(sizes))
    off = _offsets(sizes)
    rows[off[2]: off[2] + 2] = rows[off[2] + 2: off[2] + 4] ^ np.uint32(0xFFFFFFFF)  # every bit tied 2-2
    assign = np.concatenate([np.zeros(1), [0, 0], [1, 1, 1, 1], rng.integers(0, k, 9),
                             rng.integers(0, k, 300)]).astype(np.int64)
    centers, got_sizes = vk.vocab_majority(_t(rows), torch.from_numpy(assign), torch.from_numpy(off), k)
    centers = centers.numpy().view(np.uint32)
    for g in range(len(sizes)):
        a, sub = assign[off[g]: off[g + 1]], rows[off[g]: off[g + 1]]
        for c in range(k):
            sel = sub[a == c]
            assert got_sizes[g, c] == len(sel)
            want = jvocab._majority_centroid(sel) if len(sel) else np.full(8, 0xFFFFFFFF, np.uint32)
            assert np.array_equal(centers[g, c], want), (g, c, len(sel))
    assert np.array_equal(centers[2, 1], np.full(8, 0xFFFFFFFF, np.uint32)), "ties go to 1"


def test_seed_draw_plain_equals_numpy_choice():
    """Per node, the pick of `rng.choice(n, p=d2 / d2.sum())` from the same
    stream position, bit for bit, over many seeds; where d2 sums to 0 the
    zero flag (the reference then draws `rng.integers(n)` instead)."""
    for seed in range(60):
        rng = np.random.default_rng(seed)
        sizes = rng.integers(1, 400, 6)
        sizes[2] = 1
        d2 = rng.integers(0, 257, int(sizes.sum())).astype(np.int32)
        off = _offsets(sizes)
        d2[off[3]: off[4]] = 0  # a node whose rows all coincide with centres
        d2[off[4]: off[4] + sizes[4] // 2] = 0
        state = rng.bit_generator.state
        want = []
        for g in range(len(sizes)):
            seg = d2[off[g]: off[g + 1]].astype(np.float64)
            s = seg.sum()
            want.append(rng.choice(len(seg), p=seg / s) if s > 0 else -1)
        rng.bit_generator.state = state
        u = []
        for g in range(len(sizes)):
            u.append(rng.random() if d2[off[g]: off[g + 1]].sum() > 0 else 0.0)
        pick, zero = vk.vocab_seed_draw(torch.from_numpy(d2), torch.from_numpy(off),
                                        torch.tensor(u, dtype=torch.float64))
        assert np.array_equal(zero.numpy(), np.asarray(want) < 0)
        assert np.array_equal(np.where(zero.numpy(), -1, pick.numpy()), want), seed


def test_majority_plan_covers_each_node(monkeypatch):
    """The CUDA wrapper's chunk plan, replayed in numpy as the kernel walks
    it, gives the plain version's counts: every row counted once, in its own
    node's chunk, a slot for each node of several chunks."""
    monkeypatch.setattr(vk, "MAJORITY_CHUNK", 16)
    rng = np.random.default_rng(8)
    sizes = np.array([0, 3, 16, 17, 40, 1, 33])
    k = 4
    rows = _descs(rng, int(sizes.sum()))
    assign = rng.integers(0, k, int(sizes.sum()))
    off = torch.from_numpy(_offsets(sizes))
    plan = vk.majority_plan(off)
    bits = np.unpackbits(rows.view(np.uint8), axis=1, bitorder="little").astype(np.int64)
    counts = np.zeros((len(sizes), k, 256), np.int64)
    seen = np.zeros(int(sizes.sum()), np.int64)
    for r0, nr, node in zip(plan.chunk_row0.tolist(), plan.chunk_rows.tolist(), plan.chunk_node.tolist()):
        assert off[node] <= r0 and r0 + nr <= off[node + 1]
        for r in range(r0, r0 + nr):
            counts[node, assign[r]] += bits[r]
            seen[r] += 1
    assert (seen == 1).all()
    multi = [g for g in range(len(sizes)) if sizes[g] > 16]
    assert plan.slot_node.tolist() == multi
    assert [plan.node_slot[g].item() for g in multi] == list(range(len(multi)))
    assert (plan.node_slot[[g for g in range(len(sizes)) if g not in multi]] == -1).all()
    sizes_k = np.zeros((len(sizes), k), np.int64)
    np.add.at(sizes_k, (np.repeat(np.arange(len(sizes)), sizes), assign), 1)
    maj = 2 * counts >= sizes_k[..., None]
    packed = np.packbits(maj.astype(np.uint8), axis=-1, bitorder="little").view(np.int32)
    centers, got = vk.vocab_majority(_t(rows), torch.from_numpy(assign), off, k)
    assert np.array_equal(centers.numpy(), packed) and np.array_equal(got.numpy(), sizes_k)


@pytest.mark.parametrize("k,L,n,seed", [(10, 3, 5000, 0), (10, 6, 3000, 1), (10, 2, 11, 2), (5, 3, 0, 3)])
def test_trainer_cpu_equals_reference(k, L, n, seed):
    corpus = _descs(np.random.default_rng(100 + seed), n)
    ref = jvocab.train_vocabulary(corpus, k=k, L=L, seed=seed)
    stats = {}
    port = tvocab.train_vocabulary(corpus, k=k, L=L, seed=seed, device="cpu", stats=stats)
    assert port.node_desc.dtype == np.uint32 and np.array_equal(port.node_desc, ref.node_desc)
    assert port.word_idf.dtype == np.float32 and np.array_equal(port.word_idf, ref.word_idf)
    assert len(stats["levels"]) == L and stats["level"] is None


def _degenerate_corpus():
    """Random rows beside groups of identical rows: a node whose rows are
    one repeated descriptor plus fewer than k others sums d2 to 0 before its
    k-th seed, and its duplicated seeds leave clusters empty."""
    rng = np.random.default_rng(21)
    distinct = _descs(rng, 6)
    rows = np.concatenate([distinct[rng.integers(0, 6, 1800)], _descs(rng, 60)])
    return rows[rng.permutation(len(rows))]


def test_trainer_resumes_on_zero_sum_and_empty_clusters():
    """Both data-dependent draws fire, the trainer resumes its passes at the
    deviating nodes, and the tree is still the reference's, bit for bit."""
    corpus = _degenerate_corpus()
    ref = jvocab.train_vocabulary(corpus, k=10, L=3, seed=5)
    stats = {}
    port = tvocab.train_vocabulary(corpus, k=10, L=3, seed=5, device="cpu", stats=stats)
    assert np.array_equal(port.node_desc, ref.node_desc)
    assert np.array_equal(port.word_idf, ref.word_idf)
    levels = stats["levels"]
    assert sum(r["zero_sum_picks"] for r in levels) > 0
    assert sum(r["empty_picks"] for r in levels) > 0
    assert sum(r["resumes"] for r in levels) > 0, "the resume path ran"


def test_trainer_windows_after_a_resume_equal_reference(monkeypatch):
    """With windows of a single node after a resume, the passes march
    through the rest of the level a window at a time, and the tree is still
    the reference's, bit for bit."""
    monkeypatch.setattr(tvocab, "MIN_WINDOW", 1)
    corpus = _degenerate_corpus()
    ref = jvocab.train_vocabulary(corpus, k=10, L=3, seed=5)
    stats = {}
    port = tvocab.train_vocabulary(corpus, k=10, L=3, seed=5, device="cpu", stats=stats)
    assert np.array_equal(port.node_desc, ref.node_desc)
    assert np.array_equal(port.word_idf, ref.word_idf)
    levels = stats["levels"]
    assert sum(r["resumes"] for r in levels) > 0
    assert any(r["passes"] > r["resumes"] + 1 for r in levels), "a window ended before its level"


def test_trainer_refuses_a_missing_card_and_bad_k():
    corpus = _descs(np.random.default_rng(0), 50)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tvocab.train_vocabulary(corpus, k=10, L=2)  # the card by default
    with pytest.raises(ValueError):
        tvocab.train_vocabulary(corpus, k=17, L=2, device="cpu")


def _reference_l6_functions():
    """blob_texture, ridged_texture, _bilinear_resize and _make_texture out of
    scripts/train_vocab_l6.py's source: importing it reads sys.argv and
    moves JAX to another platform."""
    path = os.path.join(SCRIPTS, "train_vocab_l6.py")
    tree = ast.parse(open(path).read(), filename=path)
    names = {"blob_texture", "ridged_texture", "_bilinear_resize", "_make_texture"}
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name in names]
    assert {n.name for n in body} == names
    ns = {"np": np}
    exec(compile(ast.Module(body=body, type_ignores=[]), path, "exec"), ns)
    return ns


@pytest.fixture(scope="module")
def twins():
    sys.path.insert(0, SCRIPTS)
    try:
        import torch_train_vocab_l5 as l5
        import torch_train_vocab_l6 as l6
        import train_vocab_l5 as ref_l5
    finally:
        sys.path.remove(SCRIPTS)
    return l5, l6, ref_l5, _reference_l6_functions()


@pytest.mark.parametrize("name", ["voronoi_texture", "turbulence_texture", "collage_texture",
                                  "blob_texture", "ridged_texture", "augment"])
def test_twin_generators_equal_reference(twins, name):
    l5, l6, ref_l5, ref_l6 = twins
    ours = getattr(l5, name, None) or getattr(l6, name)
    ref = getattr(ref_l5, name, None) or ref_l6[name]
    for seed in range(3):
        if name == "augment":
            img = np.random.default_rng(50 + seed).uniform(0, 255, (24, 30)).astype(np.float32)
            for draw in range(12):
                r1, r2 = np.random.default_rng((seed, draw)), np.random.default_rng((seed, draw))
                a, b = ours(img, r1), ref(img, r2)
                assert a.dtype == b.dtype and np.array_equal(a, b)
                assert r1.bit_generator.state == r2.bit_generator.state
            continue
        r1, r2 = np.random.default_rng(seed), np.random.default_rng(seed)
        a, b = ours(r1, 37, 53), ref(r2, 37, 53)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        assert r1.bit_generator.state == r2.bit_generator.state


def test_twin_texture_upscale_equals_reference(twins):
    _, l6, ref_l5, ref_l6 = twins
    for fam, ref_fam in ((l6.blob_texture, ref_l6["blob_texture"]), (l6.TEXTURES[1], ref_l5.voronoi_texture)):
        r1, r2 = np.random.default_rng(9), np.random.default_rng(9)
        a = l6._make_texture(fam, r1, 700, 1000)
        b = ref_l6["_make_texture"](ref_fam, r2, 700, 1000)
        assert a.shape == (700, 1000) and np.array_equal(a, b)


def test_twins_refuse_the_reference_package(tmp_path):
    sys.path.insert(0, SCRIPTS)
    try:
        import torch_train_vocab as l4
    finally:
        sys.path.remove(SCRIPTS)
    with pytest.raises(ValueError):
        l4.output_path(os.path.join(REPO, "orb_slam2_2021_tpu", "data", "vocab_k10_L6.npz"))
    assert l4.output_path(str(tmp_path / "a" / "v.npz")) == str(tmp_path / "a" / "v.npz")
    assert os.path.isdir(tmp_path / "a")
