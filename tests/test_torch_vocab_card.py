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

from chip_smoke import SEED_DRAW_CASES, counted_rows, majority_case, seed_draw_case
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


def test_majority_plan_covers_each_node():
    """The CUDA wrapper's chunk plan, replayed in numpy as the kernels walk
    it, gives the plain version's counts: a node of at most MAJORITY_SMALL
    rows is counted whole by one warp and has no chunk; every row of a larger
    node is counted once, in its own node's chunks, with a slot for each node
    of several chunks."""
    small_max, chunk = vk.MAJORITY_SMALL, vk.MAJORITY_CHUNK
    rng = np.random.default_rng(8)
    sizes = np.array([0, 3, small_max, small_max + 1, chunk, chunk + 1, 2 * chunk + 40, 1, small_max + 88])
    k = 4
    rows = _descs(rng, int(sizes.sum()))
    assign = rng.integers(0, k, int(sizes.sum()))
    off = torch.from_numpy(_offsets(sizes))
    plan = vk.majority_plan(off)
    bits = np.unpackbits(rows.view(np.uint8), axis=1, bitorder="little").astype(np.int64)
    counts = np.zeros((len(sizes), k, 256), np.int64)
    seen = np.zeros(int(sizes.sum()), np.int64)
    small = [g for g in range(len(sizes)) if sizes[g] <= small_max]
    for g in small:  # the small-node kernel: a warp takes the whole node
        np.add.at(counts[g], assign[off[g]: off[g + 1]], bits[off[g]: off[g + 1]])
        seen[off[g]: off[g + 1]] += 1
    assert not set(plan.chunk_node.tolist()) & set(small)
    for r0, nr, node in zip(plan.chunk_row0.tolist(), plan.chunk_rows.tolist(), plan.chunk_node.tolist()):
        assert off[node] <= r0 and r0 + nr <= off[node + 1] and nr <= chunk
        np.add.at(counts[node], assign[r0: r0 + nr], bits[r0: r0 + nr])
        seen[r0: r0 + nr] += 1
    assert (seen == 1).all()
    multi = [g for g in range(len(sizes)) if sizes[g] > chunk]
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


# ------------------------------------------------- host models of the kernels
#
# numpy models of what csrc/vocab.cu's redesigned kernels compute, step by
# step, held bit for bit against numpy's own functions and the plain versions.

_SEED_NONE, _SEED_BAD = -30000, 30000
_SEED_ZERO, _SEED_UNCERTAIN, _SEED_NOT_BINADE = -30001, -30002, -20000
_FN_ID = (0, 0, 0, 1, _SEED_NONE)  # inc0, inc1, parity out from even, from odd, binade


def _exponent(x):
    return (np.asarray(x, np.float64).view(np.int64) >> 52) - 1023


def _seed_classes(D, s, n):
    """vocab.cu seed_class: the binade of c where the prefix is D, where
    D / s lies clear of a power of two by the margin (n + 64) 2^-51."""
    inv_s = np.float64(1.0) / np.float64(s)
    delta = np.float64(n + 64) * np.float64(2.0 ** -51)
    x = D.astype(np.float64) * inv_s
    elo, ehi = _exponent(x * (np.float64(1.0) - delta)), _exponent(x * (np.float64(1.0) + delta))
    return np.where(D == 0, _SEED_ZERO, np.where(elo == ehi, elo, _SEED_UNCERTAIN))


def _fn_compose(a, b):
    """vocab.cu compose: run a, then run b."""
    if a[4] == _SEED_NONE:
        return b
    if b[4] == _SEED_NONE:
        return a
    p0, p1 = a[2], a[3]
    return (a[0] + (b[1] if p0 else b[0]), a[1] + (b[1] if p1 else b[0]),
            b[3] if p0 else b[2], b[3] if p1 else b[2], a[4] if a[4] == b[4] else _SEED_BAD)


class _SeedModel:
    """The tiled seed draw of one node (vocab_seed_tile_kernel,
    vocab_seed_walk_kernel, walk_tile, walk_chunks) with tiles of `tile`
    rows: per row its run function or a break, per tile its segment, the walk
    from c = 0 over groups of 32 tiles (a group without a break composed into
    one run, else tile by tile; a far-apart middle walked in 32-row chunks),
    c at each group's end, and the pick: the first group, tile, chunk and row
    whose c passes u. Counts the rows stepped with a float add (`serial`),
    the ties and the tiles walked in chunks."""

    def __init__(self, d2, tile=4096):
        self.n, self.tile = len(d2), tile
        self.d2 = d2.astype(np.int64)
        self.s = int(self.d2.sum())
        self.serial = self.descents = 0
        if self.s == 0:
            return
        self.q = self.d2.astype(np.float64) / np.float64(self.s)
        D = np.cumsum(self.d2)
        cp, cc = _seed_classes(D - self.d2, self.s, self.n), _seed_classes(D, self.s, self.n)
        run = (self.d2 > 0) & (cp == cc) & (cc > _SEED_NOT_BINADE)
        e = np.where(run, cc, 0)
        x = np.ldexp(self.q, 52 - e)  # q / u
        run &= x < 2.0 ** 52
        a = np.floor(x)
        frac, a = x - a, a.astype(np.int64)
        tie = run & (frac == 0.5)
        inc = a + (frac > 0.5)
        self.ties = int(tie.sum())
        self.fn = [(int(i0), int(i1), int(p0), int(p1), int(b)) for i0, i1, p0, p1, b in zip(
            np.where(tie, a + (a & 1), inc), np.where(tie, a + ((a + 1) & 1), inc),
            np.where(tie, 0, inc & 1), np.where(tie, 0, (inc & 1) ^ 1), e)]
        self.brk = (self.d2 > 0) & ~run
        self.segs = [self._segment(t0, min(self.n, t0 + tile)) for t0 in range(0, self.n, tile)]
        c = np.float64(0.0)
        self.gend = []  # c at each group's end
        for g0 in range(0, len(self.segs), 32):
            if not any(sg[0] for sg in self.segs[g0: g0 + 32]):
                f = _FN_ID
                for sg in self.segs[g0: g0 + 32]:
                    f = _fn_compose(f, sg[1])
                c = self._apply(c, f)
            else:
                for j in range(g0, min(len(self.segs), g0 + 32)):
                    c = self._walk_tile(c, j)
            self.gend.append(c)
        self.total = c

    def _walk_tile(self, c, j):
        brk, head, tail, fb, lb = self.segs[j]
        if brk and lb - fb >= 32:
            self.descents += 1
            return self._walk_chunks(c, j * self.tile, min(self.n, (j + 1) * self.tile))[0]
        c = self._apply(c, head)
        return self._apply(self._step(c, fb, lb + 1), tail) if brk else c

    def _segment(self, lo, hi):
        """(break?, run before the first break, run after the last, first and
        last break) of rows lo..hi-1, as seg_push folds them."""
        head = tail = _FN_ID
        brk, fb, lb = False, -1, -1
        for i in range(lo, hi):
            if self.d2[i] == 0:
                continue
            if self.brk[i]:
                fb = i if not brk else fb
                brk, lb, tail = True, i, _FN_ID
            elif brk:
                tail = _fn_compose(tail, self.fn[i])
            else:
                head = _fn_compose(head, self.fn[i])
        return brk, head, tail, fb, lb

    @staticmethod
    def _apply(c, f):
        """apply_fn: an integer add to the bits of c, its binade checked."""
        if f[4] == _SEED_NONE:
            return c
        bits = int(np.float64(c).view(np.int64))
        assert f[4] != _SEED_BAD and bits >> 52 == f[4] + 1023, "c outside the run's binade"
        bits += f[1] if bits & 1 else f[0]
        assert bits >> 52 == f[4] + 1023, "a run left its binade"
        return np.int64(bits).view(np.float64)

    def _step(self, c, lo, hi):
        for i in range(lo, hi):
            c = c + self.q[i]
            self.serial += 1
        return c

    def _walk_chunks(self, c, lo, hi, u=None):
        for c0 in range(lo, hi, 32):
            c1 = min(hi, c0 + 32)
            brk, head, tail, fb, lb = self._segment(c0, c1)
            start = c
            c = self._apply(c, head)
            if brk:
                c = self._apply(self._step(c, fb, lb + 1), tail)
            if u is not None and c / self.total > u:
                for i in range(c0, c1):
                    start = start + self.q[i]
                    if start / self.total > u:
                        return start, i
                raise AssertionError("a chunk passed u and none of its rows")
        return c, None

    def pick(self, u):
        """(pick, zero): the first group, tile, chunk and row whose c passes u."""
        if self.s == 0:
            return 0, True
        for gi, ge in enumerate(self.gend):
            if ge / self.total > u:
                c = self.gend[gi - 1] if gi else np.float64(0.0)
                for j in range(32 * gi, min(len(self.segs), 32 * gi + 32)):
                    start, c = c, self._walk_tile(c, j)
                    if c / self.total > u:
                        return self._walk_chunks(start, j * self.tile, min(self.n, (j + 1) * self.tile), u)[1], False
                raise AssertionError("a group passed u and none of its tiles")
        return self.n, False


def _chain_model_pick(d2, u):
    """vocab_seed_chain_kernel: the chain in row order, c at each 32-row
    chunk's end, the first chunk and then the first row whose c passes u."""
    s = int(d2.astype(np.int64).sum())
    if s == 0:
        return 0, True
    c = np.cumsum(d2.astype(np.float64) / np.float64(s))
    ends = c[np.minimum(np.arange(31, len(d2) + 31, 32), len(d2) - 1)]
    passed = np.nonzero(ends / c[-1] > u)[0]
    if not len(passed):
        return len(d2), False
    rows = np.arange(32 * passed[0], min(len(d2), 32 * passed[0] + 32))
    return int(rows[np.nonzero(c[rows] / c[-1] > u)[0][0]]), False


def _numpy_pick(d2, u):
    s = d2.astype(np.int64).sum()
    if s == 0:
        return 0, True
    cdf = np.cumsum(d2.astype(np.float64) / s)
    cdf /= cdf[-1]
    return int(np.searchsorted(cdf, u, side="right")), False




def _adversarial_us(d2, rng):
    """Uniforms from numpy's stream and on and beside the cdf's own values."""
    us = list(rng.random(4)) + [0.0, np.nextafter(1.0, 0.0)]
    s = d2.astype(np.int64).sum()
    if s:
        cdf = np.cumsum(d2.astype(np.float64) / s)
        cdf /= cdf[-1]
        for i in rng.integers(0, len(d2), 4):
            us += [cdf[i], np.nextafter(cdf[i], 0.0), np.nextafter(cdf[i], 2.0)]
    return us


@pytest.mark.parametrize("name", SEED_DRAW_CASES)
def test_seed_draw_model_equals_numpy(name):
    """The tiled scan's model reproduces numpy's float64 cumsum at every
    group's end, bit for bit, and its pick is numpy's rng.choice's and the
    plain version's, at the real tile size and at 64-row tiles (many tiles,
    chunk walks); nodes of at most SEED_CHAIN_MAX rows through the chain's
    model too. The serial steps stay few."""
    rng = np.random.default_rng(SEED_DRAW_CASES.index(name))
    nodes = seed_draw_case(name, rng)
    ties = descents = 0
    for d2 in nodes:
        n = len(d2)
        models = [_SeedModel(d2, vk.SEED_TILE), _SeedModel(d2, 64)]
        s = int(d2.astype(np.int64).sum())
        if s:
            cs = np.cumsum(d2.astype(np.float64) / s)
            for m in models:
                ends = np.minimum(np.arange(32 * m.tile - 1, n + 32 * m.tile - 1, 32 * m.tile), n - 1)
                assert np.array_equal(np.array(m.gend), cs[ends]), "c at the groups' ends"
                assert m.serial <= 64 + 8 * np.log2(n + 1) + n // m.tile, m.serial
            ties += models[1].ties
            descents += sum(m.descents for m in models)
        us = _adversarial_us(d2, rng)
        off = torch.tensor([0, n], dtype=torch.int64)
        plain = [vk.vocab_seed_draw_plain(torch.from_numpy(d2), off, torch.tensor([u], dtype=torch.float64))
                 for u in us]
        for u, (pp, pz) in zip(us, plain):
            want = _numpy_pick(d2, u)
            assert (int(pp[0]), bool(pz[0])) == want, (n, u)
            for m in models:
                assert m.pick(u) == want, (name, n, m.tile, u)
            if n <= vk.SEED_CHAIN_MAX:
                assert _chain_model_pick(d2, u) == want
        if s:  # the stream's own draw
            r1, r2 = np.random.default_rng(n), np.random.default_rng(n)
            assert models[0].pick(r2.random()) == (r1.choice(n, p=d2 / d2.astype(np.int64).sum()), False)
    if name in ("ties", "ties_over_chain"):
        assert ties > 100, "the tie branch ran"
    if name in ("random", "256_then_ones"):
        assert descents > 0, "a tile was walked in chunks"


def _bits_t(x):
    return np.asarray(x, np.uint64).astype(np.uint32)


def _transpose32(x):
    """vocab.cu transpose32 over a warp: lane r's word -> lane b's mask of
    bit b over the 32 lanes, by five shuffle stages."""
    x = np.asarray(x, np.uint64)
    lanes = np.arange(32)
    for j, low in ((16, 0x0000FFFF), (8, 0x00FF00FF), (4, 0x0F0F0F0F), (2, 0x33333333), (1, 0x55555555)):
        y, high = x[lanes ^ j], np.uint64(~low & 0xFFFFFFFF)
        low, jj = np.uint64(low), np.uint64(j)
        x = np.where(lanes & j, (x & high) | ((y >> jj) & low), (x & low) | ((y << jj) & high))
    return _bits_t(x & np.uint64(0xFFFFFFFF))


def _quad_transpose(y):
    """vocab.cu quad_transpose: y [32 lanes, 4]; lane 4g + t's y[s] -> lane
    4g + s's y[t], by the two xor stages."""
    y = y.copy()
    lanes, tig = np.arange(32), np.arange(32) & 3
    for j, pairs in ((2, ((0, 2), (1, 3))), (1, ((0, 1), (2, 3)))):
        hi = (tig & j) != 0
        send = [np.where(hi, y[:, lo_], y[:, hi_]) for lo_, hi_ in pairs]
        recv = [v[lanes ^ j] for v in send]
        for (lo_, hi_), r in zip(pairs, recv):
            y[:, lo_] = np.where(hi, r, y[:, lo_])
            y[:, hi_] = np.where(hi, y[:, hi_], r)
    return y


def _popc(x):
    return np.array([bin(int(v)).count("1") for v in np.ravel(x)]).reshape(np.shape(x))


def _majority_model(rows, assign, offsets, k):
    """The majority's warps per node (128 rows a group, lane = row, k-word s
    = rows 32 s..): membership ballots as A, transposed bit columns as B,
    the 1-bit MMA's fragments in their registers, then the pack from the
    counts."""
    G = len(offsets) - 1
    lanes = np.arange(32)
    g_of, tig = lanes >> 2, lanes & 3
    centers = np.zeros((G, k, 8), np.uint32)
    sizes = np.zeros((G, k), np.int64)
    for node in range(G):
        cnt = np.zeros((16, 256), np.int64)
        sz = np.zeros(16, np.int64)
        for r0 in range(offsets[node], offsets[node + 1], 128):
            r_end = offsets[node + 1]
            x = np.zeros((4, 32, 8), np.uint32)
            a = np.full((4, 32), -1)
            for s in range(4):
                for lane in range(32):
                    r = r0 + 32 * s + lane
                    if r < r_end:
                        x[s, lane] = rows[r]
                        a[s, lane] = assign[r] if 0 <= assign[r] < k else -1
            mb = np.array([[sum(1 << int(ln) for ln in lanes if a[s, ln] == c) for c in range(16)]
                           for s in range(4)], np.uint64)  # ballots
            a0 = mb[tig, g_of]  # lane (g, tig): cluster g in k-word tig
            a1 = mb[tig, g_of + 8]
            for lane in range(32):  # each lane its k-word's; summed over the quad
                sz[g_of[lane]] += _popc(a0[lane])
                sz[g_of[lane] + 8] += _popc(a1[lane])
            for w in range(8):
                y = np.stack([_transpose32(x[s, :, w]) for s in range(4)], axis=1)
                z = _quad_transpose(y)
                for t in range(4):  # n-tile (w, t): column n <-> bit 32 w + 4 n + t
                    A = np.zeros((16, 4), np.uint64)  # [cluster, k-word], k-words 4..7 empty
                    B = np.zeros((4, 8), np.uint64)   # [k-word, column]
                    for lane in range(32):
                        A[g_of[lane], tig[lane]] = a0[lane]
                        A[g_of[lane] + 8, tig[lane]] = a1[lane]
                        B[tig[lane], g_of[lane]] = z[lane, t]
                    C = np.array([[sum(_popc(int(A[m, kw]) & int(B[kw, col])) for kw in range(4))
                                   for col in range(8)] for m in range(16)])
                    for lane in range(32):  # c0..c3 of lane (g, tig)
                        g, q = g_of[lane], tig[lane]
                        for m, col, v in ((g, 2 * q, C[g, 2 * q]), (g, 2 * q + 1, C[g, 2 * q + 1]),
                                          (g + 8, 2 * q, C[g + 8, 2 * q]), (g + 8, 2 * q + 1, C[g + 8, 2 * q + 1])):
                            cnt[m, 32 * w + 4 * col + t] += v
        maj = 2 * cnt[:k] >= sz[:k, None]
        centers[node] = np.packbits(maj.astype(np.uint8), axis=-1, bitorder="little").view(np.uint32)
        sizes[node] = sz[:k]
    return centers, sizes


MAJORITY_MODEL_SIZES = {
    "small": (0, 1, 31, 33, 128, 129, 300),
    "ragged": (95, 160, 257, 383),
    "warp_limit": (511, 512, 513),  # the last node a warp takes, the first a chunk takes
}


@pytest.mark.parametrize("nodes", sorted(MAJORITY_MODEL_SIZES))
@pytest.mark.parametrize("k", [1, 10, 16])
def test_majority_model_equals_plain(k, nodes):
    """The bit-transposed count's model gives the plain version's
    centroids and sizes, with empty clusters, rows whose cluster lies
    outside 0..k-1, and nodes that end inside a k-word or a group."""
    sizes = MAJORITY_MODEL_SIZES[nodes]
    rows, assign, off = majority_case(np.random.default_rng(90 + k + sum(sizes)), k, sizes)
    centers, sizes = _majority_model(rows, assign, off, k)
    pc, ps = vk.vocab_majority_plain(*counted_rows(_t(rows), torch.from_numpy(assign), torch.from_numpy(off), k), k)
    assert np.array_equal(centers.view(np.int32), pc.numpy())
    assert np.array_equal(sizes, ps.numpy())


def _cuda_constants():
    """csrc/vocab.cu's `constexpr int` sizes and each extern "C" launcher's
    number of parameters."""
    import re

    with open(os.path.join(REPO, "orb_slam2_2021_tpu_torch", "csrc", "vocab.cu")) as f:
        src = f.read()
    consts = {m[1]: int(m[2]) for m in re.finditer(r"constexpr int (\w+) = (\d+);", src)}
    params = {m[1]: len(m[2].split(",")) for m in re.finditer(r'extern "C" int (\w+)\(([^)]*)\)', src)}
    return consts, params


def test_kernel_sizes_match_the_source():
    """The wrappers' sizes (the plans, scratch and launch counts follow
    them) are the kernels' compile-time ones, and the ctypes signatures have
    the launchers' number of parameters."""
    consts, params = _cuda_constants()
    assert vk.MAX_K == consts["kMaxK"]
    assert vk.MAJORITY_SMALL == consts["kMajSmallRows"]
    assert vk.SEED_CHAIN_MAX == consts["kChainMax"]
    assert vk.SEED_TILE == consts["kTileThreads"] * consts["kTileRowsPerThread"]
    for kern in vk.KERNELS:
        assert len(kern.argtypes) == params[kern.symbol], kern.symbol
