"""Binary bag-of-words vocabulary: training, loading and writing, descent on
the device, BoW vectors and L1 scores (counterpart of
orb_slam2_2021_tpu/place/vocab.py).

The tree is a [n_nodes, 8] descriptor table laid out so the children of node
n are n*k+1 .. n*k+k; descending N descriptors is L levels of a gather of the
k children, XOR, popcount and a first-occurrence argmin. Training is the
reference's recipe (hierarchical binary k-medians with k-means++ seeding and
bitwise-majority centroids, DBoW2's create) run a level at a time on the
device: every node of a level at once through the kernels of
ops/vocab_kernels.py, the host keeping the reference's one RNG stream and
calling it in the reference's order, so the tree is the reference's bit for
bit. Loading, writing and scoring are the reference's numpy code on the
host.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..ops import vocab_kernels as vk
from ..ops.hamming import _popcount32


_POP8 = np.array([bin(i).count("1") for i in range(256)], np.uint8)


def _popcount_np(x):
    # a byte lookup table: unpackbits would materialize an 8x [.., 256]
    # uint8 intermediate, gigabytes at training scale
    return _POP8[x.view(np.uint8)].sum(axis=-1, dtype=np.uint16)


def _hamming_np(a, b, chunk: int = 262144):
    """[N, 8] x [M, 8] uint32 -> [N, M] uint16, chunked over N to bound the
    [chunk, M, 32]-byte popcount intermediate."""
    if len(a) <= chunk:
        return _popcount_np(a[:, None, :] ^ b[None, :, :]).astype(np.uint16)
    out = np.empty((len(a), len(b)), np.uint16)
    for s in range(0, len(a), chunk):
        out[s: s + chunk] = _popcount_np(a[s: s + chunk, None, :] ^ b[None, :, :])
    return out


@dataclass
class BinaryVocabulary:
    """k-ary tree of depth L. node_desc[0] is a dummy root; children of node
    n are n*k+1..n*k+k. Words are the k^L leaves, id = leaf index."""
    k: int
    L: int
    node_desc: np.ndarray     # [n_nodes, 8] uint32
    word_idf: np.ndarray      # [k^L] float32

    @property
    def n_words(self) -> int:
        return self.k ** self.L

    def n_nodes(self) -> int:
        return (self.k ** (self.L + 1) - 1) // (self.k - 1)

    def transform_np(self, descs: np.ndarray, chunk: int = 262144) -> np.ndarray:
        """[N, 8] uint32 -> [N] word ids on the host (chunked so
        million-descriptor training corpora stay in memory)."""
        out = np.empty(len(descs), np.int64)
        for s in range(0, len(descs), chunk):
            sub = descs[s: s + chunk]
            node = np.zeros(len(sub), np.int64)
            for _ in range(self.L):
                ch0 = node * self.k + 1
                cand = self.node_desc[ch0[:, None] + np.arange(self.k)[None]]
                d = _popcount_np(cand ^ sub[:, None, :])
                node = ch0 + d.argmin(axis=1)
            first_leaf = (self.k ** self.L - 1) // (self.k - 1)
            out[s: s + chunk] = node - first_leaf
        return out

    def save(self, path: str):
        np.savez_compressed(path, k=self.k, L=self.L, node_desc=self.node_desc, word_idf=self.word_idf)

    @staticmethod
    def load(path: str) -> "BinaryVocabulary":
        z = np.load(path)
        return BinaryVocabulary(int(z["k"]), int(z["L"]), z["node_desc"], z["word_idf"])


KMEANS_ITERS = 8   # k-medians iterations a node runs at most (the reference's `iters`)
MIN_WINDOW = 1024  # nodes a pass runs at least, after a resume


@dataclass
class _Pattern:
    """The draws a large node takes beyond `integers(n)`: a `random()` for
    each k-means++ step before `zero_from` and an `integers(n)` for each from
    it (k: none), then an `integers(0, n, 1)` for each empty cluster of each
    iteration in `empties`, in cluster order."""
    zero_from: int
    empties: Dict[int, Tuple[int, ...]] = field(default_factory=dict)  # iteration -> clusters


@dataclass
class _Draws:
    """One pass's draws for a run of a level's nodes: the small nodes' (n <= k)
    centre indices; for the large nodes (n > k) the first centre, the
    uniforms of the k-means++ steps (step j in 1..k-1), the integer picks of
    the zero-sum steps (-1 elsewhere), each pattern's first zero-sum step,
    its last iteration with empty-cluster picks (-1: none), and those picks
    by (large node, iteration)."""
    small: List[int]
    small_idx: np.ndarray      # [Gs, k] indices within the node
    large: List[int]
    first: np.ndarray          # [Gl]
    u: np.ndarray              # [Gl, k] float64
    int_pick: np.ndarray       # [Gl, k]
    zero_from: np.ndarray      # [Gl]
    last_empty: np.ndarray     # [Gl]
    empty_pick: Dict[Tuple[int, int], np.ndarray]  # (row in large, iteration) -> [k], -1 where none


def _draw(rng, n, lo: int, hi: int, k: int, patterns: Dict[int, _Pattern]) -> _Draws:
    """The reference's calls on its one stream for nodes lo..hi-1 of a level,
    in node order: a small node's `integers(0, n, k - n)`; a large node's
    `integers(n)` and then the draws of its pattern (by default a `random()`
    for each of the k - 1 k-means++ steps, as `rng.choice` draws one, and no
    empty cluster)."""
    n_large = int((n[lo:hi] > k).sum())
    d = _Draws([], np.zeros((0, k), np.int64), [], np.zeros(n_large, np.int64),
               np.zeros((n_large, k)), np.full((n_large, k), -1, np.int64),
               np.full(n_large, k, np.int64), np.full(n_large, -1, np.int64), {})
    small_idx = []
    ar = np.arange(k)
    for g in range(lo, hi):
        m = int(n[g])
        if m == 0:
            continue
        if m <= k:
            idx = ar.copy()
            idx[m:] = rng.integers(0, m, k - m)
            d.small.append(g)
            small_idx.append(idx)
            continue
        row = len(d.large)
        d.large.append(g)
        pat = patterns.get(g)
        z = pat.zero_from if pat is not None else k
        d.first[row] = rng.integers(m)
        if z > 1:
            d.u[row, 1:z] = rng.random(z - 1)
        for j in range(z, k):
            d.int_pick[row, j] = rng.integers(m)
        d.zero_from[row] = z
        if pat is not None and pat.empties:
            for it in sorted(pat.empties):
                pick = np.full(k, -1, np.int64)
                for c in pat.empties[it]:
                    pick[c] = rng.integers(0, m, 1)[0]
                d.empty_pick[(row, it)] = pick
            d.last_empty[row] = max(pat.empties)
    if small_idx:
        d.small_idx = np.stack(small_idx)
    return d


def _large_pass(X, offsets, d: _Draws, k: int):
    """Seeding and up to KMEANS_ITERS iterations for every large node of `d`
    at once, each on its own drawn pattern. Returns the centres [Gl, k, 8]
    and, on the host, what each node's data did where it first parted from
    its pattern: the seeding step (k: none) and whether d2 summed to 0
    there; else the iteration whose empty clusters differed from the
    pattern's (-1: none) and the clusters that were empty; and the
    iteration at which the centres repeated (-1: none)."""
    dev = X.device
    nodes = np.asarray(d.large, np.int64)
    n_host = offsets[nodes + 1] - offsets[nodes]
    g_count = len(nodes)
    n_l = torch.from_numpy(n_host).to(dev)
    off_l = torch.zeros(g_count + 1, dtype=torch.int64, device=dev)
    off_l[1:] = torch.cumsum(n_l, 0)
    total = int(n_host.sum())
    group = torch.repeat_interleave(torch.arange(g_count, device=dev), n_l, output_size=total)
    src = torch.from_numpy(offsets[nodes]).to(dev) - off_l[:-1]
    rows = X[src[group] + torch.arange(total, device=dev)]
    base = off_l[:-1]
    cent = torch.empty((g_count, k, 8), dtype=torch.int32, device=dev)

    # k-means++ seeding
    cent[:, 0] = rows[base + torch.from_numpy(d.first).to(dev)]
    _, d2 = vk.vocab_assign(rows, group, cent[:, :1].contiguous())
    u = torch.from_numpy(d.u).to(dev)
    int_pick = torch.from_numpy(d.int_pick).to(dev)
    zero_from = torch.from_numpy(d.zero_from).to(dev)
    seed_dev = torch.full((g_count,), k, dtype=torch.int64, device=dev)
    seed_zero = torch.zeros(g_count, dtype=torch.bool, device=dev)
    max_rows = int(n_host.max())
    for j in range(1, k):
        pick, zero = vk.vocab_seed_draw(d2, off_l, u[:, j].contiguous(), max_rows)
        assumed = zero_from <= j
        first = (zero != assumed) & (seed_dev == k)
        seed_dev = torch.where(first, j, seed_dev)
        seed_zero = torch.where(first, zero, seed_zero)
        cent[:, j] = rows[base + torch.where(assumed, int_pick[:, j], pick)]
        if j < k - 1:
            _, dj = vk.vocab_assign(rows, group, cent[:, j:j + 1].contiguous())
            d2 = torch.minimum(d2, dj)

    # binary k-medians; a node stops once its centres repeat, or where its
    # empty clusters are not its pattern's
    done = seed_dev < k
    it_dev = torch.full((g_count,), -1, dtype=torch.int64, device=dev)
    it_mask = torch.zeros((g_count, k), dtype=torch.bool, device=dev)
    conv = torch.full((g_count,), -1, dtype=torch.int64, device=dev)
    no_pick = torch.full((g_count, k), -1, dtype=torch.int64, device=dev)
    plan = vk.majority_plan(off_l)
    for it in range(KMEANS_ITERS):
        if bool(done.all()):
            break
        assign, _ = vk.vocab_assign(rows, group, cent)
        new, sizes = vk.vocab_majority(rows, assign, off_l, k, plan)
        empty = sizes == 0
        picks = [(r, p) for (r, i), p in d.empty_pick.items() if i == it]
        ep = no_pick
        if picks:
            ep = no_pick.clone()
            ep[torch.tensor([r for r, _ in picks], device=dev)] = torch.from_numpy(
                np.stack([p for _, p in picks])).to(dev)
        miss = (empty != (ep >= 0)).any(dim=1) & ~done
        it_dev = torch.where(miss, it, it_dev)
        it_mask = torch.where(miss[:, None], empty, it_mask)
        new = torch.where(empty[..., None], rows[base[:, None] + ep.clamp_min(0)], new)
        upd = ~done & ~miss
        same = upd & (new == cent).all(dim=2).all(dim=1)
        conv = torch.where(same, it, conv)
        cent = torch.where(upd[:, None, None], new, cent)
        done = done | miss | same
    host = [x.cpu().numpy() for x in (seed_dev, seed_zero, it_dev, it_mask, conv)]
    return cent, host


def _corrected(pat: _Pattern, k: int, seed_dev, seed_zero, it_dev, it_mask, conv, last_empty):
    """The pattern a node's data asked for where it first parted from `pat`
    (None where it did not): what was observed up to that point is exact
    for the first such node of a pass (its draws were the reference's); the
    rest is a guess, that the empty clusters found persist, which the next
    pass checks (d2 stays 0 after a zero-sum step, so its duplicated
    centres stay empty)."""
    if seed_dev < k:
        if seed_zero:
            return _Pattern(int(seed_dev), {it: tuple(range(seed_dev, k)) for it in range(KMEANS_ITERS)})
        return _Pattern(k)
    if it_dev >= 0:
        empties = {it: c for it, c in pat.empties.items() if it < it_dev}
        found = tuple(np.nonzero(it_mask)[0].tolist())
        if found:
            empties.update({it: found for it in range(it_dev, KMEANS_ITERS)})
        return _Pattern(pat.zero_from, empties)
    if 0 <= conv < last_empty:  # picks drawn for iterations after the centres repeated
        return _Pattern(pat.zero_from, {it: c for it, c in pat.empties.items() if it <= conv})
    return None


def _level_centres(X, offsets, k: int, rng, rec: dict):
    """The k centres of every node of a level ([G, k, 8] int32 on X's
    device), each as the reference's `_kmeans_binary` makes it on the shared
    stream. A pass runs a window of nodes from the first not yet final, each
    large node on its pattern of draws (by default: no zero-sum step, no
    empty cluster); the nodes before the first whose data parted from its
    pattern are final, and the next pass resumes at that one with the
    stream's state rewound to it and the patterns corrected. The first
    window is the whole level; after a resume a window is twice the run of
    nodes the last pass made final (at least MIN_WINDOW), and it doubles
    after a pass that made all of its nodes final, so a resume reruns about
    as many nodes as came before it. `rec` gets the level's counters."""
    dev = X.device
    g_count = len(offsets) - 1
    n = np.diff(offsets)
    cent = torch.zeros((g_count, k, 8), dtype=torch.int32, device=dev)
    off_dev = torch.from_numpy(offsets).to(dev)
    patterns: Dict[int, _Pattern] = {}
    lo, width, passes, resumes = 0, g_count, 0, 0
    while lo < g_count:
        passes += 1
        hi = min(g_count, lo + width)
        state = rng.bit_generator.state
        d = _draw(rng, n, lo, hi, k, patterns)
        if d.small:
            small = torch.tensor(d.small, device=dev)
            cent[small] = X[off_dev[small][:, None] + torch.from_numpy(d.small_idx).to(dev)]
        cand = np.zeros(0, np.int64)
        if d.large:
            lc, (seed_dev, seed_zero, it_dev, it_mask, conv) = _large_pass(X, offsets, d, k)
            cand = np.nonzero((seed_dev < k) | (it_dev >= 0) | ((conv >= 0) & (conv < d.last_empty)))[0]
            large = torch.tensor(d.large, device=dev)
        if len(cand) == 0:
            if d.large:
                cent[large] = lc
            lo, width = hi, 2 * width
            continue
        for row in cand.tolist():
            g = d.large[row]
            pat = patterns.get(g, _Pattern(k))
            patterns[g] = _corrected(pat, k, seed_dev[row], seed_zero[row], it_dev[row], it_mask[row],
                                     conv[row], d.last_empty[row])
        row = int(cand[0])
        cent[large[:row]] = lc[:row]
        g = d.large[row]
        rng.bit_generator.state = state
        _draw(rng, n, lo, g, k, patterns)  # replay the final nodes' draws
        resumes += 1
        lo, width = g, max(MIN_WINDOW, 2 * (g - lo))
    rec.update(nodes=g_count, large=int((n > k).sum()), passes=passes, resumes=resumes,
               zero_sum_picks=sum(k - p.zero_from for p in patterns.values()),
               empty_picks=sum(len(c) for p in patterns.values() for c in p.empties.values()))
    return cent


def _children(X, offsets, cent, k: int):
    """Each row's child: its node's index times k plus its nearest centre
    (first occurrence), [R] int64 on X's device."""
    g_count = len(offsets) - 1
    n = torch.from_numpy(np.diff(offsets)).to(X.device)
    group = torch.repeat_interleave(torch.arange(g_count, device=X.device), n, output_size=X.shape[0])
    assign, _ = vk.vocab_assign(X, group, cent)
    return group * k + assign


def train_vocabulary(descs: np.ndarray, k: int = 10, L: int = 4, seed: int = 0, device="cuda",
                     stats: Optional[dict] = None) -> BinaryVocabulary:
    """Hierarchical binary k-medians, breadth first, on one numpy RNG stream
    (DBoW2's TemplatedVocabulary::create recipe); idf from the corpus.

    Every node of a level runs at once on `device` (the card unless the
    caller asks for the CPU; the CPU runs the kernels' plain versions); the
    tree equals the reference's host trainer bit for bit, because the host
    keeps the one `np.random.default_rng(seed)` and calls it exactly as the
    reference does, node by node in ascending id. `stats`, if given, gets
    per level the nodes, the large ones (n > k), the passes and how many
    of them ended in a resume, the zero-sum and empty-cluster picks and the
    seconds (`stats["levels"]`), and `stats["level"]` names the level in
    progress."""
    dev = resolve_device(device)
    if not 2 <= k <= vk.MAX_K:
        raise ValueError(f"k = {k}: the trainer takes 2 <= k <= {vk.MAX_K}")
    descs = np.ascontiguousarray(np.asarray(descs, dtype=np.uint32))
    if descs.ndim != 2 or descs.shape[1] != 8:
        raise ValueError(f"descs: expected [N, 8] uint32 words, got {descs.shape}")
    stats = {} if stats is None else stats
    stats["levels"] = []
    rng = np.random.default_rng(seed)
    n_nodes = (k ** (L + 1) - 1) // (k - 1)
    tree = torch.zeros((n_nodes, 8), dtype=torch.int32, device=dev)
    X = torch.from_numpy(descs.view(np.int32)).to(dev)
    offsets = np.array([0, len(descs)], np.int64)
    for level in range(L):
        stats["level"] = level
        t0 = time.perf_counter()
        rec = {}
        cent = _level_centres(X, offsets, k, rng, rec)
        first_child = (k ** (level + 1) - 1) // (k - 1)
        tree[first_child: first_child + cent.shape[0] * k] = cent.reshape(-1, 8)
        child = _children(X, offsets, cent, k)
        counts = torch.bincount(child, minlength=cent.shape[0] * k)
        if level < L - 1:
            # each child's rows stay in corpus order, as `sub[assign == c]`
            X = X[torch.sort(child, stable=True).indices]
            offsets = np.concatenate([[0], np.cumsum(counts.cpu().numpy())]).astype(np.int64)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rec["seconds"] = time.perf_counter() - t0
        stats["levels"].append(rec)
    stats["level"] = None

    # idf from the training corpus (TemplatedVocabulary::setNodeWeights): the
    # last level's children are the words the descent through the tree gives
    node_desc = tree.cpu().numpy().view(np.uint32)
    n_docs_proxy = max(len(descs), 1)
    idf = np.log(n_docs_proxy / np.maximum(counts.cpu().numpy(), 1)).astype(np.float32)
    return BinaryVocabulary(k, L, node_desc, idf)


def save_orbvoc_text(voc: BinaryVocabulary, path: str):
    """Write the vocabulary in DBoW2's text format (ORBvoc.txt,
    TemplatedVocabulary::saveToTextFile): the header `k L scoring
    weighting`, then a line per node, breadth first, root omitted:
    `parent is_leaf b0..b31 weight`."""
    first_leaf = (voc.k ** voc.L - 1) // (voc.k - 1)
    with open(path, "w") as f:
        f.write(f"{voc.k} {voc.L} 0 0\n")  # L1_NORM scoring, TF_IDF weighting
        for nid in range(1, voc.n_nodes()):
            parent = (nid - 1) // voc.k
            is_leaf = 1 if nid >= first_leaf else 0
            by = voc.node_desc[nid].view(np.uint8)
            w = float(voc.word_idf[nid - first_leaf]) if is_leaf else 0.0
            f.write(f"{parent} {is_leaf} " + " ".join(str(int(b)) for b in by)
                    + f" {w}\n")


def load_orbvoc_text(path: str) -> BinaryVocabulary:
    """Load a DBoW2 text vocabulary (ORBvoc.txt format) into the complete
    k-ary layout: missing children are copies of the first real sibling and
    an early leaf is replicated straight down, so first-occurrence argmin
    never reaches a padded slot and each DBoW2 word maps to one leaf."""
    with open(path) as f:
        header = f.readline().split()
        k, L = int(header[0]), int(header[1])
        scoring, weighting = int(header[2]), int(header[3])
        if not (2 <= k <= 20 and 1 <= L <= 10 and 0 <= scoring <= 5
                and 0 <= weighting <= 3):
            raise ValueError(f"not a DBoW2 text vocabulary: header {header}")
        parents, desc_rows, weights = [], [], []
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            parents.append(int(parts[0]))
            desc_rows.append([int(x) for x in parts[2:34]])
            weights.append(float(parts[34]))

    n_file = len(parents) + 1  # + root (node 0, no line)
    file_desc = np.zeros((n_file, 8), np.uint32)
    file_desc[1:] = np.asarray(desc_rows, np.uint8).view(np.uint32)
    children: list = [[] for _ in range(n_file)]
    for i, p in enumerate(parents):
        children[p].append(i + 1)

    n_nodes = (k ** (L + 1) - 1) // (k - 1)
    first_leaf = (k ** L - 1) // (k - 1)
    node_desc = np.zeros((n_nodes, 8), np.uint32)
    word_idf = np.zeros(k ** L, np.float32)

    # (slot, file_node, depth); an early leaf replays itself down the levels
    stack = [(0, 0, 0)]
    while stack:
        slot, fnode, depth = stack.pop()
        if depth == L:
            word_idf[slot - first_leaf] = weights[fnode - 1] if fnode > 0 else 0.0
            continue
        ch0 = slot * k + 1
        cs = children[fnode]
        if not cs:
            node_desc[ch0: ch0 + k] = file_desc[fnode]
            stack.append((ch0, fnode, depth + 1))
            continue
        for j in range(k):
            node_desc[ch0 + j] = file_desc[cs[j] if j < len(cs) else cs[0]]
        for j, c in enumerate(cs):
            stack.append((ch0 + j, c, depth + 1))
    return BinaryVocabulary(k, L, node_desc, word_idf)


def vocab_transform(tree, descs, valid, k: int, L: int):
    """[N, 8] int32 descriptors -> [N] int32 word ids, -1 where not valid.

    tree: [n_nodes, 8] int32 tensor on the descriptors' device."""
    node = torch.zeros(descs.shape[0], dtype=torch.int64, device=descs.device)
    offsets = torch.arange(k, dtype=torch.int64, device=descs.device)
    for _ in range(L):
        ch0 = node * k + 1
        cand = tree[ch0[:, None] + offsets[None]]                    # [N, k, 8]
        d = _popcount32(cand ^ descs[:, None, :]).sum(dim=-1)        # [N, k]
        node = ch0 + torch.argmin(d, dim=1)
    words = (node - (k ** L - 1) // (k - 1)).to(torch.int32)
    return torch.where(valid, words, torch.full_like(words, -1))


def bow_vector(words: np.ndarray, idf: np.ndarray, n_words: int):
    """Sparse L1-normalized tf-idf vector: (word_ids [U], weights [U])."""
    w = words[words >= 0]
    if len(w) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.float32)
    uniq, cnt = np.unique(w, return_counts=True)
    vals = cnt.astype(np.float32) * idf[uniq]
    s = vals.sum()
    if s > 0:
        vals = vals / s
    return uniq, vals


def l1_score(w1, v1, w2, v2) -> float:
    """s = sum_w min(v1_w, v2_w) for L1-normalized vectors (DBoW2 L1)."""
    _, i1, i2 = np.intersect1d(w1, w2, assume_unique=True, return_indices=True)
    if len(i1) == 0:
        return 0.0
    return float(np.minimum(v1[i1], v2[i2]).sum())
