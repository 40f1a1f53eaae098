"""Binary bag-of-words vocabulary: training, loading and writing, descent on
the device, BoW vectors and L1 scores (counterpart of
orb_slam2_2021_tpu/place/vocab.py).

The tree is a [n_nodes, 8] descriptor table laid out so the children of node
n are n*k+1 .. n*k+k; descending N descriptors is L levels of a gather of the
k children, XOR, popcount and a first-occurrence argmin. Training
(hierarchical binary k-medians with k-means++ seeding and bitwise-majority
centroids, DBoW2's create recipe), loading, writing and scoring are the
reference's numpy code on the same RNG stream: they run on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

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


def _majority_centroid(descs):
    """Bitwise majority vote (DBoW2's FORB::meanValue)."""
    bits = np.unpackbits(descs.view(np.uint8), axis=-1)  # [n, 256]
    maj = (bits.sum(axis=0) * 2 >= len(bits)).astype(np.uint8)
    return np.packbits(maj).view(np.uint32)


def _kmeans_binary(descs, k, rng, iters=8):
    """Binary k-medians with k-means++ seeding. Returns [k, 8] centroids."""
    n = len(descs)
    if n <= k:
        out = np.zeros((k, 8), np.uint32)
        out[:n] = descs
        if n:
            out[n:] = descs[rng.integers(0, n, k - n)]
        return out
    centers = [descs[rng.integers(n)]]
    d2 = _hamming_np(descs, np.asarray(centers)).min(axis=1).astype(np.float64)
    for _ in range(k - 1):
        s = d2.sum()
        if s <= 0:
            # every descriptor coincides with a center: a uniform pick
            centers.append(descs[rng.integers(n)])
            continue
        centers.append(descs[rng.choice(n, p=d2 / s)])
        d2 = np.minimum(d2, _hamming_np(descs, centers[-1][None])[:, 0])
    centers = np.asarray(centers)
    for _ in range(iters):
        assign = _hamming_np(descs, centers).argmin(axis=1)
        new = []
        for c in range(k):
            sel = descs[assign == c]
            if len(sel) == 0:
                sel = descs[rng.integers(0, n, 1)]
            new.append(_majority_centroid(sel))
        new = np.asarray(new)
        if (new == centers).all():
            break
        centers = new
    return centers


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


def train_vocabulary(descs: np.ndarray, k: int = 10, L: int = 4, seed: int = 0) -> BinaryVocabulary:
    """Hierarchical binary k-medians, breadth first, on one numpy RNG stream
    (DBoW2's TemplatedVocabulary::create recipe); idf from the corpus."""
    rng = np.random.default_rng(seed)
    n_nodes = (k ** (L + 1) - 1) // (k - 1)
    node_desc = np.zeros((n_nodes, 8), np.uint32)

    clusters = {0: descs}  # node id -> the descriptors under it
    for level in range(L):
        next_clusters = {}
        for node, sub in clusters.items():
            centers = _kmeans_binary(sub, k, rng)
            ch0 = node * k + 1
            node_desc[ch0: ch0 + k] = centers
            if level < L - 1:
                if len(sub):
                    assign = _hamming_np(sub, centers).argmin(axis=1)
                else:
                    assign = np.zeros(0, np.int64)
                for c in range(k):
                    next_clusters[ch0 + c] = sub[assign == c]
        clusters = next_clusters

    voc = BinaryVocabulary(k, L, node_desc, np.ones(k ** L, np.float32))
    # idf from the training corpus (TemplatedVocabulary::setNodeWeights)
    words = voc.transform_np(descs)
    counts = np.bincount(words, minlength=voc.n_words)
    n_docs_proxy = max(len(descs), 1)
    voc.word_idf = np.log(n_docs_proxy / np.maximum(counts, 1)).astype(np.float32)
    return voc


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
