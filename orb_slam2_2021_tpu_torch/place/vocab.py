"""Binary bag-of-words vocabulary: loading, descent on the device, BoW
vectors and L1 scores (counterpart of orb_slam2_2021_tpu/place/vocab.py).

The tree is a [n_nodes, 8] descriptor table laid out so the children of node
n are n*k+1 .. n*k+k; descending N descriptors is L levels of a gather of the
k children, XOR, popcount and a first-occurrence argmin. Loading and scoring
are the reference's numpy code: they run on the host.

Training (`train_vocabulary`) serves the vocabulary scripts, not the System,
and is not ported (ROADMAP.md).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.hamming import _popcount32


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

    @staticmethod
    def load(path: str) -> "BinaryVocabulary":
        z = np.load(path)
        return BinaryVocabulary(int(z["k"]), int(z["L"]), z["node_desc"], z["word_idf"])


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
