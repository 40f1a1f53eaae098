"""The vocabulary builder's kernels (`csrc/vocab.cu`) and their plain
PyTorch versions.

Hierarchical binary k-medians (place/vocab.train_vocabulary) runs every node
of a level at once. The rows of a level are [R, 8] int32 descriptors (the
reference's uint32 words bit for bit), grouped by node, each node's rows in
corpus order; `offsets` [G + 1] int64 bounds node g's rows. Three functions
reach the hand-written kernels, each with its own count of the CUDA kernels
it launches:

- `vocab_assign(rows, group, centers)`: per row, the first-occurrence argmin
  of the Hamming distances to the k centres of its group, and that distance;
- `vocab_majority(rows, assign, offsets, k)`: per node and cluster, the
  bitwise-majority centroid (2 * count >= size) and the cluster's size;
- `vocab_seed_draw(d2, offsets, u)`: per node, the k-means++ pick that
  numpy's `rng.choice(n, p=d2 / d2.sum())` makes from the uniform u, and a
  flag where d2 sums to 0.

On a CUDA tensor each launches its kernels or raises; on a CPU tensor it runs
its plain version (`*_plain`), which the tests hold against the reference.
The majority counts on 1-bit tensor cores (rows bit-transposed by warp
shuffles); the seed draw reproduces numpy's float64 cumulative sum by
composed per-binade integer runs over tiles: csrc/vocab.cu's header says how.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .cuda_build import CudaKernel
from .hamming import _popcount32

# the kernels' compile-time sizes, as csrc/vocab.cu sets them (the plans
# and scratch sizes below follow them)
MAX_K = 16             # centres per node the kernels take (kMaxK)
MAJORITY_SMALL = 512   # nodes up to this many rows: one warp each (kMajSmallRows)
SEED_CHAIN_MAX = 2048  # nodes up to this many rows: the warp chain (kChainMax)
SEED_TILE = 4096       # rows of a seed-draw tile (kTile)
SEED_KERNELS = 4       # kernels a seed draw launches where a node exceeds SEED_CHAIN_MAX
MAJORITY_CHUNK = 8192  # rows a block of the majority's chunk kernel counts

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
VOCAB_ASSIGN_KERNEL = CudaKernel("vocab.cu", "vocab_assign_launch", [_P, _P, _P, _I, _L, _P, _P, _P])
VOCAB_MAJORITY_KERNEL = CudaKernel("vocab.cu", "vocab_majority_launch",
                                   [_P, _P, _P, _I] + [_P] * 4 + [_I, _I] + [_P] * 5 + [_I, _P])
VOCAB_SEED_DRAW_KERNEL = CudaKernel("vocab.cu", "vocab_seed_draw_launch",
                                    [_P, _P, _P, _I, _L, _L, _P, _L, _P, _P, _P])
KERNELS = (VOCAB_ASSIGN_KERNEL, VOCAB_MAJORITY_KERNEL, VOCAB_SEED_DRAW_KERNEL)

_ROW_CHUNK = 1 << 15  # rows a plain version takes at once (bounds its temporaries)


def _check(x, name, dtype, dim):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(x).__name__}")
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if x.dim() != dim:
        raise ValueError(f"{name}: expected {dim} axes, got shape {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_rows(rows, name="rows"):
    _check(rows, name, torch.int32, 2)
    if rows.shape[1] != 8:
        raise ValueError(f"{name}: expected [*, 8] descriptors, got {tuple(rows.shape)}")


def _same_device(*xs):
    dev = xs[0].device
    if any(x.device != dev for x in xs):
        raise ValueError(f"inputs on different devices: {[str(x.device) for x in xs]}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def _aligned(x, name):
    if x.data_ptr() % 16:
        raise ValueError(f"{name}: descriptor rows must be 16-byte aligned")


def _launch(kernel, name, *args, kernels=1):
    """Run the launcher on the device's current stream; count the `kernels`
    CUDA kernels it starts."""
    fn = kernel.build()
    dev = args[-1]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*args[:-1], stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    for _ in range(kernels):
        kernel.count()


# ---------------------------------------------------------------- assignment

def vocab_assign_plain(rows, group, centers):
    """Per row r: (argmin_j d(rows[r], centers[group[r], j]) with the first
    occurrence winning a tie, as int64; that distance, as int32)."""
    n = rows.shape[0]
    idx = torch.empty(n, dtype=torch.int64, device=rows.device)
    dist = torch.empty(n, dtype=torch.int32, device=rows.device)
    for s in range(0, n, _ROW_CHUNK):
        e = min(n, s + _ROW_CHUNK)
        d = _popcount32(centers[group[s:e]] ^ rows[s:e, None, :]).sum(dim=-1)  # [c, k]
        best = torch.argmin(d, dim=1)
        idx[s:e] = best
        dist[s:e] = torch.gather(d, 1, best[:, None])[:, 0].to(torch.int32)
    return idx, dist


def vocab_assign(rows, group, centers):
    """rows [R, 8] int32, group [R] int64 into centers [G, k, 8] int32
    (k <= MAX_K) -> (idx [R] int64, dist [R] int32): the first-occurrence
    argmin of the Hamming distances to the row's group's centres.

    A CUDA input launches the kernel (and counts the launch) or raises; a
    CPU input runs the plain version."""
    _check_rows(rows)
    _check(group, "group", torch.int64, 1)
    _check(centers, "centers", torch.int32, 3)
    if group.shape[0] != rows.shape[0]:
        raise ValueError(f"group: {group.shape[0]} entries for {rows.shape[0]} rows")
    if centers.shape[2] != 8 or not 1 <= centers.shape[1] <= MAX_K:
        raise ValueError(f"centers: expected [G, k <= {MAX_K}, 8], got {tuple(centers.shape)}")
    dev = _same_device(rows, group, centers)
    if dev.type == "cpu":
        return vocab_assign_plain(rows, group, centers)
    _aligned(rows, "rows")
    _aligned(centers, "centers")
    n, k = rows.shape[0], centers.shape[1]
    idx = torch.empty(n, dtype=torch.int64, device=dev)
    dist = torch.empty(n, dtype=torch.int32, device=dev)
    if n == 0:
        return idx, dist
    _launch(VOCAB_ASSIGN_KERNEL, "vocab_assign", rows.data_ptr(), group.data_ptr(),
            centers.data_ptr(), k, n, idx.data_ptr(), dist.data_ptr(), dev)
    return idx, dist


# ------------------------------------------------------------------ majority

class MajorityPlan(NamedTuple):
    """How the majority's chunk kernel cuts the nodes of more than
    MAJORITY_SMALL rows (the others take a warp each): chunks of at most
    MAJORITY_CHUNK rows of one node, and a slot of the global count table for
    each node of more than one chunk."""
    chunk_row0: torch.Tensor  # [C] int64
    chunk_rows: torch.Tensor  # [C] int32
    chunk_node: torch.Tensor  # [C] int32
    node_slot: torch.Tensor   # [G] int32, -1 for a node of one chunk
    slot_node: torch.Tensor   # [S] int32


def majority_plan(offsets) -> MajorityPlan:
    """The chunk plan of `offsets` [G + 1] int64 (on the rows' device)."""
    dev = offsets.device
    n = offsets[1:] - offsets[:-1]
    n_chunks = torch.where(n > MAJORITY_SMALL, (n + MAJORITY_CHUNK - 1) // MAJORITY_CHUNK, 0)
    first = torch.cumsum(n_chunks, 0) - n_chunks
    total = int(n_chunks.sum())
    node = torch.repeat_interleave(torch.arange(n.shape[0], device=dev), n_chunks, output_size=total)
    local = torch.arange(total, device=dev) - first[node]
    row0 = offsets[:-1][node] + local * MAJORITY_CHUNK
    rows = torch.clamp(n[node] - local * MAJORITY_CHUNK, 0, MAJORITY_CHUNK)
    multi = n_chunks > 1
    slot = torch.where(multi, torch.cumsum(multi.to(torch.int64), 0) - 1, torch.full_like(n, -1))
    slot_node = torch.nonzero(multi)[:, 0]
    return MajorityPlan(row0.contiguous(), rows.to(torch.int32), node.to(torch.int32),
                        slot.to(torch.int32), slot_node.to(torch.int32))


def _pack_bits(maj):
    """[C, 256] bool (bit 32 w + b = bit b of word w) -> [C, 8] int32 words."""
    shifts = torch.arange(32, dtype=torch.int64, device=maj.device)
    words = (maj.view(-1, 8, 32).to(torch.int64) << shifts).sum(dim=-1)
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(torch.int32)


def vocab_majority_plain(rows, assign, offsets, k):
    """Per node g and cluster c of its rows (assign == c): the bit counts
    over 256 bits, packed by 2 * count >= size (an empty cluster packs to
    all ones), and the size. -> ([G, k, 8] int32, [G, k] int32)."""
    g_count = offsets.shape[0] - 1
    n = offsets[1:] - offsets[:-1]
    group = torch.repeat_interleave(torch.arange(g_count, device=rows.device), n, output_size=rows.shape[0])
    cid = group * k + assign
    counts = torch.zeros((g_count * k, 256), dtype=torch.int32, device=rows.device)
    shifts = torch.arange(32, dtype=torch.int32, device=rows.device)
    for s in range(0, rows.shape[0], _ROW_CHUNK):
        e = min(rows.shape[0], s + _ROW_CHUNK)
        bits = ((rows[s:e, :, None] >> shifts) & 1).reshape(e - s, 256)
        counts.index_add_(0, cid[s:e], bits)
    sizes = torch.bincount(cid, minlength=g_count * k)
    centers = _pack_bits(2 * counts.to(torch.int64) >= sizes[:, None])
    return centers.view(g_count, k, 8), sizes.view(g_count, k).to(torch.int32)


def vocab_majority(rows, assign, offsets, k, plan=None):
    """rows [R, 8] int32 grouped by node (`offsets` [G + 1] int64), assign
    [R] int64 in 0..k-1 -> (centers [G, k, 8] int32, sizes [G, k] int32):
    each cluster's bitwise-majority centroid, ties to 1 (2 * count >= size;
    an empty cluster gives all ones), and its size. `plan`: the
    `majority_plan(offsets)` of earlier calls on the same offsets (making
    one reads its size back to the host).

    A CUDA input launches the small-node kernel, the chunk kernel where a
    node has more than MAJORITY_SMALL rows and the pack kernel where a node
    spans more than one chunk (counting each launch), or raises; a CPU input
    runs the plain version."""
    _check_rows(rows)
    _check(assign, "assign", torch.int64, 1)
    _check(offsets, "offsets", torch.int64, 1)
    if assign.shape[0] != rows.shape[0]:
        raise ValueError(f"assign: {assign.shape[0]} entries for {rows.shape[0]} rows")
    if not 1 <= k <= MAX_K:
        raise ValueError(f"k = {k}: the kernel takes 1 <= k <= {MAX_K}")
    dev = _same_device(rows, assign, offsets)
    if dev.type == "cpu":
        return vocab_majority_plain(rows, assign, offsets, k)
    _aligned(rows, "rows")
    plan = majority_plan(offsets) if plan is None else plan
    g_count, n_chunks, n_slots = offsets.shape[0] - 1, plan.chunk_row0.shape[0], plan.slot_node.shape[0]
    centers = torch.empty((g_count, k, 8), dtype=torch.int32, device=dev)
    sizes = torch.empty((g_count, k), dtype=torch.int32, device=dev)
    slot_counts = torch.zeros((n_slots, k, 256), dtype=torch.int32, device=dev)
    slot_sizes = torch.zeros((n_slots, k), dtype=torch.int32, device=dev)
    if g_count == 0:
        return centers, sizes
    _launch(VOCAB_MAJORITY_KERNEL, "vocab_majority", rows.data_ptr(), assign.data_ptr(),
            offsets.data_ptr(), g_count, plan.chunk_row0.data_ptr(),
            plan.chunk_rows.data_ptr(), plan.chunk_node.data_ptr(), plan.node_slot.data_ptr(), n_chunks,
            k, centers.data_ptr(), sizes.data_ptr(), slot_counts.data_ptr(), slot_sizes.data_ptr(),
            plan.slot_node.data_ptr(), n_slots, dev,
            kernels=1 + (n_chunks > 0) + (n_slots > 0))
    return centers, sizes


# --------------------------------------------------------------- seed draws

def vocab_seed_draw_plain(d2, offsets, u):
    """Per node g: numpy's `rng.choice(n, p=d2 / s)` given the uniform u[g]:
    s = sum d2 (exact), p = d2 / s, cdf = cumsum(p) strictly left to right,
    cdf /= cdf[-1], searchsorted(u, right). -> (pick [G] int64, the index
    within the node, 0 where s == 0; zero [G] bool, s == 0).

    It computes on the CPU whatever the inputs' device (a CUDA cumsum scans
    in parallel and rounds otherwise), the nodes of one size at once as the
    rows of a [nodes, size] table (the CPU's cumsum along a row is a
    sequential sum)."""
    dev = d2.device
    d2c, off, uc = d2.cpu().to(torch.int64), offsets.cpu(), u.cpu()
    n = off[1:] - off[:-1]
    pick = torch.zeros(n.shape[0], dtype=torch.int64)
    zero = torch.zeros(n.shape[0], dtype=torch.bool)
    for m in torch.unique(n).tolist():
        nodes = torch.nonzero(n == m)[:, 0]
        if m == 0:
            zero[nodes] = True
            continue
        seg = d2c[off[nodes][:, None] + torch.arange(m)]
        s = seg.sum(dim=1)
        cdf = torch.cumsum(seg.to(torch.float64) / s.clamp_min(1).to(torch.float64)[:, None], dim=1)
        cdf = cdf / cdf[:, -1:]
        got = torch.searchsorted(cdf, uc[nodes][:, None], right=True)[:, 0]
        pick[nodes] = torch.where(s == 0, 0, got)
        zero[nodes] = s == 0
    return pick.to(dev), zero.to(dev)


def vocab_seed_draw(d2, offsets, u, max_rows=None):
    """d2 [R] int32 in 0..256 grouped by node (`offsets` [G + 1] int64), u [G]
    float64 in [0, 1) -> (pick [G] int64 within the node, zero [G] bool):
    the k-means++ pick exactly as numpy's rng.choice(n, p=d2 / s) makes it,
    and where d2 sums to 0 (pick 0 there). `max_rows`: the largest node's
    rows, which the caller of several draws on the same offsets knows
    (taking it from `offsets` reads it back to the host).

    A CUDA input launches the chain kernel and, where a node has more than
    SEED_CHAIN_MAX rows, the three kernels of the tiled scan (counting each
    launch), or raises; a CPU input runs the plain version."""
    _check(d2, "d2", torch.int32, 1)
    _check(offsets, "offsets", torch.int64, 1)
    _check(u, "u", torch.float64, 1)
    if u.shape[0] != offsets.shape[0] - 1:
        raise ValueError(f"u: {u.shape[0]} draws for {offsets.shape[0] - 1} nodes")
    dev = _same_device(d2, offsets, u)
    if dev.type == "cpu":
        return vocab_seed_draw_plain(d2, offsets, u)
    g_count, n = u.shape[0], d2.shape[0]
    pick = torch.empty(g_count, dtype=torch.int64, device=dev)
    zero = torch.empty(g_count, dtype=torch.bool, device=dev)
    if g_count == 0:
        return pick, zero
    if max_rows is None:
        max_rows = int((offsets[1:] - offsets[:-1]).max())
    tiled = max_rows > SEED_CHAIN_MAX
    words = (seed_scratch_bytes(g_count, n) + 7) // 8 if tiled else 0
    scratch = torch.empty(words, dtype=torch.int64, device=dev)
    _launch(VOCAB_SEED_DRAW_KERNEL, "vocab_seed_draw", d2.data_ptr(), offsets.data_ptr(),
            u.data_ptr(), g_count, n, max_rows, scratch.data_ptr(), 8 * scratch.numel(),
            pick.data_ptr(), zero.data_ptr(), dev, kernels=SEED_KERNELS if tiled else 1)
    return pick, zero


def seed_scratch_bytes(groups, rows):
    """The scratch of a tiled seed draw (vocab.cu, vocab_seed_draw_launch):
    per tile of the bound, its sum, c at its end and at its group's end (8
    bytes each), its segment (64) and its node (4); per node its first tile,
    per node that may exceed SEED_CHAIN_MAX its place in the walk (4 each);
    two counts."""
    large = min(groups, rows // (SEED_CHAIN_MAX + 1))
    tiles = rows // SEED_TILE + large + 1
    return tiles * (3 * 8 + 64 + 4) + 4 * (groups + large) + 8
