"""Packed-descriptor Hamming distances (counterpart of
orb_slam2_2021_tpu/ops/hamming.py and ops/hamming_pallas.py).

Descriptors are [N, 8] int32 tensors holding the reference's 32-bit uint32
words bit for bit. Two functions reach the hand-written kernel
`csrc/hamming.cu`, each with its own launch count:

- `hamming_matrix(a, b)`: the [N, M] int16 distance matrix;
- `hamming_best2(a, b, mask)`: per row the first-occurrence best and
  second-best of where(mask, distances, MAX_DIST), without the matrix ever
  reaching memory. Every matcher of the port calls this one.

On a CUDA tensor each launches its kernel or raises; on a CPU tensor it
runs its plain PyTorch version (`hamming_matrix_plain`,
`hamming_best2_plain`).
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaKernel

MAX_DIST = 256  # descriptors are 256 bits; 256 > any real distance
MAX_COLUMNS = 1 << 22  # hamming_best2 packs a column index into 22 bits

HAMMING_KERNEL = CudaKernel(
    "hamming.cu", "hamming_matrix_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)
HAMMING_BEST2_KERNEL = CudaKernel(
    "hamming.cu", "hamming_best2_launch",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
)
_BEST2_ROWS, _BEST2_COLS = 128, 128  # the fused kernel's block rows and column chunk
_BEST2_BLOCKS_PER_SM = 4  # blocks the column slicing aims for (measured best on an H100)


def _popcount32(x):
    """Per-element popcount of int32 words (SWAR; arithmetic shifts are
    masked so negative words count their sign bit once)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x & 0xFF) + ((x >> 8) & 0xFF) + ((x >> 16) & 0xFF) + ((x >> 24) & 0xFF)


def hamming_matrix_plain(a, b):
    """[N, 8] x [M, 8] int32 -> [N, M] int16: XOR + popcount, word by word."""
    out = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int32, device=a.device)
    for w in range(a.shape[1]):
        out += _popcount32(a[:, w, None] ^ b[None, :, w])
    return out.to(torch.int16)


def _check(x, name, dims=(2,)):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(x).__name__}")
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 descriptors, got {x.dtype}")
    if x.dim() not in dims or x.shape[-1] != 8:
        raise ValueError(f"{name}: expected shape [*, 8] ({' or '.join(map(str, dims))} axes), "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: descriptors must be contiguous")


def hamming_matrix(a, b):
    """[N, 8] x [M, 8] int32 -> [N, M] int16 distance matrix.

    A CUDA input launches the kernel (and counts the launch) or raises; a CPU
    input runs the plain version."""
    _check(a, "a")
    _check(b, "b")
    if a.device != b.device:
        raise ValueError(f"descriptors on different devices: {a.device} vs {b.device}")
    if a.device.type == "cpu":
        return hamming_matrix_plain(a, b)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    for x, name in ((a, "a"), (b, "b")):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: descriptor rows must be 16-byte aligned")
    fn = HAMMING_KERNEL.build()
    n, m = a.shape[0], b.shape[0]
    out = torch.empty((n, m), dtype=torch.int16, device=a.device)
    if n == 0 or m == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, m, stream)
    if err != 0:
        raise RuntimeError(f"hamming_matrix kernel launch failed: CUDA error {err}")
    HAMMING_KERNEL.count()
    return out


def hamming_best2_plain(a, b, mask):
    """`hamming_best2` in plain PyTorch: the distance matrix, masked entries
    set to MAX_DIST, then `best_two` along the last axis."""
    if b.dim() == 2:
        d = hamming_matrix_plain(a, b)
    else:
        T, M = b.shape[0], b.shape[1]
        d = hamming_matrix_plain(a, b.reshape(T * M, 8)).view(a.shape[0], T, M).permute(1, 0, 2)
    return best_two(torch.where(mask, d, torch.full_like(d, MAX_DIST)))


def _best2_slices(n: int, m: int, t: int, device) -> int:
    """Column slices of the fused kernel's walk: enough blocks for about
    _BEST2_BLOCKS_PER_SM per SM, each slice a whole number of 128-column
    chunks."""
    chunks = -(-m // _BEST2_COLS)
    blocks = -(-n // _BEST2_ROWS) * t
    target = _BEST2_BLOCKS_PER_SM * torch.cuda.get_device_properties(device).multi_processor_count
    per_slice = -(-chunks // min(chunks, max(1, -(-target // blocks))))
    return -(-chunks // per_slice)


def hamming_best2(a, b, mask):
    """Fused masked best-two matcher: a [N, 8] against b [M, 8] under mask
    [N, M], or against T stacked sets b [T, M, 8] under mask [T, N, M].

    Returns (best_idx, best, second_idx, second), each [N] or [T, N]:
    exactly best_two(where(mask, hamming_matrix(a, b), MAX_DIST)) along the
    column axis (indices int64, distances int16; first occurrence wins; with
    M == 1 the second is the best). A CUDA input launches the fused kernel
    (and counts the launch) or raises; a CPU input runs the plain version."""
    _check(a, "a")
    _check(b, "b", dims=(2, 3))
    T = b.shape[0] if b.dim() == 3 else 1
    n, m = a.shape[0], b.shape[-2]
    want = (n, m) if b.dim() == 2 else (T, n, m)
    if not isinstance(mask, torch.Tensor) or mask.dtype != torch.bool or tuple(mask.shape) != want:
        raise ValueError(f"mask: expected a bool tensor of shape {want}")
    if not mask.is_contiguous():
        raise ValueError("mask: must be contiguous")
    if m == 0:
        raise ValueError("hamming_best2: no columns to choose from (M == 0)")
    if not (a.device == b.device == mask.device):
        raise ValueError(f"inputs on different devices: {a.device}, {b.device}, {mask.device}")
    if a.device.type == "cpu":
        return hamming_best2_plain(a, b, mask)
    if a.device.type != "cuda":
        raise ValueError(f"unsupported device {a.device}")
    for x, name in ((a, "a"), (b, "b")):
        if x.data_ptr() % 16:
            raise ValueError(f"{name}: descriptor rows must be 16-byte aligned")
    if m >= MAX_COLUMNS:
        raise ValueError(f"hamming_best2: M = {m} columns, the kernel takes fewer than {MAX_COLUMNS}")
    fn = HAMMING_BEST2_KERNEL.build()
    lead = (n,) if b.dim() == 2 else (T, n)
    best_idx = torch.empty(lead, dtype=torch.int64, device=a.device)
    second_idx = torch.empty(lead, dtype=torch.int64, device=a.device)
    best = torch.empty(lead, dtype=torch.int16, device=a.device)
    second = torch.empty(lead, dtype=torch.int16, device=a.device)
    if n == 0 or T == 0:
        return best_idx, best, second_idx, second
    slices = _best2_slices(n, m, T, a.device)
    part = torch.empty((T, slices, n, 2), dtype=torch.int32, device=a.device)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), mask.data_ptr(), part.data_ptr(),
                 best_idx.data_ptr(), best.data_ptr(), second_idx.data_ptr(), second.data_ptr(),
                 n, m, T, slices, stream)
    if err != 0:
        raise RuntimeError(f"hamming_best2 kernel launch failed: CUDA error {err}")
    HAMMING_BEST2_KERNEL.count()
    return best_idx, best, second_idx, second


def rotation_histogram_filter(angle_a, angle_b, matched_mask, n_bins=30, keep=3):
    """Rotation-consistency check: keep matches whose angle difference falls
    in the `keep` most populated of `n_bins` histogram bins (ties between
    bins go to the lower bin, as the reference's stable top_k)."""
    two_pi = 2.0 * torch.pi
    rot = torch.remainder(angle_a - angle_b, two_pi)
    bins = torch.clamp(torch.floor(rot * (n_bins / two_pi)).to(torch.int32), 0, n_bins - 1)
    counts = torch.zeros(n_bins, dtype=torch.int32, device=bins.device)
    counts.scatter_add_(0, bins.long(), matched_mask.to(torch.int32))
    top_idx = torch.sort(counts, descending=True, stable=True).indices[:keep]
    in_top = torch.any(bins[:, None] == top_idx[None, :], dim=1)
    return matched_mask & in_top & (counts[bins.long()] > 0)


def best_two(d):
    """(best_idx, best, second_idx, second) along the last axis of an int
    [..., M] tensor: the first two entries of a stable ascending argsort
    (equal values keep index order), found by two first-occurrence argmins."""
    best_idx = torch.argmin(d, dim=-1, keepdim=True)
    best = torch.gather(d, -1, best_idx)
    d2 = d.scatter(-1, best_idx, MAX_DIST + 1)
    second_idx = torch.argmin(d2, dim=-1, keepdim=True)
    second = torch.gather(d, -1, second_idx)
    return best_idx[..., 0], best[..., 0], second_idx[..., 0], second[..., 0]


def masked_best2(dist, mask):
    """Best and second-best distances (+ best index) along dim 1 under a
    boolean mask; masked entries count as MAX_DIST."""
    d = torch.where(mask, dist, torch.full_like(dist, MAX_DIST))
    best_idx = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, best_idx[:, None])[:, 0]
    d2 = d.scatter(1, best_idx[:, None], MAX_DIST)
    return best, best_idx, torch.amin(d2, dim=1)
