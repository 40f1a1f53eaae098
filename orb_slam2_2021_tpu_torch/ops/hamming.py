"""Packed-descriptor Hamming distances (counterpart of
orb_slam2_2021_tpu/ops/hamming.py and ops/hamming_pallas.py).

Descriptors are [N, 8] int32 tensors holding the reference's 32-bit uint32
words bit for bit. `hamming_matrix` is the one Hamming function of the port:
on a CUDA tensor it launches the hand-written kernel `csrc/hamming.cu`; on a
CPU tensor it runs `hamming_matrix_plain`, the same function in plain
PyTorch.
"""

from __future__ import annotations

import ctypes

import torch

from .cuda_build import CudaKernel

MAX_DIST = 256  # descriptors are 256 bits; 256 > any real distance

HAMMING_KERNEL = CudaKernel(
    "hamming.cu", "hamming_matrix_launch",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
     ctypes.c_int, ctypes.c_int, ctypes.c_void_p],
)


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


def _check(x, name):
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(x).__name__}")
    if x.dtype != torch.int32:
        raise TypeError(f"{name}: expected int32 descriptors, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != 8:
        raise ValueError(f"{name}: expected shape [*, 8], got {tuple(x.shape)}")
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
    HAMMING_KERNEL.launches += 1
    return out


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
    """Row-wise (best_idx, best, second_idx, second) of an int [N, M] matrix:
    the first two entries of a stable ascending argsort (equal values keep
    index order), found by two first-occurrence argmins."""
    best_idx = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, best_idx[:, None])[:, 0]
    d2 = d.scatter(1, best_idx[:, None], MAX_DIST + 1)
    second_idx = torch.argmin(d2, dim=1)
    second = torch.gather(d, 1, second_idx[:, None])[:, 0]
    return best_idx, best, second_idx, second


def masked_best2(dist, mask):
    """Best and second-best distances (+ best index) along dim 1 under a
    boolean mask; masked entries count as MAX_DIST."""
    d = torch.where(mask, dist, torch.full_like(dist, MAX_DIST))
    best_idx = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, best_idx[:, None])[:, 0]
    d2 = d.scatter(1, best_idx[:, None], MAX_DIST)
    return best, best_idx, torch.amin(d2, dim=1)
