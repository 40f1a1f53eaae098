"""Rotated BRIEF 256-bit descriptors (counterpart of
orb_slam2_2021_tpu/ops/brief.py `brief_pattern` / `brief_from_patches`).

The reference computes each bit as the sign of patch . D[bin] with a
two-hot +-1 column per bit, summed in f32: that sum is exactly
p[second] - p[first], so comparing the two rotated samples gives the same
bits. Descriptors are packed into int32 words holding the reference's uint32
bits; bit 31 carries weight -2^31, so the word wraps to negative without any
wider integer.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

N_BITS = 256
PATTERN_RADIUS = 13.0
PATTERN_SIGMA = 31.0 / 5.0
N_BINS = 64          # descriptor-rotation quantization
PATCH_HALF = 15
PATCH_SIDE = 2 * PATCH_HALF + 1


@functools.lru_cache(maxsize=1)
def brief_pattern() -> np.ndarray:
    """[256, 2, 2] float32: (pair, endpoint, (y, x)); the reference's fixed
    seed and rejection recipe."""
    rng = np.random.default_rng(0x0FB1_5EED)
    pts = []
    while len(pts) < N_BITS * 2:
        p = rng.normal(0.0, PATTERN_SIGMA, size=2)
        if float(p @ p) <= PATTERN_RADIUS * PATTERN_RADIUS:
            pts.append(p)
    return np.asarray(pts, dtype=np.float32).reshape(N_BITS, 2, 2)


@functools.lru_cache(maxsize=2)
def brief_bin_offsets(n_bins: int = N_BINS) -> np.ndarray:
    """[n_bins, 256, 2] int64 flat patch indices of each pair's (first,
    second) endpoint rotated to each bin (the reference's
    `brief_bin_matrices` recipe, which stores the same indices as a
    two-hot matrix)."""
    pat = brief_pattern()
    py, px = pat[:, :, 0], pat[:, :, 1]
    out = np.zeros((n_bins, N_BITS, 2), np.int64)
    for b in range(n_bins):
        th = 2.0 * np.pi * b / n_bins
        ca, sa = np.cos(th), np.sin(th)
        ry = np.clip(np.round(px * sa + py * ca).astype(np.int64), -PATCH_HALF, PATCH_HALF)
        rx = np.clip(np.round(px * ca - py * sa).astype(np.int64), -PATCH_HALF, PATCH_HALF)
        out[b] = (ry + PATCH_HALF) * PATCH_SIDE + (rx + PATCH_HALF)
    return out


@functools.lru_cache(maxsize=8)
def _consts_on(device: str):
    offsets = torch.from_numpy(brief_bin_offsets()).to(device)
    weights = torch.tensor(
        [1 << j for j in range(31)] + [-(1 << 31)], dtype=torch.int32, device=device
    )
    return offsets, weights


def angle_bins(angles):
    """Rotation bin of each angle: round(mod(a, 2pi) / 2pi * 64) mod 64."""
    tau = 2.0 * torch.pi
    binf = torch.round(torch.remainder(angles, tau) / tau * N_BINS)
    return torch.remainder(binf.to(torch.int32), N_BINS)


def pack_bits(bits):
    """[..., 256] bool -> [..., 8] int32 words (little-endian bits per word)."""
    _, weights = _consts_on(str(bits.device))
    words = bits.reshape(*bits.shape[:-1], 8, 32).to(torch.int32) * weights
    return torch.sum(words, dim=-1, dtype=torch.int32)


def brief_from_patches(patches, angles):
    """patches: [..., 961] (31x31 blurred samples, row-major); angles: [...]
    radians. Returns [..., 8] int32 descriptors."""
    offsets, _ = _consts_on(str(patches.device))
    lead = patches.shape[:-1]
    p = patches.reshape(-1, PATCH_SIDE * PATCH_SIDE)
    idx = offsets[angle_bins(angles.reshape(-1)).long()]            # [N, 256, 2]
    first = torch.gather(p, 1, idx[..., 0])
    second = torch.gather(p, 1, idx[..., 1])
    return pack_bits(second > first).reshape(*lead, 8)
