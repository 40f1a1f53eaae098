"""Image-space primitives (counterpart of orb_slam2_2021_tpu/ops/image.py):
pyramid shapes, the antialiased bilinear resize the reference gets from
`jax.image.resize`, and the 7x7 Gaussian blur on the bf16 canvas.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def pyramid_shapes(height: int, width: int, n_levels: int, scale_factor: float):
    """Static (H_l, W_l) for each level (level 0 = full resolution)."""
    shapes = []
    for lvl in range(n_levels):
        inv = 1.0 / (scale_factor ** lvl)
        shapes.append((max(int(round(height * inv)), 32), max(int(round(width * inv)), 32)))
    return shapes


@functools.lru_cache(maxsize=8)
def gaussian_taps(ksize: int = 7, sigma: float = 2.0) -> np.ndarray:
    """Normalized float32 Gaussian taps (the reference's numpy recipe)."""
    half = ksize // 2
    x = np.arange(-half, half + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / np.sum(k)


@functools.lru_cache(maxsize=8)
def _bf16_taps(ksize: int, sigma: float):
    """The taps rounded to bf16, as the reference's weak-typed float taps are
    when they multiply a bf16 canvas."""
    k = torch.from_numpy(gaussian_taps(ksize, sigma)).to(torch.bfloat16)
    return tuple(float(v) for v in k.float())


def gaussian_blur_batched(images, ksize: int = 7, sigma: float = 2.0):
    """Separable blur over [..., H, W] (reflect padding) as 7 + 7
    shift-multiply-adds. On a bf16 canvas every product and sum rounds to
    bf16, as in the reference."""
    k = _bf16_taps(ksize, sigma)
    half = ksize // 2
    h, w = images.shape[-2], images.shape[-1]
    lead = images.shape[:-2]
    x = images.reshape(-1, 1, h, w)
    x = torch.nn.functional.pad(x, (0, 0, half, half), mode="reflect")
    acc = None
    for i in range(ksize):
        term = k[i] * x[..., i:i + h, :]
        acc = term if acc is None else acc + term
    x = torch.nn.functional.pad(acc, (half, half, 0, 0), mode="reflect")
    acc = None
    for i in range(ksize):
        term = k[i] * x[..., :, i:i + w]
        acc = term if acc is None else acc + term
    return acc.reshape(*lead, h, w)


@functools.lru_cache(maxsize=64)
def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """[in_size, out_size] float32 antialiased triangle-kernel weights, the
    matrix `jax.image.resize(..., "bilinear")` contracts with along one axis
    (jax/_src/image/scale.py compute_weight_mat, zero translation). Built in
    numpy float32, whose row-by-row column sums give the reference's weights
    bit for bit."""
    f32 = np.float32
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = f32(max(inv_scale, 1.0))
    sample_f = (np.arange(out_size, dtype=f32) + f32(0.5)) * f32(inv_scale) - f32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None]) / kernel_scale
    weights = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = np.sum(weights, axis=0, keepdims=True)
    weights = np.where(
        np.abs(total) > f32(1000.0 * np.finfo(np.float32).eps),
        weights / np.where(total != 0, total, f32(1.0)),
        f32(0.0),
    )
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], weights, f32(0.0)).astype(f32)


@functools.lru_cache(maxsize=64)
def _resize_weights_on(in_size: int, out_size: int, device: str):
    return torch.from_numpy(resize_weights(in_size, out_size)).to(device)


def resize_bilinear(images, out_h: int, out_w: int):
    """[B, H, W] float32 -> [B, out_h, out_w]: the antialiased bilinear
    resize as two float32 contractions (rows, then columns). The products
    sum in another order than XLA's, so a few pixels differ in the last
    float32 bits (a rare bf16 canvas pixel by one bf16 step)."""
    _, h, w = images.shape
    wh = _resize_weights_on(h, out_h, str(images.device))
    ww = _resize_weights_on(w, out_w, str(images.device))
    rows = torch.einsum("bhw,ho->bow", images, wh)
    return torch.einsum("bow,wp->bop", rows, ww)
