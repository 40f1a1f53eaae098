"""Plain reference of the frame build: ORB extraction, stereo matching and
the RGB-D depth lookup, in plain PyTorch.

A frozen copy of the port's plain frame-build path (its `ops/image.py`,
`ops/fast.py`, `ops/select.py`, `ops/orientation.py`, `ops/brief.py`,
`ops/undistort.py`, `frontend/features.py` and `frontend/frame.py`, taken at
the commit that added this benchmark), with the hand-written Hamming kernel
replaced by its plain XOR + popcount version. It imports nothing of the
program: a later change to the program's frame build is judged against this
copy, so this file is never edited to follow the program.

`cfg` is a `reference.settings.Settings`: the upstream settings file's
values plus the extractor's fixed constants, read without the program.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch

MAX_DIST = 256  # descriptors are 256 bits


def _popcount32(x):
    """Per-element popcount of int32 words (SWAR; arithmetic shifts are
    masked so negative words count their sign bit once)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return (x & 0xFF) + ((x >> 8) & 0xFF) + ((x >> 16) & 0xFF) + ((x >> 24) & 0xFF)


def hamming_matrix(a, b):
    """[N, 8] x [M, 8] int32 -> [N, M] int16: XOR + popcount, word by word."""
    out = torch.zeros((a.shape[0], b.shape[0]), dtype=torch.int32, device=a.device)
    for w in range(a.shape[1]):
        out += _popcount32(a[:, w, None] ^ b[None, :, w])
    return out.to(torch.int16)


def best_two(d):
    """(best_idx, best, second_idx, second) along the last axis: the first
    two entries of a stable ascending argsort, by two first-occurrence
    argmins."""
    best_idx = torch.argmin(d, dim=-1, keepdim=True)
    best = torch.gather(d, -1, best_idx)
    d2 = d.scatter(-1, best_idx, MAX_DIST + 1)
    second_idx = torch.argmin(d2, dim=-1, keepdim=True)
    second = torch.gather(d, -1, second_idx)
    return best_idx[..., 0], best[..., 0], second_idx[..., 0], second[..., 0]


def hamming_best2(a, b, mask):
    """Masked best-two matcher over the plain distance matrix."""
    d = hamming_matrix(a, b)
    return best_two(torch.where(mask, d, torch.full_like(d, MAX_DIST)))


# ---- frozen from orb_slam2_2021_tpu_torch/ops/image.py: Image-space primitives (counterpart of orb_slam2_2021_tpu/ops/image.py):
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


# ---- frozen from orb_slam2_2021_tpu_torch/ops/fast.py: Two-threshold FAST-9 on the bf16 pyramid canvas (counterpart of
# 16-pixel Bresenham circle of radius 3, clockwise from 12 o'clock; (dy, dx)
CIRCLE_OFFSETS = (
    (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1),
)

ARC_LEN = 9  # FAST-9


def _has_arc(m):
    """int32 16-bit ring masks -> bool: any 9 circularly consecutive set bits."""
    acc = m
    for k in range(1, ARC_LEN):
        acc = acc & (((m >> k) | (m << (16 - k))) & 0xFFFF)
    return acc != 0


def nms3x3_batched(score):
    """3x3 non-max suppression over [B, H, W] (out-of-image neighbours
    ignored); keeps scores >= every neighbour and > 0."""
    pooled = torch.nn.functional.max_pool2d(score[:, None], 3, stride=1, padding=1)[:, 0]
    return torch.where((score >= pooled) & (score > 0.0), score, torch.zeros_like(score))


def fast_detect_batched(images, ini_threshold: float, min_threshold: float,
                        border: int, ext_h, ext_w):
    """images: [B, H, W] (bf16 canvas slabs); ext_h/ext_w: [B] int32 valid
    extents. Returns (strict, relaxed) NMS'd score maps, zero outside
    [border, ext - border)."""
    B, h, w = images.shape
    zero = torch.zeros((), dtype=images.dtype, device=images.device)
    ms_b = torch.zeros(images.shape, dtype=torch.int32, device=images.device)
    ms_d, mr_b, mr_d = ms_b.clone(), ms_b.clone(), ms_b.clone()
    es_b = torch.zeros_like(images)
    es_d, er_b, er_d = es_b.clone(), es_b.clone(), es_b.clone()
    for i, (dy, dx) in enumerate(CIRCLE_OFFSETS):
        diff = torch.roll(images, shifts=(-dy, -dx), dims=(1, 2)) - images
        bit = 1 << i
        bs = diff > ini_threshold
        ds = diff < -ini_threshold
        ms_b |= bs.to(torch.int32) * bit
        ms_d |= ds.to(torch.int32) * bit
        es_b = es_b + torch.where(bs, diff - ini_threshold, zero)
        es_d = es_d + torch.where(ds, -diff - ini_threshold, zero)
        br = diff > min_threshold
        dr = diff < -min_threshold
        mr_b |= br.to(torch.int32) * bit
        mr_d |= dr.to(torch.int32) * bit
        er_b = er_b + torch.where(br, diff - min_threshold, zero)
        er_d = er_d + torch.where(dr, -diff - min_threshold, zero)

    strict = torch.where(_has_arc(ms_b) | _has_arc(ms_d), torch.maximum(es_b, es_d), zero)
    relaxed = torch.where(_has_arc(mr_b) | _has_arc(mr_d), torch.maximum(er_b, er_d), zero)

    ys = torch.arange(h, dtype=torch.int32, device=images.device)[None, :, None]
    xs = torch.arange(w, dtype=torch.int32, device=images.device)[None, None, :]
    in_border = (
        (ys >= border) & (ys < ext_h[:, None, None] - border)
        & (xs >= border) & (xs < ext_w[:, None, None] - border)
    )
    strict = torch.where(in_border, nms3x3_batched(strict), zero)
    relaxed = torch.where(in_border, nms3x3_batched(relaxed), zero)
    return strict, relaxed


# ---- frozen from orb_slam2_2021_tpu_torch/ops/select.py: Spatially bucketed keypoint selection (counterpart of
K_PER_CELL = 8


def select_keypoints_batched(strict_score, relaxed_score, n_top: int, cell: int):
    """[B, H, W] score maps (H, W multiples of `cell`) -> (ys, xs, scores,
    valid), each [B, n_top], in (cell-rank, -response) order."""
    B, hp, wp = strict_score.shape
    hc, wc = hp // cell, wp // cell
    dev = strict_score.device

    def cells(x):
        return (
            x.reshape(B, hc, cell, wc, cell)
            .permute(0, 1, 3, 2, 4)
            .reshape(B, hc * wc, cell * cell)
        )

    s_cells = cells(strict_score)
    r_cells = cells(relaxed_score)
    has_strict = torch.amax(s_cells, dim=2, keepdim=True) > 0.0
    x = torch.where(has_strict, s_cells, r_cells)

    k = min(K_PER_CELL, cell * cell)
    neg_inf = torch.tensor(float("-inf"), dtype=x.dtype, device=dev)
    vals_l, idx_l = [], []
    for _ in range(k):
        i = torch.argmax(x, dim=2)                                    # [B, C]
        vals_l.append(torch.gather(x, 2, i[..., None])[..., 0])
        idx_l.append(i)
        x = x.scatter(2, i[..., None], neg_inf.expand(B, hc * wc, 1))
    # float32 from here: the rank * 1e5 separation must dominate exactly
    vals = torch.stack(vals_l, dim=2).to(torch.float32)               # [B, C, k]
    idx = torch.stack(idx_l, dim=2).to(torch.int32)
    rank = torch.arange(k, dtype=torch.float32, device=dev)[None, None, :]

    flat_vals = vals.reshape(B, -1)
    flat_rank = rank.expand(vals.shape).reshape(B, -1)
    cell_ids = (
        torch.arange(hc * wc, dtype=torch.int32, device=dev)[None, :, None]
        .expand(vals.shape).reshape(B, -1)
    )
    flat_idx = idx.reshape(B, -1)

    valid = flat_vals > 0.0
    key = torch.where(
        valid, -flat_rank * 1e5 + torch.clamp_max(flat_vals, 9e4),
        torch.tensor(float("-inf"), device=dev),
    )
    n_take = min(n_top, key.shape[1])
    top_keys, top_pos = torch.sort(key, dim=1, descending=True, stable=True)
    top_keys, top_pos = top_keys[:, :n_take], top_pos[:, :n_take]

    sel_cell = torch.gather(cell_ids, 1, top_pos)
    sel_inner = torch.gather(flat_idx, 1, top_pos)
    sel_val = torch.gather(flat_vals, 1, top_pos)
    sel_valid = torch.isfinite(top_keys) & (sel_val > 0.0)

    ys = (sel_cell // wc) * cell + sel_inner // cell
    xs = (sel_cell % wc) * cell + sel_inner % cell
    if n_take < n_top:
        pad = (0, n_top - n_take)
        ys, xs = torch.nn.functional.pad(ys, pad), torch.nn.functional.pad(xs, pad)
        sel_val = torch.nn.functional.pad(sel_val, pad)
        sel_valid = torch.nn.functional.pad(sel_valid.to(torch.uint8), pad).bool()
    return ys.to(torch.int32), xs.to(torch.int32), sel_val, sel_valid


# ---- frozen from orb_slam2_2021_tpu_torch/ops/orientation.py: Intensity-centroid keypoint orientation (counterpart of
HALF_PATCH = 15
PATCH = 2 * HALF_PATCH + 1


@functools.lru_cache(maxsize=1)
def moment_matrix() -> np.ndarray:
    """[961, 2] float32: circular-mask (dy, dx) weights giving (m01, m10)."""
    ys = np.arange(-HALF_PATCH, HALF_PATCH + 1, dtype=np.float32)
    dy = ys[:, None] * np.ones((1, PATCH), np.float32)
    dx = ys[None, :] * np.ones((PATCH, 1), np.float32)
    mask = ((dy * dy + dx * dx) <= float(HALF_PATCH * HALF_PATCH)).astype(np.float32)
    return np.stack([(mask * dy).reshape(-1), (mask * dx).reshape(-1)], axis=1)


@functools.lru_cache(maxsize=8)
def _moment_matrix_on(device: str):
    return torch.from_numpy(moment_matrix()).to(device)


def angles_from_patches(patches):
    """IC angles from [..., 961] patches (31x31 row-major) -> [...] radians.

    The moments are one float32 [N, 961] x [961, 2] product; each product of
    a bf16 sample and an integer weight is exact, only the summation order
    differs from the reference's bf16-in / f32-accumulate dot."""
    lead = patches.shape[:-1]
    m = torch.matmul(
        patches.reshape(-1, PATCH * PATCH).to(torch.float32),
        _moment_matrix_on(str(patches.device)),
    )
    return torch.atan2(m[:, 0], m[:, 1]).reshape(lead)


# ---- frozen from orb_slam2_2021_tpu_torch/ops/brief.py: Rotated BRIEF 256-bit descriptors (counterpart of
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


# ---- frozen from orb_slam2_2021_tpu_torch/ops/undistort.py: Keypoint undistortion, radial-tangential model (counterpart of
def _model(x, y, dist):
    k1, k2, p1, p2, k3 = dist
    r2 = x * x + y * y
    rad = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return rad, dx, dy


def distort_points(xy, fx, fy, cx, cy, dist: Sequence[float]):
    """Ideal pinhole pixel coordinates -> distorted ones (closed form)."""
    x = (xy[..., 0] - cx) / fx
    y = (xy[..., 1] - cy) / fy
    rad, dx, dy = _model(x, y, dist)
    return torch.stack([(x * rad + dx) * fx + cx, (y * rad + dy) * fy + cy], dim=-1)


def undistort_points(xy, fx, fy, cx, cy, dist: Sequence[float], iters: int = 10):
    """Distorted pixel coordinates -> ideal pinhole ones: x <- (xd -
    tangential(x)) / radial(x) from the distorted coordinates, `iters` times
    (10 for the strong freiburg1 lens)."""
    xd = (xy[..., 0] - cx) / fx
    yd = (xy[..., 1] - cy) / fy
    x, y = xd, yd
    for _ in range(iters):
        rad, dx, dy = _model(x, y, dist)
        rad = torch.clamp_min(rad, 1e-6)
        x = (xd - dx) / rad
        y = (yd - dy) / rad
    return torch.stack([x * fx + cx, y * fy + cy], dim=-1)


# ---- frozen from orb_slam2_2021_tpu_torch/frontend/features.py: ORB pyramid feature extraction (counterpart of
class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set (capacity = OrbConfig.n_features)."""
    xy: torch.Tensor        # [N, 2] float32, level-0 pixel coords (x, y)
    response: torch.Tensor  # [N] float32
    octave: torch.Tensor    # [N] int32
    angle: torch.Tensor     # [N] float32 radians
    desc: torch.Tensor      # [N, 8] int32 (the reference's uint32 bits)
    valid: torch.Tensor     # [N] bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]


def level_feature_counts(n_features: int, n_levels: int, scale_factor: float):
    """Per-level budget split (ORBextractor.cc:60-72), summing to n_features."""
    inv = 1.0 / scale_factor
    total = (1.0 - inv ** n_levels) / (1.0 - inv)
    counts = [int(round(n_features * (inv ** lvl) / total)) for lvl in range(n_levels)]
    counts[0] += n_features - sum(counts)
    return counts


def level_scales(cfg, device) -> torch.Tensor:
    """[L] float32 scale factor of each pyramid level."""
    return torch.tensor(
        [cfg.scale_factor ** i for i in range(cfg.n_levels)], dtype=torch.float32, device=device
    )


def _canvas_dims(h0: int, w0: int, cell: int):
    return ((h0 + cell - 1) // cell) * cell, ((w0 + cell - 1) // cell) * cell


def build_pyramid_stack(images, cfg):
    """[B, H, W] float32 -> ([B, L, Hc, Wc] bf16 canvas, ext_h, ext_w).

    Each level is resized from the previous float32 level and sits in the
    top-left corner of a canvas whose dims are multiples of the cell size;
    the canvas is cast to bf16 once, as in the reference."""
    B, h0, w0 = images.shape
    shapes = pyramid_shapes(h0, w0, cfg.n_levels, cfg.scale_factor)
    Hc, Wc = _canvas_dims(h0, w0, cfg.cell_size)
    slabs = []
    prev = images
    for lvl in range(cfg.n_levels):
        th, tw = shapes[lvl]
        if lvl > 0:
            prev = resize_bilinear(prev, th, tw)
        slabs.append(torch.nn.functional.pad(prev, (0, Wc - tw, 0, Hc - th)))
    stack = torch.stack(slabs, dim=1).to(torch.bfloat16)
    ext_h = np.asarray([s[0] for s in shapes], np.int32)
    ext_w = np.asarray([s[1] for s in shapes], np.int32)
    return stack, ext_h, ext_w


def gather_patches(stack, octave, y0, x0, bh: int, bw: int):
    """[B, L, Hc, Wc] stack, [B, N] level/corner coords -> [B, N, bh, bw]
    blocks (corners must already lie inside the canvas)."""
    B, L, Hc, Wc = stack.shape
    dev = stack.device
    dy = torch.arange(bh, device=dev)[:, None]
    dx = torch.arange(bw, device=dev)[None, :]
    b = torch.arange(B, device=dev)[:, None]
    base = ((b * L + octave.long()) * Hc + y0.long()) * Wc + x0.long()  # [B, N]
    idx = base[:, :, None, None] + dy * Wc + dx
    return stack.reshape(-1)[idx]


def extract_orb_batched(images, cfg):
    """[B, H, W] float32 (0..255) -> (Keypoints with leading B, raw canvas)."""
    B = images.shape[0]
    L = cfg.n_levels
    dev = images.device
    counts = level_feature_counts(cfg.n_features, L, cfg.scale_factor)
    raw_stack, ext_h, ext_w = build_pyramid_stack(images, cfg)
    _, _, Hc, Wc = raw_stack.shape

    ext_h_t = torch.from_numpy(np.tile(ext_h, B)).to(dev)
    ext_w_t = torch.from_numpy(np.tile(ext_w, B)).to(dev)
    strict, relaxed = fast_detect_batched(
        raw_stack.reshape(B * L, Hc, Wc), float(cfg.ini_fast_th), float(cfg.min_fast_th),
        cfg.edge_threshold, ext_h_t, ext_w_t,
    )
    n_top = max(counts)
    ys, xs, resp, valid = select_keypoints_batched(strict, relaxed, n_top, cfg.cell_size)
    ys, xs, resp, valid = (a.reshape(B, L, n_top) for a in (ys, xs, resp, valid))

    # each level's budget off the front (candidates are rank-ordered)
    ys = torch.cat([ys[:, lvl, :n] for lvl, n in enumerate(counts)], dim=1)      # [B, N]
    xs = torch.cat([xs[:, lvl, :n] for lvl, n in enumerate(counts)], dim=1)
    resp = torch.cat([resp[:, lvl, :n] for lvl, n in enumerate(counts)], dim=1)
    valid = torch.cat([valid[:, lvl, :n] for lvl, n in enumerate(counts)], dim=1)
    octave = torch.cat(
        [torch.full((B, n), lvl, dtype=torch.int32, device=dev) for lvl, n in enumerate(counts)],
        dim=1,
    )

    # one patch gather from the blurred canvas feeds orientation and BRIEF
    blur_stack = gaussian_blur_batched(raw_stack)
    oct_l = octave.long()
    eh = torch.from_numpy(ext_h).to(dev)[oct_l]
    ew = torch.from_numpy(ext_w).to(dev)[oct_l]
    y0 = torch.minimum(torch.clamp_min(ys - HALF_PATCH, 0), eh - PATCH)
    x0 = torch.minimum(torch.clamp_min(xs - HALF_PATCH, 0), ew - PATCH)
    patches = gather_patches(blur_stack, octave, y0, x0, PATCH, PATCH).reshape(B, -1, PATCH * PATCH)

    angle = angles_from_patches(patches)
    desc = brief_from_patches(patches, angle)

    s = level_scales(cfg, dev)[oct_l]
    xy = torch.stack([xs.to(torch.float32) * s, ys.to(torch.float32) * s], dim=-1)
    kp = Keypoints(xy=xy, response=resp, octave=octave, angle=angle, desc=desc, valid=valid)
    return kp, raw_stack


def extract_orb(image, cfg) -> Keypoints:
    """[H, W] float32 (0..255) -> Keypoints of one image (a batch of 1)."""
    kp, _ = extract_orb_batched(image[None], cfg)
    return Keypoints(*(x[0] for x in kp))


# ---- frozen from orb_slam2_2021_tpu_torch/frontend/frame.py: Frame assembly for the three sensors (counterpart of
TH_ORB_STEREO = 75  # (TH_HIGH + TH_LOW) / 2, Frame.cc:576


class Frame(NamedTuple):
    kp: Keypoints            # left-eye keypoints (capacity N)
    u_right: torch.Tensor    # [N] float32; -1 = no stereo match
    depth: torch.Tensor      # [N] float32; -1 = unknown
    sad_dist: torch.Tensor   # [N] float32; stereo SAD residual (diagnostics)

    @property
    def n(self) -> int:
        return self.kp.capacity


def _gather_blocks(stack, oct_, y0, x0, bh: int, bw: int, level_h, level_w):
    """[L, H0, W0] stack -> [N, bh, bw] blocks at per-keypoint level corners,
    corners clamped inside each level's extent (a window that would leave the
    level is shifted, not cut)."""
    o = oct_.long()
    y0c = torch.minimum(torch.clamp_min(y0, 0), level_h[o] - bh)
    x0c = torch.minimum(torch.clamp_min(x0, 0), level_w[o] - bw)
    return gather_patches(stack[None], oct_[None], y0c[None], x0c[None], bh, bw)[0]


def stereo_match(kpl: Keypoints, kpr: Keypoints, left_stack, right_stack,
                 level_h, level_w, cfg):
    """Per-left-keypoint subpixel right-eye coordinate + depth.
    Returns (u_right, depth, sad_dist), each [N]."""
    N = kpl.capacity
    scale = level_scales(cfg.orb, kpl.xy.device)
    inv_scale = 1.0 / scale

    uL, vL = kpl.xy[:, 0], kpl.xy[:, 1]
    uR, vR = kpr.xy[:, 0], kpr.xy[:, 1]
    min_z = cfg.bf / cfg.fx
    min_d = 0.0
    max_d = cfg.bf / min_z

    # candidate mask (the row band uses the right keypoint's octave)
    row_tol = cfg.stereo.row_slack_levels * scale[kpr.octave.long()]
    row_ok = torch.abs(vL[:, None] - vR[None, :]) <= row_tol[None, :]
    oct_ok = (
        (kpr.octave[None, :] >= kpl.octave[:, None] - 1)
        & (kpr.octave[None, :] <= kpl.octave[:, None] + 1)
    )
    u_ok = (uR[None, :] >= uL[:, None] - max_d) & (uR[None, :] <= uL[:, None] - min_d)
    mask = row_ok & oct_ok & u_ok & kpl.valid[:, None] & kpr.valid[None, :]

    best_idx, best_dist, _, _ = hamming_best2(kpl.desc, kpr.desc, mask)
    matched = best_dist < TH_ORB_STEREO

    # SAD subpixel refinement at the left keypoint's octave
    w = cfg.stereo.sad_window
    L = cfg.stereo.search_range
    isc = inv_scale[kpl.octave.long()]
    uL_l = torch.round(uL * isc).to(torch.int32)
    vL_l = torch.round(vL * isc).to(torch.int32)
    uR0_l = torch.round(uR[best_idx] * isc).to(torch.int32)
    size = 2 * w + 1
    wide = 2 * (w + L) + 1

    patch_l = _gather_blocks(
        left_stack, kpl.octave, vL_l - w, uL_l - w, size, size, level_h, level_w
    ).to(torch.float32)
    strip_r = _gather_blocks(
        right_stack, kpl.octave, vL_l - w, uR0_l - w - L, size, wide, level_h, level_w
    ).to(torch.float32)
    patch_l = patch_l - patch_l[:, w:w + 1, w:w + 1]

    sads = []
    for inc in range(-L, L + 1):
        sub = strip_r[:, :, L + inc:L + inc + size]
        sub = sub - sub[:, w:w + 1, w:w + 1]
        sads.append(torch.sum(torch.abs(patch_l - sub), dim=(1, 2)))
    sads = torch.stack(sads, dim=1)                                   # [N, 2L+1]
    best_inc_idx = torch.argmin(sads, dim=1)
    best_sad = torch.gather(sads, 1, best_inc_idx[:, None])[:, 0]
    at_border = (best_inc_idx == 0) | (best_inc_idx == 2 * L)

    # parabola refinement (Frame.cc:650-655)
    i1 = torch.clamp(best_inc_idx - 1, 0, 2 * L)
    i3 = torch.clamp(best_inc_idx + 1, 0, 2 * L)
    d1 = torch.gather(sads, 1, i1[:, None])[:, 0]
    d3 = torch.gather(sads, 1, i3[:, None])[:, 0]
    denom = 2.0 * (d1 + d3 - 2.0 * best_sad)
    delta = torch.where(torch.abs(denom) > 1e-6, (d1 - d3) / denom, torch.zeros_like(denom))
    delta_ok = (delta >= -1.0) & (delta <= 1.0)

    sc = scale[kpl.octave.long()]
    best_inc = (best_inc_idx - L).to(torch.float32)
    u_r_refined = sc * (uR0_l.to(torch.float32) + best_inc + delta)

    disparity = uL - u_r_refined
    # disparity in (-1, 0] snaps to 0.01 (Frame.cc:668-671)
    snap = (disparity <= 0.0) & (disparity > -1.0)
    disparity = torch.where(snap, torch.full_like(disparity, 0.01), disparity)
    u_r_refined = torch.where(snap, uL - 0.01, u_r_refined)
    disp_ok = (disparity >= min_d) & (disparity < max_d)
    ok = matched & ~at_border & delta_ok & disp_ok & kpl.valid

    # median outlier gate (Frame.cc:686-699)
    sad_masked = torch.where(ok, best_sad, torch.full_like(best_sad, float("inf")))
    n_ok = torch.sum(ok)
    sorted_sad = torch.sort(sad_masked).values
    median = sorted_sad[torch.clamp(n_ok // 2, 0, N - 1)]
    ok = ok & (best_sad < cfg.stereo.median_gate * median)

    neg = torch.full_like(disparity, -1.0)
    depth = torch.where(ok, cfg.bf / torch.clamp_min(disparity, 1e-6), neg)
    u_right = torch.where(ok, u_r_refined, neg)
    return u_right, depth, torch.where(ok, best_sad, neg)


def build_stereo_frame(image_left, image_right, cfg):
    """[H, W] float32 pair -> Frame; both eyes extracted as one batch, the
    raw canvas reused for the SAD refinement."""
    kp2, raw_stack = extract_orb_batched(torch.stack([image_left, image_right]), cfg.orb)
    kpl = Keypoints(*(x[0] for x in kp2))
    kpr = Keypoints(*(x[1] for x in kp2))
    h0, w0 = image_left.shape
    shapes = pyramid_shapes(h0, w0, cfg.orb.n_levels, cfg.orb.scale_factor)
    dev = image_left.device
    level_h = torch.from_numpy(np.asarray([s[0] for s in shapes], np.int32)).to(dev)
    level_w = torch.from_numpy(np.asarray([s[1] for s in shapes], np.int32)).to(dev)
    u_right, depth, sad = stereo_match(
        kpl, kpr, raw_stack[0], raw_stack[1], level_h, level_w, cfg
    )
    return Frame(kp=kpl, u_right=u_right, depth=depth, sad_dist=sad)


def build_stereo_frame_from_u8(images_u8, cfg):
    """Stereo frame from one stacked [2, H, W] uint8 tensor."""
    return build_stereo_frame(
        images_u8[0].to(torch.float32), images_u8[1].to(torch.float32), cfg
    )


def _undistort_kp(kp: Keypoints, cfg) -> Keypoints:
    """Keypoint coordinates mapped to the ideal pinhole camera when the
    config carries lens distortion; unchanged with zero coefficients."""
    if not any(cfg.dist_coef):
        return kp
    return kp._replace(xy=undistort_points(kp.xy, cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.dist_coef))


def build_rgbd_frame(image, depth_map, cfg, depth_scale: float = 1.0):
    """RGB-D pseudo-stereo from an [H, W] float32 image and depth map.
    Depth is read at the raw (distorted) rounded keypoint coordinates, since
    the depth image is aligned with the raw image; the virtual right-eye
    coordinate uses the undistorted x."""
    kp = extract_orb(image, cfg.orb)
    h, w = depth_map.shape
    xs = torch.clamp(torch.round(kp.xy[:, 0]).to(torch.int64), 0, w - 1)
    ys = torch.clamp(torch.round(kp.xy[:, 1]).to(torch.int64), 0, h - 1)
    d = depth_map.reshape(-1)[ys * w + xs] * depth_scale
    kp = _undistort_kp(kp, cfg)
    ok = (d > 0) & kp.valid
    neg = torch.full_like(d, -1.0)
    u_right = torch.where(ok, kp.xy[:, 0] - cfg.bf / torch.clamp_min(d, 1e-6), neg)
    return Frame(kp=kp, u_right=u_right, depth=torch.where(ok, d, neg), sad_dist=neg)


def build_mono_frame(image, cfg):
    """Monocular frame from an [H, W] float32 image: undistorted keypoints,
    no right eye and no depth."""
    kp = _undistort_kp(extract_orb(image, cfg.orb), cfg)
    neg = torch.full((kp.capacity,), -1.0, dtype=torch.float32, device=image.device)
    return Frame(kp=kp, u_right=neg, depth=neg, sad_dist=neg)
