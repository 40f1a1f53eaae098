"""Two-threshold FAST-9 on the bf16 pyramid canvas (counterpart of
orb_slam2_2021_tpu/ops/fast.py `fast_detect_batched` / `nms3x3_batched`).

Ring differences and score sums stay in the canvas dtype, so on the bf16
canvas every difference and partial sum rounds to bf16 exactly as in the
reference. The 9-contiguous-arc test runs on 16-bit ring masks by bit
rotation.
"""

from __future__ import annotations

import torch

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
