"""ORB pyramid feature extraction (counterpart of
orb_slam2_2021_tpu/frontend/features.py `build_pyramid_stack`,
`extract_orb_batched` and `extract_orb`).

All eyes x all pyramid levels sit on one zero-padded bf16 canvas
[B, L, Hc, Wc]; FAST, selection, the 7x7 blur, one 31x31 patch gather, the IC
angle and rBRIEF each run once over the whole batch (the spans
`build.pyramid`, `build.fast`, `build.select`, `build.describe`).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..io import trace
from ..ops.brief import brief_from_patches
from ..ops.fast import fast_detect_batched
from ..ops.image import gaussian_blur_batched, pyramid_shapes, resize_bilinear
from ..ops.orientation import HALF_PATCH, PATCH, angles_from_patches
from ..ops.select import select_keypoints_batched


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
    with trace.span("build.pyramid"):
        raw_stack, ext_h, ext_w = build_pyramid_stack(images, cfg)
    _, _, Hc, Wc = raw_stack.shape

    with trace.span("build.fast"):
        ext_h_t = torch.from_numpy(np.tile(ext_h, B)).to(dev)
        ext_w_t = torch.from_numpy(np.tile(ext_w, B)).to(dev)
        strict, relaxed = fast_detect_batched(
            raw_stack.reshape(B * L, Hc, Wc), float(cfg.ini_fast_th), float(cfg.min_fast_th),
            cfg.edge_threshold, ext_h_t, ext_w_t,
        )
    with trace.span("build.select"):
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
    with trace.span("build.describe"):
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
