"""Tracked-feature overlay, the FrameDrawer of the upstream system
(counterpart of orb_slam2_2021_tpu/viz/frame_drawer.py).

Keypoints over the current frame: green squares and dots for features
matched to map points, blue for temporal visual-odometry points in
localization mode (FrameDrawer.cc DrawFrame), gray dots for the rest, and a
status bar with the state, keyframe and map-point counts and the match
count (DrawTextInfo). Output is a numpy [H + BAR_H, W, 3] uint8 image.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .draw import draw_points, draw_rect, draw_text, fill_rect

GREEN = (0, 220, 0)
BLUE = (80, 120, 255)
GRAY = (160, 160, 160)
BAR_H = 14


class FrameDrawer:
    def __init__(self, cfg=None):
        self.cfg = cfg
        self.last_image: Optional[np.ndarray] = None

    def draw(
        self,
        image: np.ndarray,          # [H, W] grayscale (float or uint8)
        kp_xy: np.ndarray,          # [N, 2]
        kp_valid: np.ndarray,       # [N] bool (extracted keypoints)
        bind: Optional[np.ndarray] = None,   # [N] map-point id per feature (-1)
        inlier: Optional[np.ndarray] = None, # [N] bool tracked inliers
        vo_mask: Optional[np.ndarray] = None,  # [N] temporal VO points
        state: str = "OK",
        n_kf: int = 0,
        n_mp: int = 0,
    ) -> np.ndarray:
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = np.clip(img, 0, 255).astype(np.uint8)
        rgb = np.repeat(img[..., None], 3, axis=2).copy()

        kp_xy = np.asarray(kp_xy)
        kp_valid = np.asarray(kp_valid, bool)
        if bind is None:
            bind = np.full(len(kp_xy), -1, np.int64)
        tracked = kp_valid & (np.asarray(bind) >= 0)
        if inlier is not None:
            tracked = tracked & np.asarray(inlier, bool)
        n_tracked = int(tracked.sum())

        # untracked keypoints: faint gray dots
        draw_points(rgb, kp_xy[kp_valid & ~tracked], GRAY, size=1)
        # tracked map points: green 7 px squares around a dot
        for x, y in kp_xy[tracked]:
            draw_rect(rgb, int(x) - 3, int(y) - 3, int(x) + 3, int(y) + 3, GREEN)
        draw_points(rgb, kp_xy[tracked], GREEN, size=2)
        if vo_mask is not None:
            vo = kp_valid & np.asarray(vo_mask, bool)
            for x, y in kp_xy[vo]:
                draw_rect(rgb, int(x) - 3, int(y) - 3, int(x) + 3, int(y) + 3, BLUE)
            draw_points(rgb, kp_xy[vo], BLUE, size=2)

        # status bar below the frame
        H, W = rgb.shape[:2]
        out = np.zeros((H + BAR_H, W, 3), np.uint8)
        out[:H] = rgb
        fill_rect(out, 0, H, W, H + BAR_H, (30, 30, 30))
        msg = f"{state}  KFS: {n_kf}  MPS: {n_mp}  MATCHES: {n_tracked}"
        draw_text(out, msg, 4, H + 3, (255, 255, 255))
        self.last_image = out
        return out

    def draw_from_system(self, system, image: np.ndarray, map_store=None) -> np.ndarray:
        """Draw the port System's current tracking state: the last frame's
        keypoints (its host arrays, pulled in one copy on first read), the
        tracker's bindings and state, and the keyframe and map-point counts
        of `map_store` (default: the System's map; the Viewer passes its
        snapshot in async mode)."""
        tr = system.tracker
        m = system.map if map_store is None else map_store
        lf = tr.last_frame_data or {}
        bind = getattr(tr, "_bind_cur", None)
        kp_xy = lf.get("xy")
        kp_valid = lf.get("kp_valid")
        if kp_xy is None:
            kp_xy = np.zeros((0, 2), np.float32)
            kp_valid = np.zeros((0,), bool)
        return self.draw(
            image, kp_xy, kp_valid, bind=bind,
            state=tr.state.name,
            n_kf=m.n_kf,
            n_mp=int(m.mp_valid.sum()),
        )
