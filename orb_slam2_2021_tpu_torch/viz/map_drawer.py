"""Top-down map view, the MapDrawer of the upstream system, headless
(counterpart of orb_slam2_2021_tpu/viz/map_drawer.py).

Map points as black dots, the current local points in red (MapDrawer.cc
DrawMapPoints), keyframes as blue dots with a heading tick (DrawKeyFrames),
the covisibility graph, spanning tree and loop edges (DrawGraph), and the
current camera in green (DrawCurrentCamera), as an orthographic x-z view:
the plane of a wheeled robot's map and of the occupancy grid. Reads a map
store's host arrays (`mp_pos`, `mp_valid`, `kf_valid`, `kf_R`, `kf_t`,
`covis`, and `kf_parent` / `kf_loop_edges` where a store has them).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .draw import draw_line, draw_points, draw_text

BLACK = (15, 15, 15)
RED = (230, 40, 40)
BLUE = (40, 80, 230)
GREEN = (0, 180, 0)
LGREEN = (140, 220, 140)


class MapDrawer:
    def __init__(self, width: int = 900, height: int = 900, margin: float = 0.08):
        self.width = width
        self.height = height
        self.margin = margin

    # ------------------------------------------------------------------
    def _fit(self, pts_xz: np.ndarray) -> Tuple[float, float, float]:
        """World x-z window -> (scale px/m, x0, z0)."""
        if len(pts_xz) == 0:
            return 1.0, -1.0, -1.0
        lo = pts_xz.min(axis=0)
        hi = pts_xz.max(axis=0)
        span = np.maximum(hi - lo, 1e-3)
        m = self.margin
        sx = self.width * (1 - 2 * m) / span[0]
        sz = self.height * (1 - 2 * m) / span[1]
        s = min(sx, sz)
        return s, lo[0] - m * span[0], lo[1] - m * span[1]

    def _to_px(self, xz: np.ndarray, s: float, x0: float, z0: float) -> np.ndarray:
        # z grows upward in the image (row 0 = max z)
        px = (xz[..., 0] - x0) * s
        py = self.height - 1 - (xz[..., 1] - z0) * s
        return np.stack([px, py], axis=-1)

    # ------------------------------------------------------------------
    def render(
        self,
        map_store,
        cur_pose: Optional[Tuple[np.ndarray, np.ndarray]] = None,  # (R, t) Tcw
        local_ids: Optional[np.ndarray] = None,
        draw_graph: bool = True,
        covis_min_weight: int = 100,
    ) -> np.ndarray:
        m = map_store
        img = np.full((self.height, self.width, 3), 255, np.uint8)

        pts = m.mp_pos[m.mp_valid]
        kf_ids = np.nonzero(m.kf_valid)[0]
        centers = np.stack(
            [-(m.kf_R[k].T @ m.kf_t[k]) for k in kf_ids], axis=0
        ) if len(kf_ids) else np.zeros((0, 3), np.float32)

        all_xz = np.concatenate([pts[:, [0, 2]], centers[:, [0, 2]]], axis=0) \
            if len(pts) or len(centers) else np.zeros((0, 2))
        if cur_pose is not None:
            R, t = cur_pose
            cam = (-(np.asarray(R).T @ np.asarray(t)))[None, [0, 2]]
            all_xz = np.concatenate([all_xz, cam], axis=0)
        s, x0, z0 = self._fit(all_xz)

        # map points (DrawMapPoints :43-83)
        if len(pts):
            draw_points(img, self._to_px(pts[:, [0, 2]], s, x0, z0), BLACK, size=1)
        if local_ids is not None and len(local_ids):
            ids = np.asarray(local_ids)
            ids = ids[(ids >= 0) & m.mp_valid[np.clip(ids, 0, None)]]
            lp = m.mp_pos[ids]
            draw_points(img, self._to_px(lp[:, [0, 2]], s, x0, z0), RED, size=1)

        # covisibility graph / spanning tree / loop edges (DrawGraph :144-196)
        if draw_graph and len(kf_ids):
            cpx = self._to_px(centers[:, [0, 2]], s, x0, z0)
            slot = {int(k): i for i, k in enumerate(kf_ids)}
            cw = m.covis
            for i, k in enumerate(kf_ids):
                nbrs = np.nonzero(cw[k] >= covis_min_weight)[0]
                for nb in nbrs:
                    if nb > k and int(nb) in slot:
                        j = slot[int(nb)]
                        draw_line(img, cpx[i, 0], cpx[i, 1], cpx[j, 0], cpx[j, 1], LGREEN)
            parents = getattr(m, "kf_parent", None)
            if parents is not None:
                for i, k in enumerate(kf_ids):
                    p = int(parents[k])
                    if p >= 0 and p in slot:
                        j = slot[p]
                        draw_line(img, cpx[i, 0], cpx[i, 1], cpx[j, 0], cpx[j, 1], GREEN)
            loop_edges = getattr(m, "kf_loop_edges", None)
            if loop_edges is not None:
                for i, k in enumerate(kf_ids):
                    for nb in np.nonzero(loop_edges[k])[0]:
                        if nb > k and int(nb) in slot:
                            j = slot[int(nb)]
                            draw_line(img, cpx[i, 0], cpx[i, 1], cpx[j, 0], cpx[j, 1], RED)

        # keyframe glyphs (DrawKeyFrames :85-142): dot + heading tick
        for i, k in enumerate(kf_ids):
            c = centers[i, [0, 2]]
            px = self._to_px(c, s, x0, z0)
            draw_points(img, px[None], BLUE, size=2)
            fwd = m.kf_R[k].T @ np.array([0, 0, 1.0])  # camera z axis in world
            tip = self._to_px(c + 0.6 * fwd[[0, 2]], s, x0, z0)
            draw_line(img, px[0], px[1], tip[0], tip[1], BLUE)

        # current camera (DrawCurrentCamera :198-236)
        if cur_pose is not None:
            R, t = np.asarray(cur_pose[0]), np.asarray(cur_pose[1])
            c = -(R.T @ t)
            px = self._to_px(c[[0, 2]], s, x0, z0)
            draw_points(img, px[None], GREEN, size=3)
            fwd = R.T @ np.array([0, 0, 1.0])
            tip = self._to_px(c[[0, 2]] + 1.2 * fwd[[0, 2]], s, x0, z0)
            draw_line(img, px[0], px[1], tip[0], tip[1], GREEN)

        draw_text(img, f"KFS: {len(kf_ids)}  MPS: {len(pts)}", 6, 6, (60, 60, 60))
        return img
