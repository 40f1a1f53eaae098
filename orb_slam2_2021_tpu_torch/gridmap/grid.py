"""Occupancy grid: ray-cast counter updates and rendering (counterpart of
orb_slam2_2021_tpu/gridmap/grid.py).

`visit` counts every cell a camera->point ray crosses (once per ray),
`occupied` counts the point's cell. Each ray is sampled at RAY_STEPS uniform
fractions and all (ray, sample) cells are added in one `index_add_` (integer
atomics on the card, so the counts are deterministic). Rendering follows
BuildOccupancyGridMsg: int8 cells, -1 unknown, 0 free, 100 occupied.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

RAY_STEPS = 256  # samples per ray; >= grid diagonal in cells per ray

# The reference's jnp.linspace(0, 1, 256) in float32, bit for bit (numpy's
# and torch's linspace differ from it in 126 of the 256 fractions).
_FRACTIONS = np.arange(RAY_STEPS, dtype=np.float32) * np.float32(1.0 / (RAY_STEPS - 1))


class OccupancyGrid(NamedTuple):
    """nav_msgs/OccupancyGrid equivalent payload."""
    data: np.ndarray       # [H, W] int8: -1 unknown / 0 free / 100 occupied
    resolution: float      # meters per cell
    origin_x: float        # world x of cell (0, 0)
    origin_z: float


def raycast_update(visit, occupied, cam_xz, pts_xz, valid):
    """Accumulate one keyframe's rays into the [H, W] int32 counters, in
    place. cam_xz [2] and pts_xz [P, 2] are (x, z) in grid cells (float32),
    valid [P] bool. Returns (visit, occupied)."""
    H, W = visit.shape
    P = pts_xz.shape[0]
    f = torch.from_numpy(_FRACTIONS).to(pts_xz.device)[None, :, None]       # [1,S,1]
    line = cam_xz[None, None, :] + (pts_xz[:, None, :] - cam_xz[None, None, :]) * f
    cells = torch.round(line).to(torch.int32)                                 # [P,S,2]
    cx = torch.clamp(cells[..., 0], 0, W - 1)
    cz = torch.clamp(cells[..., 1], 0, H - 1)
    flat = (cz * W + cx).long()                                               # [P,S]
    # visit once per ray: drop samples that repeat the previous cell
    first = torch.cat([torch.ones((P, 1), dtype=torch.bool, device=flat.device),
                       flat[:, 1:] != flat[:, :-1]], dim=1)
    w = (first & valid[:, None]).to(torch.int32)
    visit.view(-1).index_add_(0, flat.reshape(-1), w.reshape(-1))
    occupied.view(-1).index_add_(0, flat[:, -1], valid.to(torch.int32))
    return visit, occupied


def render_grid(visit, occupied, cfg):
    """Counters -> int8 occupancy values (BuildOccupancyGridMsg)."""
    v = visit.cpu().numpy() if isinstance(visit, torch.Tensor) else np.asarray(visit)
    o = occupied.cpu().numpy() if isinstance(occupied, torch.Tensor) else np.asarray(occupied)
    out = np.full(v.shape, -1, np.int8)
    seen = v > cfg.visit_th
    ratio = np.where(seen, o / np.maximum(v, 1), 0.0)
    out[seen & (ratio >= cfg.occ_th)] = 100
    out[seen & ((1.0 - ratio) >= cfg.free_th)] = 0
    return out


class GridMapper:
    """Grid counters on the device, fed one keyframe at a time from the
    shared host map store."""

    def __init__(self, cfg, map_store, device):
        self.cfg = cfg
        self.map = map_store
        self.device = torch.device(device)
        g = cfg.gridmap
        # grid centre at the world origin
        self.origin_x = -g.size_x / (2.0 * g.scale)
        self.origin_z = -g.size_z / (2.0 * g.scale)
        self.processed = []
        self._next_kf = 0  # monotone keyframe-id cursor for incremental updates
        self._zero_counters()

    def _zero_counters(self):
        g = self.cfg.gridmap
        self.visit = torch.zeros((g.size_z, g.size_x), dtype=torch.int32, device=self.device)
        self.occupied = torch.zeros_like(self.visit)

    def _world_to_cells(self, xz: np.ndarray) -> np.ndarray:
        g = self.cfg.gridmap
        return np.stack(
            [(xz[..., 0] - self.origin_x) * g.scale, (xz[..., 1] - self.origin_z) * g.scale],
            axis=-1,
        ).astype(np.float32)

    def update_kf(self, k: int):
        """UpdateGridMap: rays from keyframe k's centre to its points."""
        if not self.map.kf_valid[k]:
            return
        P = self.cfg.gridmap.max_points_per_kf
        mp = self.map.kf_mp[k]
        ids = mp[mp >= 0]
        ids = ids[self.map.mp_valid[ids]][:P]
        if len(ids) == 0:
            return
        R, t = self.map.kf_R[k], self.map.kf_t[k]
        cam_xz = self._world_to_cells((-R.T @ t)[[0, 2]])
        pts_xz = np.zeros((P, 2), np.float32)
        pts_xz[: len(ids)] = self._world_to_cells(self.map.mp_pos[ids][:, [0, 2]])
        pts_xz[len(ids):] = cam_xz  # padded rays collapse to the camera cell
        valid = np.zeros(P, bool)
        valid[: len(ids)] = True
        raycast_update(self.visit, self.occupied, torch.from_numpy(cam_xz).to(self.device),
                       torch.from_numpy(pts_xz).to(self.device),
                       torch.from_numpy(valid).to(self.device))
        self.processed.append(k)

    def process_new(self, loop_closed: bool = False):
        """Rebuild everything after a loop closure or a reset, else ingest the
        keyframes created since the last call (GridMapping::Run)."""
        if loop_closed:
            self.reset_and_replay()
            self._next_kf = self.map.next_kf
            return
        while self._next_kf < self.map.next_kf:
            k = self._next_kf
            self._next_kf += 1
            if self.map.kf_valid[k]:
                self.update_kf(k)

    def reset_and_replay(self):
        """ResetGridMap and a replay of every live keyframe."""
        self._zero_counters()
        self.processed = []
        for k in np.nonzero(self.map.kf_valid)[0]:
            self.update_kf(int(k))

    def occupancy_grid(self) -> OccupancyGrid:
        g = self.cfg.gridmap
        return OccupancyGrid(
            data=render_grid(self.visit, self.occupied, g),
            resolution=1.0 / g.scale,
            origin_x=self.origin_x,
            origin_z=self.origin_z,
        )

    def point_cloud(self) -> np.ndarray:
        """Live map points as [N, 3] float32 (ConvertToPCL)."""
        return self.map.mp_pos[self.map.mp_valid].copy()
