"""Offline saved-map post-processing, the upstream gridmapper tool
(counterpart of orb_slam2_2021_tpu/tools/map_processor.py).

Loads a saved map file (the format of `io.persistence`), drops statistical
outliers from the point cloud (PCL's StatisticalOutlierRemoval), exports
the point cloud and the keyframe trajectory, and rasterizes a PGM occupancy
grid by replaying every saved keyframe through the engine's grid mapper.

The outlier filter is a kNN by `topk` over pairwise squared distances on
the device, computed in blocks of rows so that a map of a long drive fits
(KITTI 00 holds about 487,556 points: its whole [N, N] float32 matrix would
be 950 GB). Everything else is host-side numpy.

CLI (the SlamConfig() defaults, with the map file's features per keyframe):
  python -m orb_slam2_2021_tpu_torch.tools.map_processor <map.npz> [out_dir] [--device cpu]
"""

from __future__ import annotations

import dataclasses
import os
import sys
from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..config import SlamConfig
from ..io.persistence import load_map

# byte budget of one block's [B, N] float32 distance matrix
SOR_BLOCK_BYTES = 2 << 30


def sor_block_rows(n: int) -> int:
    """Rows per block: the most whose [B, n] float32 matrix fits
    SOR_BLOCK_BYTES (at least 1)."""
    return max(1, min(n, SOR_BLOCK_BYTES // (4 * max(n, 1))))


def mean_knn_distances(p: torch.Tensor, k: int, block_rows: Optional[int] = None) -> torch.Tensor:
    """Mean Euclidean distance of each point of p [N, 3] float32 to its k
    nearest other points, [N] float32 on p's device (no host sync):
    d2 = |p_i|^2 + |p_j|^2 - 2<p_i, p_j> clamped at 0, the diagonal
    excluded, the k smallest by `topk`, then the mean of their square
    roots. Rows go in blocks of `block_rows` (default: the byte budget's).

    Every product and sum of d2 is a separate elementwise op in a fixed
    order, each rounded once: d2 is then the same bits on the CPU and the
    card and in any block (a matrix product's rounding follows its kernel,
    and far from the origin the expansion's cancellation magnifies it)."""
    n = p.shape[0]
    b = block_rows or sor_block_rows(n)
    x, y, z = p.t().contiguous()
    sq = (x * x + y * y) + z * z
    out = torch.empty(n, dtype=torch.float32, device=p.device)
    for s in range(0, n, b):
        e = min(s + b, n)
        ip = x[s:e, None] * x[None, :]
        tmp = y[s:e, None] * y[None, :]
        ip += tmp
        torch.mul(z[s:e, None], z[None, :], out=tmp)
        ip += tmp
        del tmp
        d2 = sq[s:e, None] + sq[None, :]
        d2.sub_(ip, alpha=2.0)  # 2 * ip is exact: one rounding, fused or not
        del ip
        rows = torch.arange(e - s, device=p.device)
        d2[rows, rows + s] = float("inf")
        # clamping after the selection keeps the same k values (monotone)
        near = torch.topk(d2, k, dim=1, largest=False).values
        del d2
        out[s:e] = near.clamp_min_(0.0).sqrt_().mean(dim=1)
    return out


def statistical_outlier_filter(points: np.ndarray, k: int = 50, std_ratio: float = 1.0,
                               device="cuda") -> np.ndarray:
    """PCL StatisticalOutlierRemoval semantics (setMeanK/setStddevMulThresh,
    gridmapper defaults 50/1.0): drop points whose mean distance to their k
    nearest neighbors exceeds global_mean + std_ratio * global_std.
    Runs on `device` (the card unless the caller says otherwise); returns
    a boolean keep-mask [N] (numpy)."""
    dev = resolve_device(device)
    n = len(points)
    if n == 0:
        return np.zeros(0, bool)
    k = min(k, n - 1)
    if k <= 0:
        return np.ones(n, bool)
    p = torch.from_numpy(np.ascontiguousarray(points, np.float32)).to(dev)
    md = mean_knn_distances(p, k).cpu().numpy()
    mu, sd = float(md.mean()), float(md.std())
    return md <= mu + std_ratio * sd


class MapProcessor:
    def __init__(self, map_path: str, cfg: Optional[SlamConfig] = None, device="cuda"):
        """Load the map file at `map_path`. The filter and the grid replay
        run on `device`: the card unless the caller says otherwise; a CUDA
        device without a card raises."""
        self.cfg = cfg or SlamConfig()
        self.device = resolve_device(device)
        self.map, self.next_frame_id = load_map(map_path, self.cfg)

    # ------------------------------------------------------------------
    def point_cloud(self, filtered: bool = True, k: int = 50,
                    std_ratio: float = 1.0) -> np.ndarray:
        pts = self.map.mp_pos[self.map.mp_valid]
        if filtered and len(pts):
            pts = pts[statistical_outlier_filter(pts, k, std_ratio, self.device)]
        return pts

    def keyframe_trajectory(self) -> np.ndarray:
        """[K, 8]: timestamp + TUM pose (tx ty tz qx qy qz qw) per KF."""
        from ..geometry.so3 import rot_to_quat

        ks = np.nonzero(self.map.kf_valid)[0]
        if len(ks) == 0:
            return np.zeros((0, 8))
        Rwc = np.ascontiguousarray(self.map.kf_R[ks].transpose(0, 2, 1), np.float32)
        qs = rot_to_quat(torch.from_numpy(Rwc)).numpy()  # (w, x, y, z)
        rows = []
        for k, q in zip(ks, qs):
            R, t = self.map.kf_R[k], self.map.kf_t[k]
            twc = -R.T @ t
            rows.append([self.map.kf_timestamp[k], *twc, q[1], q[2], q[3], q[0]])
        return np.asarray(rows)

    # ------------------------------------------------------------------
    def save_point_cloud_ply(self, path: str, filtered: bool = True):
        """ASCII PLY export (the upstream tool exports PCD through PCL)."""
        pts = self.point_cloud(filtered)
        with open(path, "w") as f:
            f.write("ply\nformat ascii 1.0\n")
            f.write(f"element vertex {len(pts)}\n")
            f.write("property float x\nproperty float y\nproperty float z\n")
            f.write("end_header\n")
            for x, y, z in pts:
                f.write(f"{x:.6f} {y:.6f} {z:.6f}\n")

    def save_trajectory_tum(self, path: str):
        rows = self.keyframe_trajectory()
        with open(path, "w") as f:
            for r in rows:
                f.write(" ".join(f"{v:.6f}" for v in r) + "\n")

    def save_grid_map_pgm(self, path: str, filtered: bool = True,
                          scale: Optional[float] = None):
        """Occupancy-grid PGM from the saved map (the upstream
        SaveGridMapKITTI): replay every keyframe's rays through the grid
        mapper on the device, then write free=254 / occupied=0 /
        unknown=205 (the ROS map_saver encoding). Returns the grid."""
        from ..gridmap.grid import GridMapper
        from ..viz.draw import write_pgm

        cfg = self.cfg
        if scale is not None:
            cfg = cfg.replace(gridmap=cfg.gridmap.__class__(
                **{**cfg.gridmap.__dict__, "scale": scale}))
        gm = GridMapper(cfg, self.map, self.device)
        if filtered:
            keep = statistical_outlier_filter(self.map.mp_pos[self.map.mp_valid],
                                              device=self.device)
            # mask the outliers out of the store for the replay
            valid_backup = self.map.mp_valid.copy()
            idx = np.nonzero(self.map.mp_valid)[0]
            self.map.mp_valid[idx[~keep]] = False
            try:
                gm.reset_and_replay()
            finally:
                self.map.mp_valid[:] = valid_backup
        else:
            gm.reset_and_replay()
        grid = gm.occupancy_grid()
        img = np.full(grid.data.shape, 205, np.uint8)
        img[grid.data == 0] = 254
        img[grid.data == 100] = 0
        write_pgm(path, img)
        return grid


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    device = "cuda"
    if "--device" in argv:
        i = argv.index("--device")
        if i + 1 >= len(argv):
            raise SystemExit("--device takes a value: cuda or cpu")
        device = argv[i + 1]
        del argv[i:i + 2]
    if not argv:
        raise SystemExit(__doc__)
    map_path = argv[0]
    out_dir = argv[1] if len(argv) > 1 else "."
    os.makedirs(out_dir, exist_ok=True)
    cfg = SlamConfig()
    with np.load(map_path) as z:  # the map's keyframe width, whatever config saved it
        n_features = int(z["kf_xy"].shape[1])
    cfg = cfg.replace(orb=dataclasses.replace(cfg.orb, n_features=n_features))
    mp = MapProcessor(map_path, cfg, device=device)
    n_kf = int(mp.map.kf_valid.sum())
    n_mp = int(mp.map.mp_valid.sum())
    print(f"loaded map: {n_kf} keyframes, {n_mp} map points")
    mp.save_point_cloud_ply(os.path.join(out_dir, "pointcloud.ply"))
    mp.save_trajectory_tum(os.path.join(out_dir, "kf_trajectory_tum.txt"))
    mp.save_grid_map_pgm(os.path.join(out_dir, "gridmap.pgm"))
    print(f"wrote pointcloud.ply / kf_trajectory_tum.txt / gridmap.pgm to {out_dir}")


if __name__ == "__main__":
    main()
