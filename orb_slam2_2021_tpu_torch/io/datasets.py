"""The port's own copy of orb_slam2_2021_tpu/io/datasets.py: plain Python
and numpy (PIL when it is installed), the same frame order, timestamps and
dtypes.

Dataset loaders for the KITTI odometry and TUM RGB-D directory layouts
(the example loader of upstream ORB-SLAM2's drivers: a timestamp file and
image directories). KITTI sequences come rectified; undistortion of raw
cameras lives in ops/undistort.
"""

from __future__ import annotations

import os
from typing import Iterator, Optional, Tuple

import numpy as np


def _load_gray(path: str) -> np.ndarray:
    """Minimal PNG/PGM loader via PIL if present, else raw pgm."""
    try:
        from PIL import Image

        return np.asarray(Image.open(path).convert("L"), np.float32)
    except ImportError:
        if path.endswith(".pgm"):
            with open(path, "rb") as f:
                assert f.readline().strip() == b"P5"
                line = f.readline()
                while line.startswith(b"#"):
                    line = f.readline()
                w, h = map(int, line.split())
                maxv = int(f.readline())
                data = np.frombuffer(f.read(), np.uint8 if maxv < 256 else ">u2")
                return data.reshape(h, w).astype(np.float32)
        raise RuntimeError(f"no PIL available to load {path}")


class KittiStereoSequence:
    """KITTI odometry layout: sequence dir with image_0/, image_1/, times.txt."""

    def __init__(self, seq_dir: str, max_frames: Optional[int] = None):
        self.dir = seq_dir
        with open(os.path.join(seq_dir, "times.txt")) as f:
            self.times = [float(x) for x in f.read().split()]
        self.left_dir = os.path.join(seq_dir, "image_0")
        self.right_dir = os.path.join(seq_dir, "image_1")
        names = sorted(os.listdir(self.left_dir))
        if max_frames:
            names = names[:max_frames]  # the drivers' `--reduced` mode
        self.names = names

    def __len__(self):
        return len(self.names)

    def __iter__(self) -> Iterator[Tuple[float, np.ndarray, np.ndarray]]:
        for i, name in enumerate(self.names):
            left = _load_gray(os.path.join(self.left_dir, name))
            right = _load_gray(os.path.join(self.right_dir, name))
            yield self.times[i], left, right


class TumRgbdSequence:
    """TUM RGB-D layout: rgb.txt / depth.txt with associated timestamps."""

    def __init__(self, seq_dir: str, depth_scale: float = 1.0 / 5000.0,
                 max_frames: Optional[int] = None):
        self.dir = seq_dir
        self.depth_scale = depth_scale

        def parse(fname):
            out = []
            with open(os.path.join(seq_dir, fname)) as f:
                for line in f:
                    if line.startswith("#"):
                        continue
                    ts, path = line.split()[:2]
                    out.append((float(ts), path))
            return out

        rgb = parse("rgb.txt")
        depth = parse("depth.txt")
        # nearest-timestamp association (standard TUM association tooling)
        pairs = []
        di = 0
        for ts, rp in rgb:
            while di + 1 < len(depth) and abs(depth[di + 1][0] - ts) < abs(depth[di][0] - ts):
                di += 1
            if abs(depth[di][0] - ts) < 0.02:
                pairs.append((ts, rp, depth[di][1]))
        if max_frames:
            pairs = pairs[:max_frames]
        self.pairs = pairs

    def __len__(self):
        return len(self.pairs)

    def __iter__(self):
        for ts, rp, dp in self.pairs:
            rgb = _load_gray(os.path.join(self.dir, rp))
            depth = _load_gray(os.path.join(self.dir, dp)) * self.depth_scale
            yield ts, rgb, depth
