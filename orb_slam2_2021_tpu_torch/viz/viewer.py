"""Viewer: the frame overlay and the map view of the port's System, headless
(counterpart of orb_slam2_2021_tpu/viz/viewer.py).

The upstream Viewer thread polls FrameDrawer and MapDrawer at the camera
rate and shows them in Pangolin and OpenCV windows. Here `update()` is
called after each tracked frame (drawing every `stride`-th), renders the
same content to numpy images, writes PNGs to `out_dir` if given, and
publishes them on a message bus (topic "os2_viz") if given.

In async mode the mapping worker writes the map store in place, so each
update copies what the drawers read under the map lock and draws outside
it: the keyframe rows up to `next_kf`, the map-point rows up to `next_mp`
and covisibility's [next_kf, next_kf] corner, not the store's whole
capacity (no id at or past those counters is valid); `lock_holds` keeps the
seconds each copy held the lock. A synchronous System's map is drawn as it
stands.
"""

from __future__ import annotations

import os
import time
from types import SimpleNamespace
from typing import List, Optional

import numpy as np

from .draw import write_png
from .frame_drawer import FrameDrawer
from .map_drawer import MapDrawer

# the port's map-store arrays the drawers read, by the counter that bounds
# their rows in use
_KF_ARRAYS = ("kf_valid", "kf_R", "kf_t")
_MP_ARRAYS = ("mp_pos", "mp_valid")


class Viewer:
    def __init__(
        self,
        system,
        out_dir: Optional[str] = None,
        stride: int = 1,
        map_size: int = 720,
        bus=None,
    ):
        self.system = system
        self.out_dir = out_dir
        self.stride = max(1, stride)
        self.frame_drawer = FrameDrawer(system.cfg)
        self.map_drawer = MapDrawer(width=map_size, height=map_size)
        self.bus = bus
        self.lock_holds: List[float] = []
        self._count = 0
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)

    def _map_view(self):
        """The map as the drawers read it: the store itself in sync mode, a
        copy taken under the map lock in async mode."""
        m = self.system.map
        if not self.system.async_mode:
            return m
        with m.lock:
            t0 = time.perf_counter()
            nk, nm = m.next_kf, m.next_mp
            snap = SimpleNamespace(
                n_kf=m.n_kf, covis=m.covis[:nk, :nk].copy(),
                **{k: getattr(m, k)[:nk].copy() for k in _KF_ARRAYS},
                **{k: getattr(m, k)[:nm].copy() for k in _MP_ARRAYS})
            self.lock_holds.append(time.perf_counter() - t0)
        return snap

    def update(self, image: Optional[np.ndarray] = None):
        """Render the current state; `image` is the frame just tracked.
        Returns (frame image or None, map image), or None between strides."""
        self._count += 1
        if (self._count - 1) % self.stride:
            return None
        sys_ = self.system
        map_view = self._map_view()
        frame_img = None
        if image is not None:
            with sys_._lane():  # the last frame's host pull, ordered after the lane's work
                frame_img = self.frame_drawer.draw_from_system(sys_, image, map_view)
        map_img = self.map_drawer.render(map_view, cur_pose=sys_.tracker.last_pose)

        if self.out_dir:
            idx = self._count - 1
            if frame_img is not None:
                write_png(os.path.join(self.out_dir, f"frame_{idx:06d}.png"), frame_img)
            write_png(os.path.join(self.out_dir, f"map_{idx:06d}.png"), map_img)
        if self.bus is not None:
            self.bus.publish("os2_viz", {"frame": frame_img, "map": map_img})
        return frame_img, map_img
