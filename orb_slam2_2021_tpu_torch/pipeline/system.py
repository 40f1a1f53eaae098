"""System facade for the stereo tracking lane (counterpart of
orb_slam2_2021_tpu/pipeline/system.py).

Synchronous stereo SLAM: per frame, one upload of the uint8 pair, the frame
build on the device, tracking against the shared host MapStore, then (with
mapping on) local mapping of any new keyframe and the occupancy grid,
inline. What is not ported yet raises NotImplementedError (see ROADMAP.md):
loop closing, place recognition, async mode, monocular and RGB-D input,
localization-only mode.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from orb_slam2_2021_tpu.config import SlamConfig
from orb_slam2_2021_tpu.mapping.map_store import MapStore

from ..frontend.frame import build_stereo_frame_from_u8
from ..gridmap.grid import GridMapper
from .local_mapping import LocalMapping
from .tracking import Tracking


class System:
    def __init__(self, cfg: SlamConfig, enable_mapping: bool = True,
                 enable_loop_closing: bool = True, place_rec=None,
                 sensor: str = "stereo", async_mode: bool = False, device="cpu"):
        if enable_mapping and enable_loop_closing:
            raise NotImplementedError(
                "loop closing is not ported yet: use enable_loop_closing=False "
                "(ROADMAP.md queue 1, step 9)")
        if async_mode:
            raise NotImplementedError("async mode is not ported yet (ROADMAP.md queue 1, step 11)")
        if sensor != "stereo":
            raise NotImplementedError(f"sensor {sensor!r} is not ported yet (ROADMAP.md queue 1, step 10)")
        if place_rec is not None:
            raise NotImplementedError("place recognition is not ported yet (ROADMAP.md queue 1, step 6)")
        self.cfg = cfg
        self.device = torch.device(device)
        self.map = MapStore(cfg)
        self.local_mapper = LocalMapping(cfg, self.map, self.device) if enable_mapping else None
        self.grid_mapper = GridMapper(cfg, self.map, self.device) if enable_mapping else None
        self.tracker = Tracking(cfg, self.map, self.device, local_mapper=self.local_mapper)
        self.tracker.request_system_reset = self.reset
        self.frame_times: List[float] = []
        self.metrics: List[dict] = []  # per-frame records (io/metrics.py schema)
        self._frame_id = 0
        self._reset_requested = False

    def reset(self):
        """Flag a reset; it runs before the next frame (System::Reset)."""
        self._reset_requested = True

    def _maybe_reset(self):
        if not self._reset_requested:
            return
        if self.local_mapper is not None:
            self.local_mapper.request_reset()
        with self.map.lock:
            self.map.clear()
            self.tracker.reset()
            if self.grid_mapper is not None:
                self.grid_mapper.process_new(loop_closed=True)  # clears the grid
        self._reset_requested = False

    def _post_track(self):
        """Local mapping of the keyframes queued by this frame, then the
        occupancy grid, inline."""
        if self.local_mapper is not None:
            self.local_mapper.process_pending()
        if self.grid_mapper is not None:
            self.grid_mapper.process_new()

    def _pack_stereo_u8(self, image_left, image_right,
                        normalized: Optional[bool] = None) -> np.ndarray:
        """Stack the pair as one [2, H, W] uint8 array. uint8 input passes
        through; float input is 0-255 unless `normalized=True` ([0, 1]); with
        normalized=None a float pair whose max is <= 1 counts as normalized."""
        il = np.asarray(image_left)
        ir = np.asarray(image_right)
        if il.dtype == np.uint8 and ir.dtype == np.uint8:
            return np.stack([il, ir])
        stacked = np.stack([il, ir])
        if normalized or (normalized is None and stacked.max() <= 1.0):
            stacked = stacked * 255.0
        return np.clip(stacked, 0, 255).astype(np.uint8)

    def track_stereo(self, image_left, image_right, timestamp: float = 0.0,
                     normalized: Optional[bool] = None):
        """Per-frame stereo entry (System::TrackStereo). Returns Tcw as
        (R, t) numpy arrays, or None while initializing / lost."""
        self._maybe_reset()
        t0 = time.perf_counter()
        pair = torch.from_numpy(self._pack_stereo_u8(image_left, image_right, normalized))
        frame = build_stereo_frame_from_u8(pair.to(self.device), self.cfg)
        t1 = time.perf_counter()
        with self.map.lock:
            pose = self.tracker.track_stereo_frame(frame, self._frame_id, timestamp)
        t2 = time.perf_counter()
        self._post_track()
        t3 = time.perf_counter()
        self.frame_times.append(t3 - t0)
        self._collect_metrics(timestamp, t0, t1, t2, t3)
        self._frame_id += 1
        return pose

    def _collect_metrics(self, timestamp, t0, t_extract, t_track, t_end):
        """The tracker's per-frame record plus host-clock stage times (ms).
        The frame build is enqueued asynchronously, so on a GPU ms_extract is
        its launch time and ms_track includes the wait for it."""
        rec = self.tracker.last_metrics
        if rec is None:
            return
        rec = dict(rec)
        rec["timestamp"] = float(timestamp)
        rec["ms_extract"] = 1e3 * (t_extract - t0)
        rec["ms_track"] = 1e3 * (t_track - t_extract)
        rec["ms_mapping"] = 1e3 * (t_end - t_track)
        rec["ms_total"] = 1e3 * (t_end - t0)
        self.metrics.append(rec)

    def trajectory_kitti(self) -> List[np.ndarray]:
        return [T for _, T in self.tracker.trajectory()]

    def save_trajectory_kitti(self, path: str):
        from orb_slam2_2021_tpu.io.trajectory import save_kitti

        save_kitti(path, self.trajectory_kitti())

    def timing_stats(self):
        ts = np.asarray(self.frame_times)
        if len(ts) == 0:
            return {}
        return {
            "median_s": float(np.median(ts)),
            "mean_s": float(ts.mean()),
            "fps": float(1.0 / np.median(ts)),
        }

    def occupancy_grid(self):
        """The live occupancy grid, or None with mapping off."""
        if self.grid_mapper is None:
            return None
        return self.grid_mapper.occupancy_grid()

    def point_cloud(self):
        if self.grid_mapper is None:
            return None
        return self.grid_mapper.point_cloud()

    def activate_localization_mode(self):
        raise NotImplementedError("localization mode is not ported yet (ROADMAP.md queue 1)")

    def save_metrics_ndjson(self, path: str) -> int:
        from orb_slam2_2021_tpu.io.metrics import write_ndjson

        return write_ndjson(path, self.metrics)

    def shutdown(self):
        """Drain the mapping queue and the grid (nothing runs in the
        background in synchronous mode), then wait for the device."""
        if self.local_mapper is not None:
            self.local_mapper.finish()
        self._post_track()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
