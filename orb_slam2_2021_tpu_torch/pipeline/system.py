"""System facade for the stereo tracking lane (counterpart of
orb_slam2_2021_tpu/pipeline/system.py).

Synchronous stereo tracking with mapping off: per frame, one upload of the
uint8 pair, the frame build on the device, then tracking against the shared
host MapStore. What is not ported yet raises NotImplementedError (see
ROADMAP.md): local mapping and loop closing, place recognition, async mode,
monocular and RGB-D input, localization-only mode.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from orb_slam2_2021_tpu.config import SlamConfig
from orb_slam2_2021_tpu.mapping.map_store import MapStore

from ..frontend.frame import build_stereo_frame_from_u8
from .tracking import Tracking


class System:
    def __init__(self, cfg: SlamConfig, enable_mapping: bool = True,
                 place_rec=None, sensor: str = "stereo", async_mode: bool = False,
                 device="cpu"):
        if enable_mapping:
            raise NotImplementedError(
                "local mapping is not ported yet: use enable_mapping=False (ROADMAP.md queue 1, step 8)")
        if async_mode:
            raise NotImplementedError("async mode is not ported yet (ROADMAP.md queue 1, step 11)")
        if sensor != "stereo":
            raise NotImplementedError(f"sensor {sensor!r} is not ported yet (ROADMAP.md queue 1, step 10)")
        if place_rec is not None:
            raise NotImplementedError("place recognition is not ported yet (ROADMAP.md queue 1, step 6)")
        self.cfg = cfg
        self.device = torch.device(device)
        self.map = MapStore(cfg)
        self.tracker = Tracking(cfg, self.map, self.device)
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
        with self.map.lock:
            self.map.clear()
            self.tracker.reset()
        self._reset_requested = False

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
        self.frame_times.append(t2 - t0)
        self._collect_metrics(timestamp, t0, t1, t2)
        self._frame_id += 1
        return pose

    def _collect_metrics(self, timestamp, t0, t_extract, t_end):
        """The tracker's per-frame record plus host-clock stage times (ms).
        The frame build is enqueued asynchronously, so on a GPU ms_extract is
        its launch time and ms_track includes the wait for it."""
        rec = self.tracker.last_metrics
        if rec is None:
            return
        rec = dict(rec)
        rec["timestamp"] = float(timestamp)
        rec["ms_extract"] = 1e3 * (t_extract - t0)
        rec["ms_track"] = 1e3 * (t_end - t_extract)
        rec["ms_mapping"] = 0.0
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

    def activate_localization_mode(self):
        raise NotImplementedError("localization mode is not ported yet (ROADMAP.md queue 1)")

    def save_metrics_ndjson(self, path: str) -> int:
        from orb_slam2_2021_tpu.io.metrics import write_ndjson

        return write_ndjson(path, self.metrics)

    def shutdown(self):
        """Nothing runs in the background in synchronous mode; wait for the
        device so every frame's work has finished."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
