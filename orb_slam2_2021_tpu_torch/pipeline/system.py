"""System facade (counterpart of orb_slam2_2021_tpu/pipeline/system.py).

Synchronous stereo SLAM at the reference's defaults: the packaged
vocabulary, mapping and loop closing on. Per frame, one upload of the uint8
pair, the frame build on the device, tracking against the shared host
MapStore, then local mapping of any new keyframe (which hands it to loop
closing) and the occupancy grid, inline; a closed loop makes the grid
replay. Maps save to and boot from a map file. What is not ported yet raises
NotImplementedError (see ROADMAP.md): async mode, monocular and RGB-D input,
localization-only mode, the dense local BA.
"""

from __future__ import annotations

import time
from typing import List, Optional

import numpy as np
import torch

from orb_slam2_2021_tpu.config import SlamConfig
from orb_slam2_2021_tpu.mapping.map_store import MapStore

from ..convert import desc_from_numpy
from ..frontend.frame import build_stereo_frame_from_u8
from ..gridmap.grid import GridMapper
from ..place.bundle import PlaceRecognition
from .local_mapping import LocalMapping
from .loop_closing import LoopClosing
from .tracking import Tracking, TrackState


class System:
    def __init__(self, cfg: SlamConfig, enable_mapping: bool = True,
                 enable_loop_closing: bool = True, vocab_path: Optional[str] = None,
                 place_rec: Optional[PlaceRecognition] = None,
                 sensor: str = "stereo", async_mode: bool = False, device="cpu"):
        """Load the vocabulary (the packaged one unless `vocab_path` or
        `place_rec` is given), create the map and keyframe database, and wire
        Tracking -> LocalMapping -> LoopClosing."""
        if async_mode:
            raise NotImplementedError("async mode is not ported yet (ROADMAP.md queue 1, step 11)")
        if sensor != "stereo":
            raise NotImplementedError(f"sensor {sensor!r} is not ported yet (ROADMAP.md queue 1, step 10)")
        self.cfg = cfg
        self.device = torch.device(device)
        self.map = MapStore(cfg)
        if place_rec is None:
            if vocab_path is not None:
                place_rec = PlaceRecognition.from_file(vocab_path, self.device)
            else:
                place_rec = PlaceRecognition.load_default(self.device)
        self.place = place_rec
        self.local_mapper = LocalMapping(cfg, self.map, self.device) if enable_mapping else None
        self.loop_closer = None
        if enable_mapping and enable_loop_closing and self.place is not None:
            self.loop_closer = LoopClosing(cfg, self.map, self.place.kfdb, self.device)
            self.loop_closer.local_mapper = self.local_mapper
            self.local_mapper.loop_closer = self.loop_closer
        self.tracker = Tracking(cfg, self.map, self.device, local_mapper=self.local_mapper,
                                place_rec=self.place)
        if self.place is not None:
            # culled keyframes leave the retrieval index
            self.map.on_kf_erased = self.place.kfdb.erase
        self.grid_mapper = GridMapper(cfg, self.map, self.device) if enable_mapping else None
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
        if self.loop_closer is not None:
            self.loop_closer.request_reset()
        if self.place is not None:
            self.place.kfdb.clear()
        with self.map.lock:
            self.map.clear()
            self.tracker.reset()
            if self.grid_mapper is not None:
                self.grid_mapper.process_new(loop_closed=True)  # clears the grid
        self._reset_requested = False

    def _post_track(self):
        """Local mapping (and loop closing) of the keyframes queued by this
        frame, then the occupancy grid, replayed after a closed loop."""
        if self.local_mapper is not None:
            self.local_mapper.process_pending()
        if self.grid_mapper is not None:
            loop_closed = bool(self.loop_closer and self.loop_closer.loop_closed_flag)
            if loop_closed:
                self.loop_closer.loop_closed_flag = False
            self.grid_mapper.process_new(loop_closed)

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

    def save_map(self, path: str):
        """System::SaveMap: drain mapping, then write the map file."""
        from orb_slam2_2021_tpu.io.persistence import save_map

        if self.local_mapper is not None:
            self.local_mapper.finish()
        save_map(path, self.map, next_frame_id=self._frame_id)

    @classmethod
    def from_map_file(cls, cfg: SlamConfig, path: str, **kwargs):
        """Boot from a map file: restore the map, recompute every keyframe's
        BoW words on the device against the loaded vocabulary, and start
        LOST so the first frame relocalizes."""
        from orb_slam2_2021_tpu.io.persistence import load_map

        sys_ = cls(cfg, **kwargs)
        m, next_frame_id = load_map(path, cfg)
        sys_.map = m
        sys_.tracker.map = m
        if sys_.local_mapper is not None:
            sys_.local_mapper.map = m
        if sys_.loop_closer is not None:
            sys_.loop_closer.map = m
        if sys_.grid_mapper is not None:
            sys_.grid_mapper.map = m
            sys_.grid_mapper.process_new(loop_closed=True)
        sys_._frame_id = next_frame_id
        if sys_.place is not None:
            for k in np.nonzero(m.kf_valid)[0]:
                words = sys_.place.transform(desc_from_numpy(m.kf_desc[int(k)], sys_.device),
                                             torch.from_numpy(m.kf_feat_valid[int(k)]).to(sys_.device))
                sys_.place.kfdb.add(int(k), words.cpu().numpy())
        tr = sys_.tracker
        tr.state = TrackState.LOST
        tr.ref_kf = int(np.nonzero(m.kf_valid)[0][-1]) if m.n_kf else -1
        tr.last_pose = (m.kf_R[tr.ref_kf].copy(), m.kf_t[tr.ref_kf].copy()) if tr.ref_kf >= 0 else None
        tr._bind_cur = np.full(cfg.orb.n_features, -1, np.int64)
        return sys_

    def shutdown(self):
        """Drain the mapping queue (and with it loop closing) and the grid;
        nothing runs in the background in synchronous mode. Then wait for
        the device."""
        if self.local_mapper is not None:
            self.local_mapper.finish()
        if self.grid_mapper is not None:
            self._post_track()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
