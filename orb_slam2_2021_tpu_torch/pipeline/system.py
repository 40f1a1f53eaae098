"""System facade (counterpart of orb_slam2_2021_tpu/pipeline/system.py).

SLAM at the reference's defaults: the packaged vocabulary, mapping and loop
closing on, on the card unless the caller passes device="cpu". Three entry
points, one per sensor: `track_stereo` (one upload of the uint8 pair, or a
frame prefetched by `prefetch_stereo`), `track_rgbd` (image and depth map,
the depth divided by the config's DepthMapFactor) and `track_monocular` (one
image; loops then solve for scale); `track_stereo_prefetch` tracks a
prefetched frame and prefetches the next one. Per frame: the frame build on
the device, tracking against the shared host MapStore, then local mapping of
any new keyframe (which hands it to loop closing) and the occupancy grid; a
closed loop makes the grid replay.

Synchronous by default: mapping, loop closing and the grid run inline after
each frame, on the caller's thread. With async_mode=True the reference's
thread layout: tracking on the caller's thread, local mapping with loop
closing and the grid on a worker thread, global BA on an ephemeral thread,
each on a CUDA stream of its own (pipeline/streams.py; the lane's at the
highest priority). An exception on either thread is raised on the caller's
next call or in `shutdown`, which joins both threads and waits for every
stream before anything is read back.

Localization mode tracks against the map without changing it. Maps save to
and boot from a map file; trajectories export in the KITTI and TUM formats;
`profile_dir` records a torch.profiler trace from the first frame to
`shutdown`; `io/trace.py`, when started, records each frame's stages as
spans (`frame`, `build`, `track`, the map lock's `lock.wait` and
`lock.hold`, ...). `cfg.optim.use_cg_local_ba=False` selects the dense local BA.
With `dist_gba` (a `parallel.gba_service.GbaClient`) the loop closer's
global BA runs landmark-sharded over the client's process group, this
process being its rank 0 (the reference's `mesh` and cross-process paths,
folded into one: parallel/dist_ba.py).
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..config import SlamConfig
from ..convert import desc_from_numpy
from ..frontend.frame import Frame, build_mono_frame, build_rgbd_frame, build_stereo_frame_from_u8
from ..gridmap.grid import GridMapper
from ..io import trace
from ..io.metrics import write_ndjson
from ..io.persistence import load_map, save_map
from ..io.trajectory import save_kitti, save_tum
from ..mapping.map_store import MapStore
from ..ops.cuda_build import build_all
from ..ops.hamming import HAMMING_BEST2_KERNEL
from ..optim.pose import POSE_KERNEL
from ..place.bundle import PlaceRecognition
from .local_mapping import LocalMapping
from .loop_closing import LoopClosing
from .streams import DeviceStreams
from .tracking import Tracking, TrackState

JOIN_TIMEOUT_S = 600.0  # a worker or GBA thread not done by then is a fault


class System:
    def __init__(self, cfg: SlamConfig, enable_mapping: bool = True,
                 enable_loop_closing: bool = True, vocab_path: Optional[str] = None,
                 place_rec: Optional[PlaceRecognition] = None,
                 sensor: str = "stereo", async_mode: bool = False,
                 profile_dir: Optional[str] = None, device="cuda", dist_gba=None):
        """Load the vocabulary (the packaged one unless `vocab_path` or
        `place_rec` is given), create the map and keyframe database, and wire
        Tracking -> LocalMapping -> LoopClosing for `sensor` ("stereo",
        "rgbd" or "mono"); with async_mode (and mapping on) start the
        mapping worker. Runs on the card unless `device` says otherwise;
        without a card a CUDA device raises. `dist_gba` (a GbaClient) takes
        the global BA across its process group."""
        if sensor not in ("stereo", "rgbd", "mono"):
            raise ValueError(f"unknown sensor {sensor!r}")
        self.cfg = cfg
        self.sensor = sensor
        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the lane's kernels, one nvcc a source started together, before
            # the first frame (a no-op once built)
            build_all([HAMMING_BEST2_KERNEL, POSE_KERNEL])
        self.map = MapStore(cfg)
        if place_rec is None:
            if vocab_path is not None:
                place_rec = PlaceRecognition.from_file(vocab_path, self.device)
            else:
                place_rec = PlaceRecognition.load_default(self.device)
        self.place = place_rec
        self.local_mapper = LocalMapping(cfg, self.map, self.device) if enable_mapping else None
        if self.local_mapper is not None:
            self.local_mapper.monocular = sensor == "mono"
        self.loop_closer = None
        if enable_mapping and enable_loop_closing and self.place is not None:
            # monocular loops solve for scale drift
            self.loop_closer = LoopClosing(cfg, self.map, self.place.kfdb, self.device,
                                           fix_scale=sensor != "mono")
            self.loop_closer.local_mapper = self.local_mapper
            self.local_mapper.loop_closer = self.loop_closer
            self.loop_closer.dist_gba = dist_gba
        self.tracker = Tracking(cfg, self.map, self.device, local_mapper=self.local_mapper,
                                place_rec=self.place)
        self.tracker.sensor = sensor
        if self.place is not None:
            # culled keyframes leave the retrieval index
            self.map.on_kf_erased = self.place.kfdb.erase
        self.grid_mapper = GridMapper(cfg, self.map, self.device) if enable_mapping else None
        self.tracker.request_system_reset = self.reset
        self.frame_times: List[float] = []
        self.metrics: List[dict] = []  # per-frame records (io/metrics.py schema)
        self._frame_id = 0
        self._reset_requested = False
        # DepthMapFactor: raw depth maps are divided by it to get metres; a
        # factor of 0 or 1 means the depth is already metric
        f = cfg.depth_map_factor
        self._depth_scale = 1.0 if abs(f) < 1e-5 or f == 1.0 else 1.0 / f
        self._profile_dir = profile_dir
        self.profiler = None  # the torch.profiler.profile of profile_dir

        self.async_mode = async_mode and self.local_mapper is not None
        self.streams: Optional[DeviceStreams] = None
        self._worker: Optional[threading.Thread] = None
        if self.async_mode:
            self.streams = DeviceStreams(self.device)
            lm = self.local_mapper
            lm.async_mode, lm.streams, lm.grid_mapper = True, self.streams, self.grid_mapper
            if self.loop_closer is not None:
                self.loop_closer.async_mode, self.loop_closer.streams = True, self.streams
            if self.device.type == "cuda":
                # the vocabulary and the grid were made on this thread's
                # stream; the non-blocking role streams do not wait for it
                torch.cuda.synchronize(self.device)
            self._worker = threading.Thread(target=lm.run_worker, name="mapping", daemon=True)
            self._worker.start()

    def _lane(self):
        """The lane's stream as the current stream (async mode on a card)."""
        return self.streams.enter("lane") if self.streams is not None else contextlib.nullcontext()

    def _raise_thread_error(self):
        """Raise the exception a worker or GBA thread died of."""
        for part in (self.local_mapper, self.loop_closer):
            if part is not None and part.error is not None:
                raise part.error

    def _pre_frame(self):
        self._raise_thread_error()
        self._maybe_reset()
        if self._profile_dir is not None and self.profiler is None:
            acts = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self.profiler = torch.profiler.profile(activities=acts)
            self.profiler.start()

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
        frame, then the occupancy grid, replayed after a closed loop; in
        async mode the worker does all of it."""
        if self.async_mode:
            return
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

    def _upload(self, a: np.ndarray, dtype=None) -> torch.Tensor:
        """A host array on the device (cast there to `dtype` if given): from
        pinned memory without blocking the host, on the card."""
        with trace.span("build.upload"):
            t = torch.from_numpy(np.ascontiguousarray(a))
            if self.device.type == "cuda":
                t = t.pin_memory().to(self.device, non_blocking=True)
            return t if dtype is None else t.to(dtype)

    def _build_stereo(self, pair: np.ndarray) -> Frame:
        return build_stereo_frame_from_u8(self._upload(pair), self.cfg)

    def _prefetch_build(self, pair: np.ndarray) -> Frame:
        """The frame build of a prefetched pair, outside any frame's own."""
        with trace.span("build"):
            return self._build_stereo(pair)

    def prefetch_stereo(self, image_left, image_right, normalized: Optional[bool] = None) -> Frame:
        """Upload a pair and enqueue its frame build ahead of the frame that
        will consume it; returns the frame handle for `track_stereo`."""
        with self._lane():
            return self._prefetch_build(self._pack_stereo_u8(image_left, image_right, normalized))

    def track_stereo(self, image_left, image_right=None, timestamp: float = 0.0,
                     normalized: Optional[bool] = None):
        """Per-frame stereo entry (System::TrackStereo): a host pair, or a
        frame handle from `prefetch_stereo` as `image_left` (image_right
        None). Returns Tcw as (R, t) numpy arrays, or None while
        initializing / lost."""
        if isinstance(image_left, Frame):
            def build():
                return image_left
        else:
            def build():
                return self._build_stereo(self._pack_stereo_u8(image_left, image_right, normalized))
        return self._run_frame(build, self.tracker.track_stereo_frame, timestamp)

    def track_stereo_prefetch(self, frame: Frame, next_images, timestamp: float):
        """Track a prefetched `frame` and prefetch `next_images` (a pair, or
        None at the end), whose upload and build are enqueued between this
        frame's fused track step and its readback. Returns (pose, the next
        frame's handle or None)."""
        with self._lane():
            payload = None if next_images is None else self._pack_stereo_u8(*next_images)
            if payload is not None:
                self.tracker.prefetch_cb = lambda: self._prefetch_build(payload)
            self.tracker.prefetch_result = None
            try:
                pose = self.track_stereo(frame, timestamp=timestamp)
                handle = self.tracker.prefetch_result
            finally:
                self.tracker.prefetch_cb = self.tracker.prefetch_result = None
            if handle is None and payload is not None:
                # initialization, relocalization and the reference-keyframe
                # path have no hook
                handle = self._prefetch_build(payload)
            return pose, handle

    def _upload_image(self, image) -> torch.Tensor:
        """A host image as a float32 [H, W] tensor on the device (uint8
        travels as uint8 and is cast there)."""
        img = np.asarray(image)
        if img.dtype != np.uint8:
            img = img.astype(np.float32, copy=False)
        return self._upload(img, torch.float32)

    def track_rgbd(self, image, depth_map, timestamp: float = 0.0):
        """Per-frame RGB-D entry (System::TrackRGBD): a grey image and a
        depth map of the same size, in the config's DepthMapFactor units
        (uint16, as a TUM depth PNG holds it, or float). Returns Tcw as (R,
        t) numpy arrays, or None while lost."""
        def build():
            depth = self._upload(np.asarray(depth_map, np.float32))
            return build_rgbd_frame(self._upload_image(image), depth, self.cfg, self._depth_scale)
        return self._run_frame(build, self.tracker.track_stereo_frame, timestamp)

    def track_monocular(self, image, timestamp: float = 0.0):
        """Per-frame monocular entry (System::TrackMonocular). Returns Tcw
        as (R, t) numpy arrays (up to the map's scale), or None while
        initializing / lost."""
        def build():
            return build_mono_frame(self._upload_image(image), self.cfg)
        return self._run_frame(build, self.tracker.track_mono_frame, timestamp)

    def _run_frame(self, build, track_fn, timestamp: float):
        """One frame from a System entry to its return (the `frame` span):
        `build()` (the `build` span), tracking under the map lock, the
        mapping work it queued; then the frame's times and metrics, from
        the same stamps as the spans (perf_counter ns)."""
        with self._lane():
            fr = trace.begin("frame", key=self._frame_id)
            try:
                self._pre_frame()
                t0 = time.perf_counter_ns()
                b = trace.begin("build", t0)
                try:
                    frame = build()
                finally:
                    t1 = time.perf_counter_ns()
                    b.end(t1)
                with self.map.lock, trace.span("track"):
                    pose = track_fn(frame, self._frame_id, timestamp)
                t2 = time.perf_counter_ns()
                self._post_track()
                t3 = time.perf_counter_ns()
                fr.end(t3)
            finally:
                fr.end()
            self.frame_times.append((t3 - t0) * 1e-9)
            self._collect_metrics(timestamp, t0, t1, t2, t3)
            self._frame_id += 1
            return pose

    def _collect_metrics(self, timestamp, t0, t_extract, t_track, t_end):
        """The tracker's per-frame record plus host-clock stage times (ms)
        from `_run_frame`'s stamps (ns): the `build` span, the map-lock wait
        and the `track` span, the mapping work run inline, and the three.
        The frame build is enqueued asynchronously, so on a GPU ms_extract is
        its launch time and ms_track includes the wait for it."""
        rec = self.tracker.last_metrics
        if rec is None:
            return
        rec = dict(rec)
        rec["timestamp"] = float(timestamp)
        rec["ms_extract"] = 1e-6 * (t_extract - t0)
        rec["ms_track"] = 1e-6 * (t_track - t_extract)
        rec["ms_mapping"] = 1e-6 * (t_end - t_track)
        rec["ms_total"] = 1e-6 * (t_end - t0)
        self.metrics.append(rec)

    def trajectory_kitti(self) -> List[np.ndarray]:
        return [T for _, T in self.tracker.trajectory()]

    def save_trajectory_kitti(self, path: str):
        save_kitti(path, self.trajectory_kitti())

    def trajectory_tum(self) -> List[Tuple[float, np.ndarray]]:
        """Per-frame (timestamp, Twc [4, 4])."""
        return self.tracker.trajectory()

    def save_trajectory_tum(self, path: str):
        save_tum(path, self.trajectory_tum())

    def timing_stats(self):
        ts = np.asarray(self.frame_times)
        if len(ts) == 0:
            return {}
        return {
            "median_s": float(np.median(ts)),
            "mean_s": float(ts.mean()),
            "fps": float(1.0 / np.median(ts)),
        }

    def _grid_read(self, fn):
        """Read the grid; in async mode under the map lock, after the
        worker's enqueued grid updates."""
        if self.grid_mapper is None:
            return None
        if not self.async_mode:
            return fn()
        with self._lane(), self.map.lock:
            self.streams.wait_role("mapping")
            return fn()

    def occupancy_grid(self):
        """The live occupancy grid, or None with mapping off."""
        return self._grid_read(lambda: self.grid_mapper.occupancy_grid())

    def point_cloud(self):
        return self._grid_read(lambda: self.grid_mapper.point_cloud())

    def activate_localization_mode(self):
        """System::ActivateLocalizationMode: track against the map as it
        stands; no keyframe or map point is added."""
        self.tracker.only_tracking = True

    def deactivate_localization_mode(self):
        self.tracker.only_tracking = False

    def save_metrics_ndjson(self, path: str) -> int:
        return write_ndjson(path, self.metrics)

    def save_map(self, path: str):
        """System::SaveMap: drain mapping, then write the map file."""
        if self.local_mapper is not None:
            self.local_mapper.finish(self._worker)
        self._raise_thread_error()
        with self.map.lock:
            save_map(path, self.map, next_frame_id=self._frame_id)

    @classmethod
    def from_map_file(cls, cfg: SlamConfig, path: str, **kwargs):
        """Boot from a map file: restore the map, recompute every keyframe's
        BoW words on the device against the loaded vocabulary, and start
        LOST so the first frame relocalizes."""
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
        """System::Shutdown: finish the worker and join it, join a running
        global BA, drain what is left inline, wait for every stream and the
        device, stop the profiler; then raise what a thread died of."""
        if self._worker is not None:
            self.local_mapper.request_finish()
            self._worker.join(timeout=JOIN_TIMEOUT_S)
            if self._worker.is_alive():
                raise RuntimeError(f"the mapping worker did not finish in {JOIN_TIMEOUT_S:.0f} s")
        if self.loop_closer is not None and self.loop_closer.gba_thread is not None:
            self.loop_closer.gba_thread.join(timeout=JOIN_TIMEOUT_S)
            if self.loop_closer.gba_thread.is_alive():
                raise RuntimeError(f"the global-BA thread did not finish in {JOIN_TIMEOUT_S:.0f} s")
        if self.streams is not None:
            self.streams.synchronize()
        self.async_mode = False
        self._raise_thread_error()
        with self._lane():
            if self.local_mapper is not None:
                self.local_mapper.finish()
            if self.grid_mapper is not None:
                self._post_track()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        if self.profiler is not None:
            self.profiler.stop()
            os.makedirs(self._profile_dir, exist_ok=True)
            self.profiler.export_chrome_trace(os.path.join(self._profile_dir, "trace.json"))
            self._profile_dir = None  # one trace per System
