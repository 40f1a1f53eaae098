"""Dataset driver of the port (counterpart of examples/run_slam.py): run the
System over a sequence, print per-frame timing statistics at exit, save the
KITTI and TUM trajectories.

Usage:
  python -m orb_slam2_2021_tpu_torch.run_slam synthetic [n_frames]         # built-in demo
  python -m orb_slam2_2021_tpu_torch.run_slam kitti <seq_dir> [--reduced]  # KITTI stereo
  python -m orb_slam2_2021_tpu_torch.run_slam tum <seq_dir>                # TUM RGB-D

Options:
  --device <dev>   where the System runs: cuda (the default) or cpu
  --reduced        first 500 frames
  --pace           real-time pacing: sleep to the dataset timestamp schedule;
                   prints how many frames the engine was late for
  --async          threaded pipeline (tracking lane + mapping worker + global
                   BA thread, each on its own CUDA stream)
  --save-map <f>   save the map file at shutdown
  --metrics <f>    dump per-frame metrics NDJSON (state, matches, inliers,
                   ms per stage)
  --profile <dir>  record a torch.profiler trace over the run (trace.json)
  --publish        NDJSON TCP pub/sub of os2_pose / os2_pointcloud / os2_gm /
                   os2_gm_pose / os2_metrics in the synthetic and kitti modes
                   (prints the port; subscribe with e.g. `nc 127.0.0.1 <port>`)
  --viz <dir>      write the frame overlay and the top-down map as PNGs to
                   <dir> every 5th frame (frame_NNNNNN.png, map_NNNNNN.png)
"""

from __future__ import annotations

import sys
import time

import numpy as np


def _setup_publisher(sys_):
    """The pub/sub outputs of --publish: (SystemPublisher, TcpPublisher), or
    (None, None) without the flag."""
    if "--publish" not in sys.argv:
        return None, None
    from .io.pubsub import (TOPIC_GRID, TOPIC_GRID_POSE, TOPIC_METRICS, TOPIC_POINTCLOUD,
                            TOPIC_POSE, MessageBus, SystemPublisher, TcpPublisher)

    bus = MessageBus()
    spub = SystemPublisher(sys_, bus)
    tcp = TcpPublisher(bus, [TOPIC_POSE, TOPIC_POINTCLOUD, TOPIC_GRID, TOPIC_GRID_POSE,
                             TOPIC_METRICS])
    print(f"publishing NDJSON on 127.0.0.1:{tcp.port}", flush=True)
    return spub, tcp


def _setup_viewer(sys_):
    """The Viewer of --viz <dir> (every 5th frame), or None without the flag."""
    out_dir = _flag_value("--viz")
    if out_dir is None:
        return None
    from .viz.viewer import Viewer

    return Viewer(sys_, out_dir=out_dir, stride=5)


def _per_frame_outputs(viewer, spub, image, ts, i):
    """The viewer's images of the frame just tracked; with --publish, the
    frame's pose and metrics, and the map every 10 frames."""
    if viewer is not None:
        viewer.update(image)
    if spub is not None:
        spub.publish_frame(ts)
        if i % 10 == 0:
            spub.publish_map(ts)


def _flag_value(name):
    return sys.argv[sys.argv.index(name) + 1] if name in sys.argv else None


class Pacer:
    """Real-time pacing to the dataset timestamp schedule: sleep until each
    frame's capture time; a real camera would drop the frames the engine is
    late for."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.t0 = None
        self.ts0 = None
        self.late = 0
        self.total = 0
        self.max_late_s = 0.0

    def wait(self, ts: float):
        if not self.enabled:
            return
        now = time.perf_counter()
        if self.t0 is None:
            self.t0, self.ts0 = now, ts
            return
        due = self.t0 + (ts - self.ts0)
        self.total += 1
        if now < due:
            time.sleep(due - now)
        else:
            self.late += 1
            self.max_late_s = max(self.max_late_s, now - due)

    def report(self):
        if self.enabled and self.total:
            print(f"pacing: late on {self.late}/{self.total} frames "
                  f"(max {1e3*self.max_late_s:.0f} ms behind schedule)")


def main():
    mode = sys.argv[1] if len(sys.argv) > 1 else "synthetic"
    device = _flag_value("--device") or "cuda"
    kw = {"profile_dir": _flag_value("--profile"), "async_mode": "--async" in sys.argv,
          "device": device}

    from .config import kitti_stereo_config, synthetic_config, tum_rgbd_config
    from .pipeline.system import System

    pacer = Pacer("--pace" in sys.argv)
    tcp = None
    if mode == "synthetic":
        from .io.synthetic import SyntheticStereoWorld, forward_trajectory
        from .io.trajectory import ate_rmse

        n = int(sys.argv[2]) if len(sys.argv) > 2 and not sys.argv[2].startswith("--") else 60
        cfg = synthetic_config(width=320, height=240)
        world = SyntheticStereoWorld(cfg, seed=3)
        gt = forward_trajectory(n, step=0.12)
        sys_ = System(cfg, **kw)
        viewer = _setup_viewer(sys_)
        spub, tcp = _setup_publisher(sys_)
        for i, (R, t) in enumerate(gt):
            left, right = world.render(R, t)
            pacer.wait(i * 0.1)
            sys_.track_stereo(left, right, timestamp=i * 0.1)
            _per_frame_outputs(viewer, spub, left, i * 0.1, i)
            print(f"frame {i:04d}: {sys_.tracker.state.name} inliers={sys_.tracker.n_inliers_last} "
                  f"kf={sys_.map.n_kf}")
        sys_.shutdown()
        est = sys_.trajectory_kitti()
        gt_mats = []
        for R, t in gt[: len(est)]:
            T = np.eye(4)
            T[:3, :3], T[:3, 3] = R, t
            gt_mats.append(T)
        print("ATE RMSE:", ate_rmse(est, gt_mats))
    elif mode == "kitti":
        from .io.datasets import KittiStereoSequence

        seq = KittiStereoSequence(sys.argv[2], max_frames=500 if "--reduced" in sys.argv else None)
        sys_ = System(kitti_stereo_config(), **kw)
        viewer = _setup_viewer(sys_)
        spub, tcp = _setup_publisher(sys_)
        for i, (ts, left, right) in enumerate(seq):
            pacer.wait(ts)
            sys_.track_stereo(left, right, timestamp=ts)
            _per_frame_outputs(viewer, spub, left, ts, i)
        sys_.shutdown()
    elif mode == "tum":
        from .io.datasets import TumRgbdSequence

        # raw (unscaled) depth: System applies DepthMapFactor itself
        seq = TumRgbdSequence(sys.argv[2], depth_scale=1.0)
        # the freiburg calibration from the sequence path (TUM publishes
        # per-camera intrinsics; freiburg1 and 2 need undistortion)
        preset = "freiburg3"
        for p in ("freiburg1", "freiburg2", "freiburg3"):
            if p in sys.argv[2]:
                preset = p
        sys_ = System(tum_rgbd_config(preset), sensor="rgbd", **kw)
        viewer = _setup_viewer(sys_)
        for i, (ts, rgb, depth) in enumerate(seq):
            pacer.wait(ts)
            sys_.track_rgbd(rgb, depth, timestamp=ts)
            _per_frame_outputs(viewer, None, rgb, ts, i)
        sys_.shutdown()
    else:
        raise SystemExit(__doc__)
    if tcp is not None:
        tcp.close()

    stats = sys_.timing_stats()
    pacer.report()
    print(f"median tracking time: {stats['median_s']:.4f} s")
    print(f"mean tracking time:   {stats['mean_s']:.4f} s")
    sys_.save_trajectory_kitti("trajectory_kitti.txt")
    sys_.save_trajectory_tum("trajectory_tum.txt")
    print("saved trajectory_kitti.txt / trajectory_tum.txt")
    mpath = _flag_value("--metrics")
    if mpath:
        n = sys_.save_metrics_ndjson(mpath)
        print(f"wrote {n} metrics records to {mpath}")
    path = _flag_value("--save-map")
    if path:
        sys_.save_map(path)
        print(f"saved map checkpoint to {path}")


if __name__ == "__main__":
    main()
