"""The close-range RGB-D drive of chip_smoke.py (phase 16), run by the JAX
reference System or by the port's CPU path on the CPU: the reference
numbers that phase holds the card's run against.

    python scripts/ref_rgbd_close_range.py jax  [out.json]
    python scripts/ref_rgbd_close_range.py port [out.json]

tum_rgbd_config("freiburg1") (640x480, 2000 features, the freiburg1 lens,
DepthMapFactor 5000) at the defaults (packaged vocabulary, mapping and loop
closing on, synchronous) over chip_smoke.py's close-range frames (its
`close_range_world` / `close_range_frame`: depth as uint16); then
localization mode re-tracks the last frames. Prints (and writes) the
tracked frames, the keyframes and the frames they fall on, where the
close-point keyframe trigger held, the ATE, and the localization frames
tracked and spent in VO mode. About 13 minutes on a CPU.
"""

from __future__ import annotations

import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    which = sys.argv[1]
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    if which == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_default_matmul_precision", "highest")
        from orb_slam2_2021_tpu import config
        from orb_slam2_2021_tpu.io import synthetic
        from orb_slam2_2021_tpu.pipeline.system import System

        cfg = config.tum_rgbd_config("freiburg1")
        sys_ = System(cfg, sensor="rgbd")
    else:
        import torch

        torch.set_num_threads(2)
        from orb_slam2_2021_tpu_torch import config
        from orb_slam2_2021_tpu_torch.io import synthetic
        from orb_slam2_2021_tpu_torch.pipeline.system import System

        cfg = config.tum_rgbd_config("freiburg1")
        sys_ = System(cfg, sensor="rgbd", device="cpu")
    world, gt = cs.close_range_world(cfg, synthetic)
    frames = [cs.close_range_frame(world, pose) for pose in gt]
    t0 = time.perf_counter()
    fired: list = []
    cs.count_close_triggers(sys_.tracker, fired)
    tracked = sum(sys_.track_rgbd(img, depth, timestamp=0.1 * i) is not None
                  for i, (img, depth) in enumerate(frames))
    kf_frames = [r["frame_id"] for r in sys_.metrics if r["keyframe"]]
    ate, length = cs._ate(sys_.trajectory_kitti(), gt)
    sys_.activate_localization_mode()
    kf0, mp0 = int(sys_.map.next_kf), int(sys_.map.next_mp)
    loc_tracked, vo = 0, 0
    for j, i in enumerate(range(cs.CLOSE_FRAMES - 1, cs.CLOSE_LOC_FROM - 1, -1)):
        loc_tracked += sys_.track_rgbd(*frames[i], timestamp=10.0 + 0.1 * j) is not None
        vo += bool(sys_.tracker.vo_mode)
    grew = int(sys_.map.next_kf) != kf0 or int(sys_.map.next_mp) != mp0
    sys_.shutdown()
    out = {"system": which, "tracked": tracked, "keyframes": len(kf_frames), "kf_frames": kf_frames,
           "close_trigger_frames": sorted(set(fired)), "ate": float(ate), "length": length,
           "loc_tracked": loc_tracked, "loc_frames": cs.CLOSE_FRAMES - cs.CLOSE_LOC_FROM,
           "vo_frames": vo, "loc_map_grew": grew, "seconds": time.perf_counter() - t0}
    print(json.dumps(out), flush=True)
    if len(sys.argv) > 2:
        with open(sys.argv[2], "w") as f:
            json.dump(out, f)


if __name__ == "__main__":
    main()
