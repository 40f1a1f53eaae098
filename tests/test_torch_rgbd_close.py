"""RGB-D at close range with uint16 depth, the port's System against the JAX
reference System on the CPU at 320x240.

The freiburg1 configuration at half size (intrinsics and bf halved, its lens,
DepthMapFactor 5000, 1000 features, ThDepth 2.8 m) over
SyntheticStereoWorld(seed 4, z_min 1 m, z_max 6 m), the camera dollying
toward the wall, the depth passed as uint16 (metres x 5000) as a TUM depth
PNG holds it. Points come within ThDepth as the camera closes in, so the
close-point keyframe trigger (fewer than 100 tracked and more than 70
untracked close points) decides keyframes here; the full-size drive of
chip_smoke.py holds the card to the reference's numbers.

Decisions must be identical: tracked flags, keyframe counts and flags, and
the frames where the close-point trigger held. Poses agree within 5e-3
(measured 3.7e-4 up to frame 12 and 1.35e-3 on frame 13, the first frame
after the local BA of frame 12's keyframe: the float32 LM solves of the two
packages part by about a millimetre on this close, dollying window).
"""

import numpy as np
import torch

from chip_smoke import count_close_triggers
from orb_slam2_2021_tpu.config import OrbConfig, tum_rgbd_config
from orb_slam2_2021_tpu.io.synthetic import SyntheticStereoWorld, forward_trajectory
from orb_slam2_2021_tpu_torch.convert import config_from_reference
from orb_slam2_2021_tpu_torch.pipeline.system import System as TSystem

torch.set_num_threads(1)

N_FRAMES = 14


def test_close_range_uint16_rgbd_matches_reference():
    from orb_slam2_2021_tpu.pipeline.system import System as JSystem
    from orb_slam2_2021_tpu.place.bundle import PACKAGED_VOCAB_SMALL, PlaceRecognition as JPR
    from orb_slam2_2021_tpu.place.vocab import BinaryVocabulary as JVoc
    from orb_slam2_2021_tpu_torch.place.bundle import PlaceRecognition as TPR
    from orb_slam2_2021_tpu_torch.place.vocab import BinaryVocabulary as TVoc

    full = tum_rgbd_config("freiburg1")
    cfg = full.replace(width=320, height=240, fx=full.fx / 2, fy=full.fy / 2, cx=full.cx / 2,
                       cy=full.cy / 2, bf=full.bf / 2, depth_th=2.8,
                       orb=OrbConfig(n_features=1000, n_levels=full.orb.n_levels,
                                     scale_factor=full.orb.scale_factor))
    world = SyntheticStereoWorld(cfg, seed=4, z_min=1.0, z_max=6.0)
    frames = []
    for i, (R, t) in enumerate(forward_trajectory(N_FRAMES, step=0.08)):
        img, depth = world.render_rgbd(R, t + np.array([0.0, 0.0, 0.08 * i], np.float32),
                                       dist_coef=cfg.dist_coef)
        raw = np.round(depth * cfg.depth_map_factor)
        assert raw.max() < 65535
        frames.append((np.clip(img, 0, 255).astype(np.uint8), raw.astype(np.uint16)))

    ref = JSystem(cfg, enable_loop_closing=False, sensor="rgbd",
                  place_rec=JPR(JVoc.load(PACKAGED_VOCAB_SMALL)))
    port = TSystem(config_from_reference(cfg), enable_loop_closing=False, sensor="rgbd",
                   place_rec=TPR(TVoc.load(PACKAGED_VOCAB_SMALL), device="cpu"), device="cpu")
    close_ref, close_port = [], []
    count_close_triggers(ref.tracker, close_ref)
    count_close_triggers(port.tracker, close_port)
    worst = 0.0
    for i, (img, depth) in enumerate(frames):
        pr = ref.track_rgbd(img, depth, timestamp=0.1 * i)
        pt = port.track_rgbd(img, depth, timestamp=0.1 * i)
        assert (pr is None) == (pt is None), f"frame {i}: tracked flags differ"
        assert port.map.n_kf == ref.map.n_kf, f"frame {i}: keyframe counts differ"
        if pr is not None:
            worst = max(worst, float(np.abs(pt[0] - pr[0]).max()), float(np.abs(pt[1] - pr[1]).max()))
    ref.shutdown()
    port.shutdown()
    assert sum(m["state"] == "OK" for m in port.metrics) == N_FRAMES
    assert [m["keyframe"] for m in port.metrics] == [m["keyframe"] for m in ref.metrics]
    assert close_port == close_ref, "the close-point trigger held on different frames"
    assert close_port, "the close-point trigger never held"
    assert worst < 5e-3, f"poses differ by {worst:.2e} (tolerance 5e-3)"
    assert abs(int(port.map.mp_valid.sum()) - int(ref.map.mp_valid.sum())) <= 0.01 * int(ref.map.mp_valid.sum())
