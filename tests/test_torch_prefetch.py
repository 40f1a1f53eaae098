"""The port's prefetch drive on the CPU: `track_stereo_prefetch`, which
tracks a frame handle from `prefetch_stereo` and builds the next frame
between the fused track step and its readback, gives exactly the poses of
`track_stereo` on the same frames, and the JAX reference's
`System.track_stereo_prefetch` poses within the lane's 9e-5 m. Synchronous,
mapping off (the tracking lane only), as tests/test_torch_slice.py holds the
lane.
"""

import numpy as np
import torch

from orb_slam2_2021_tpu.config import synthetic_config
from orb_slam2_2021_tpu.io.synthetic import SyntheticStereoWorld, forward_trajectory
from orb_slam2_2021_tpu_torch.pipeline.system import System as TSystem
from orb_slam2_2021_tpu_torch.place.bundle import PlaceRecognition as TPR

torch.set_num_threads(1)

N_FRAMES = 10
LANE_TOL = 9e-5  # m and rotation entries: the lane's parity with the reference


def _prefetch_drive(sys_, frames):
    """bench.py's drive: prefetch frame 0, then track each prefetched frame
    while prefetching the next."""
    poses = []
    nxt = sys_.prefetch_stereo(*frames[0])
    for i in range(len(frames)):
        cur = nxt
        pose, nxt = sys_.track_stereo_prefetch(
            cur, frames[i + 1] if i + 1 < len(frames) else None, timestamp=0.1 * i)
        poses.append(pose)
    assert nxt is None
    return poses


def test_prefetch_drive_matches_track_stereo_and_the_reference():
    from orb_slam2_2021_tpu.pipeline.system import System as JSystem
    from orb_slam2_2021_tpu.place.bundle import PACKAGED_VOCAB_SMALL, PlaceRecognition as JPR
    from orb_slam2_2021_tpu.place.vocab import BinaryVocabulary

    cfg = synthetic_config(width=320, height=240)
    world = SyntheticStereoWorld(cfg, seed=3)
    frames = [world.render(R, t) for R, t in forward_trajectory(N_FRAMES, step=0.12)]
    port = lambda: TSystem(cfg, enable_mapping=False, device="cpu",  # noqa: E731
                           place_rec=TPR.from_file(PACKAGED_VOCAB_SMALL, "cpu"))

    plain = port()
    poses = [plain.track_stereo(l, r, timestamp=0.1 * i) for i, (l, r) in enumerate(frames)]
    pre = port()
    fused, hooked = pre.tracker._track_fused, []

    def counted(*args):
        had_cb = pre.tracker.prefetch_cb is not None
        out = fused(*args)
        hooked.append(had_cb and pre.tracker.prefetch_result is not None)
        return out

    pre.tracker._track_fused = counted
    poses_pre = _prefetch_drive(pre, frames)
    ref = JSystem(cfg, enable_mapping=False, place_rec=JPR(BinaryVocabulary.load(PACKAGED_VOCAB_SMALL)))
    poses_ref = _prefetch_drive(ref, frames)

    assert [p is None for p in poses_pre] == [p is None for p in poses] == [p is None for p in poses_ref]
    assert sum(p is not None for p in poses) == N_FRAMES
    for a, b in zip(poses_pre, poses):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]), "prefetch changed a pose"
    worst = max(max(float(np.abs(a[0] - b[0]).max()), float(np.abs(a[1] - b[1]).max()))
                for a, b in zip(poses_pre, poses_ref))
    assert worst < LANE_TOL, f"poses {worst:.2e} from the reference's"
    assert [m["state"] for m in pre.metrics] == [m["state"] for m in ref.metrics]
    assert pre.tracker.prefetch_cb is None and pre.tracker.prefetch_result is None
    assert sum(hooked) >= N_FRAMES - 3, f"the fused step built the next frame on {sum(hooked)} frames"
