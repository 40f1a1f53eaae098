"""bench_torch.py's front-end microloop and its JSON line, held against
bench.py's `_frontend_fps` step (make_stereo_frame_fn + make_motion_track_fn)
on the CPU at 320x240.

Both steps take the reference's seeded inputs: default_rng(0) noise for the
left image and its 8-px roll for the right, random landmarks 15 m ahead with
random descriptors, the identity pose, radius 7. Poses must agree within
1e-4; the match and inlier counts within the lane's descriptor rate (97% of
descriptors identical, tests/test_torch_frame.py), since hazard 3 can flip a
descriptor's bits.
"""

import math
import os
import sys

import jax.numpy as jnp
import numpy as np

from orb_slam2_2021_tpu.config import synthetic_config as ref_synthetic_config
from orb_slam2_2021_tpu.frontend.frame import make_stereo_frame_fn
from orb_slam2_2021_tpu.geometry.camera import PinholeCamera as RefCamera
from orb_slam2_2021_tpu.pipeline.track_steps import make_motion_track_fn
from orb_slam2_2021_tpu_torch.config import synthetic_config
from orb_slam2_2021_tpu_torch.frontend.frame import build_stereo_frame
from orb_slam2_2021_tpu_torch.io.synthetic import SyntheticStereoWorld, forward_trajectory
from orb_slam2_2021_tpu_torch.pipeline.system import System

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
import bench_torch  # noqa: E402

POSE_TOL = 1e-4
COUNT_RATE = 0.03  # the lane's share of descriptors allowed to differ
# the line's keys before the microloop came (bench_torch.py's headline)
LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "extra"}
EXTRA_KEYS = {"ate_rmse_m", "trajectory_len_m", "local_ba_ms_per_iter", "gba_ms_per_iter",
              "n_keyframes", "n_map_points", "n_loops", "n_frames", "n_lost_frames", "lost_spans",
              "median_frame_ms", "scenario_novel_texture", "frame_budget", "device"}
FRONTEND_KEYS = ["frontend_fps", "frontend_ms_per_step", "frontend_launches_per_step"]


def _reference_step(cfg):
    """bench.py:47-72 on its own inputs: (R, t, slot, inlier, n_inliers,
    n_matched)."""
    cam = RefCamera.create(cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.bf, cfg.width, cfg.height)
    rng = np.random.default_rng(0)
    left_np = rng.uniform(0, 255, (cfg.height, cfg.width)).astype(np.float32)
    left, right = jnp.asarray(left_np), jnp.asarray(np.roll(left_np, -8, axis=1))
    n = cfg.orb.n_features
    last_xw = jnp.asarray(rng.uniform(-10, 10, (n, 3)), jnp.float32) + jnp.asarray([0, 0, 15.0])
    last_desc = jnp.asarray(rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32))
    frame = make_stereo_frame_fn(cfg)(left, right)
    out = make_motion_track_fn(cfg)(
        cam, frame.kp, frame.u_right, jnp.eye(3), jnp.zeros(3), last_xw, last_desc,
        jnp.zeros(n, jnp.int32), jnp.zeros(n, jnp.float32), jnp.ones(n, bool), jnp.float32(7.0))
    return frame, [np.asarray(x) for x in out]


def _counts_agree(a, b):
    return abs(int(a) - int(b)) <= math.ceil(COUNT_RATE * max(int(a), int(b)))


def test_frontend_step_matches_the_reference_microloop():
    ref_frame, (R_r, t_r, slot_r, _, n_in_r, n_m_r) = _reference_step(ref_synthetic_config(320, 240))
    cfg = synthetic_config(width=320, height=240)
    step, inputs = bench_torch.frontend_step(cfg, "cpu")
    assert all(x.device.type == "cpu" and x.shape == (240, 320) for x in inputs)
    frame = build_stereo_frame(*inputs, cfg)
    same_kp = (frame.kp.xy.numpy() == np.asarray(ref_frame.kp.xy)).all(axis=1).mean()
    assert same_kp > 0.99, f">= 99% identical keypoint slots, got {same_kp:.4f}"
    R, t, slot, inlier, n_in, n_matched = step(*inputs)
    assert np.abs(R.numpy() - R_r).max() < POSE_TOL
    assert np.abs(t.numpy() - t_r).max() < POSE_TOL
    assert _counts_agree(n_matched, n_m_r) and _counts_agree(n_in, n_in_r)
    assert int(n_matched) == int((slot.numpy() >= 0).sum()) and int(n_in) <= int(n_matched)


def test_result_line_keeps_its_keys_and_adds_the_microloop():
    """result_line, the function that fills the printed line, on a short
    async CPU drive: every key the line had, the microloop's three first
    in `extra`; frontend_extra gives -1 under BENCH_LEAN=1 and a positive
    rate otherwise."""
    cfg = synthetic_config(width=320, height=240)
    lean = bench_torch.frontend_extra(cfg, "cpu", lean=True)
    assert lean == {"frontend_fps": -1.0, "frontend_ms_per_step": -1.0, "frontend_launches_per_step": -1}
    measured = bench_torch.frontend_extra(cfg, "cpu", lean=False, steps=1)
    assert measured["frontend_fps"] > 0 and math.isfinite(measured["frontend_fps"])
    assert measured["frontend_ms_per_step"] > 0 and measured["frontend_launches_per_step"] is None

    world = SyntheticStereoWorld(cfg, seed=3)
    gt = forward_trajectory(bench_torch.WARMUP_FRAMES + 1, step=0.12)
    frames = [np.clip(np.stack(world.render(R, t)), 0, 255).astype(np.uint8) for R, t in gt]
    sys_ = System(cfg, async_mode=True, device="cpu")
    try:
        fps = bench_torch.drive(sys_, frames, bench_torch.WARMUP_FRAMES)
    finally:
        sys_.shutdown()
    for frontend in (lean, measured):
        line = bench_torch.result_line(fps, sys_, gt, frontend, {}, "cpu")
        assert set(line) == LINE_KEYS and line["metric"] == "e2e_stereo_slam_fps"
        assert list(line["extra"])[:3] == FRONTEND_KEYS
        assert set(line["extra"]) == EXTRA_KEYS | set(FRONTEND_KEYS)
        assert line["extra"]["frontend_fps"] == frontend["frontend_fps"]
    assert line["extra"]["n_frames"] == len(frames) and line["extra"]["n_lost_frames"] == 0
