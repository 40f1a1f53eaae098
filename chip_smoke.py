"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits nonzero before the result lines are printed):
  1. require a CUDA card; print its name and power limit (nvidia-smi);
  2. build the hand-written kernels from csrc/ with nvcc (one nvcc a
     source, started together), print build time;
  3. hold both Hamming launchers (hamming_matrix, hamming_best2) against
     their plain PyTorch versions on the card, exactly, at the tracking
     lane's shapes, the ragged shapes and M == 1, with edge-case masks (an
     all-masked row, an all-open row with tied duplicate columns, a row open
     at one column); check the fused one repeats bit for bit; time both at
     4096x2000 beside their bounds, plain versions and yardsticks;
  4. check the lane on a small input against the port's CPU path, which the
     tests/test_torch_*.py suite holds against the JAX reference;
  5. drive System(kitti_stereo_config(), enable_mapping=False) over frames
     rendered by SyntheticStereoWorld at KITTI width, counting hamming_best2's
     launches (and hamming_matrix's, which must be 0) on that drive, and
     check tracking, keyframes, ATE and devices;
  6. the Hamming checks of phase 3 at the shapes local mapping gives the
     fused launcher (one keyframe against T = 10 and 8 stacked keyframes;
     the matrix at 2000 x T*2000), timed at T = 10;
  7. check the System with local mapping and the occupancy grid on, CUDA
     against the CPU path, on a 320x240 sequence;
  8. drive System(kitti_stereo_config(), enable_mapping=True,
     enable_loop_closing=False) over the first 24 frames of the bench's
     cylinder-world orbit at KITTI width, counting hamming_best2's launches
     from the mapping units apart from the lane's, and check tracking,
     keyframes, local BA solves, triangulated points, the grid and ATE;
  9. hold the loop-closing numerics on the card against the CPU path, with
     the same RANSAC samples on both devices: the vocabulary descent on the
     packaged 10^6-word tree (exact), Sim3 RANSAC and its refine, EPnP RANSAC
     (inlier flags as a rate) and the essential-graph solve; time each on
     the card;
 10. build a map with the port's CPU path at 320x240, save it, boot a CUDA
     and a CPU System from the file and relocalize one frame on both: same
     keyframe, poses within tolerance;
 11. drive System(kitti_stereo_config(), device="cuda") at the reference's
     defaults (packaged vocabulary, mapping and loop closing on, sync) over
     the whole 144-frame orbit, counting hamming_best2's launches per path
     (mapping units, loop closing); check tracking, the loop (pair and frame
     against the reference's), global BA, the grid replay and ATE; then save
     the map, boot from it on the card and relocalize a mid-orbit frame; and
     run the Hamming checks at the shapes loop closing gave the fused
     launcher;
 12. drive System(tum_rgbd_config("freiburg1"), sensor="rgbd") at the
     defaults over 60 RGB-D frames rendered through the freiburg1 lens
     (640x480, 2000 features), counting both launchers; check tracking,
     keyframes and ATE against the JAX reference's numbers, that every Frame
     tensor is on the card, and the TUM trajectory file read back;
 13. localization mode on that System: re-track frames 59 down to 40, no
     keyframe or map point added, within the ATE bound; then localization
     off and one new frame, on which mapping inserts a keyframe;
 14. drive System(tum_rgbd_config("freiburg1"), sensor="mono") over the same
     frames' images: initialization frame, tracked frames and Sim3-aligned
     ATE against the reference's; then the RGB-D, monocular and
     localization Systems CUDA against the CPU path at 320x240,
     two_view_init on the card against the CPU, and the Hamming checks at
     the largest new shape these drives gave the fused launcher;
 15. drive System(kitti_stereo_config(), async_mode=True) through
     bench_torch.drive (prefetch, the tracking lane, the mapping worker and
     the global-BA thread on their own CUDA streams) over the orbit of phase
     11: every frame tracked, ATE, map invariants, both threads joined and
     none raised; report the loop and the global BA, hamming_best2's
     launches per thread, the lane's median and p90 and its waits for the
     map lock beside phase 11's synchronous median on the same frames, and
     fps;
 16. drive the RGB-D System at close range with uint16 depth (points
     crossing ThDepth): tracking, ATE and the close-point keyframe trigger
     against the JAX reference's numbers; then localization mode;
 17. drive the RGB-D System in async mode over the first close-range frames
     and the monocular one over the first TUM frames: tracked, mapped,
     invariants clean, threads joined;
 18. trace a stretch of a fresh async drive of the orbit with torch.profiler:
     the device busy share and the kernels per stream (run last, after
     phases 19-22, since the trace slows what follows it in the process);
 19. the dense local BA (use_cg_local_ba=False) of the last keyframe's
     window of phase 8's map at the static shapes (C=128, P=4096,
     O=32768, Q=8): the card against the CPU path, its eigenproblem in
     float32 and float64 on both, device time and launches per solve;
 20. drive System(kitti_stereo_config()) with the dense local BA, mapping
     on and loop closing off, over phase 8's frames: tracking, keyframes,
     local BA solves, ATE, ms per solve beside phase 8's CG solves;
 21. the landmark-sharded global BA at world size 1 under NCCL: three
     iterations of make_dist_gba_iteration against gba_iteration on a
     corridor problem the size of SCALE_1500KF.json (1,442 keyframes,
     487,556 points, 570,794 observations), then make_dist_ba against
     ba_solve at the dense local-BA shape; ms per iteration, the one-hot's
     bytes, peak memory;
 22. two ranks on the card (gloo): scripts/torch_dist_live_2proc.py, rank 0
     the default sync System over phase 11's orbit with a GbaClient, rank 1
     a GbaServer: the loop at phase 11's pair and frame, the server's solve
     written back, ATE;
 23. the System's outputs: stereo rectification (maps from arducam-style
     settings at 640x480 and at KITTI width, a rendered pair remapped on
     the card against the CPU path, an identity map, device ms and
     launches per pair); pub/sub (a SystemPublisher and a TcpPublisher on
     the five topics of run_slam.py --publish, read by a subscriber
     socket, on phase 8's sync drive and phase 17's async RGB-D drive,
     publishing outside the timed calls: one os2_pose per returned pose,
     valid os2_metrics, the last cloud and grid of the sync drive, the
     laser-scan relay, bytes and host ms of publish_map); the map processor
     on phase 11's saved map (PLY, TUM, PGM; the PGM against the CPU
     path's); the statistical outlier filter on phase 21's 487,556 corridor
     points (time, blocks, peak memory, kept share, launches, bound) and on
     a 20,000-point subset against the CPU path;
 24. the last modules: the chessboard calibrator (60 stereo views of an
     8x6 board through the arducam-style lenses, 0.2 px of noise): the
     joint LM on the card in float32 and float64 (device ms, launches, no
     host sync inside its 30 iterations, bound), the stereo solve against
     the truth, its YAML through rectification_from_yaml and a pair
     remapped on the card against the CPU path, and the card's LM against
     the CPU's in float64 and float32; the headless Viewer (stride 5) on
     phase 8's sync drive (PNGs, host ms per update) and phase 17's async
     RGB-D drive (the map lock's hold per update: the copy of the rows in
     use);
 25. the scale proof's twin, scripts/torch_scale_1500kf.py, at full size on
     the card: the reference script's corridor map grown through the port's
     map paths (1,442 keyframes, 487,577 points, 570,794 observations, the
     reference script's counts on this tree), one global-BA assembly and
     three gba_iteration steps (ms by CUDA events, one-hot bytes), the
     essential graph over every keyframe (ms, launches, edges, incidence
     bytes, the host write-back), no cost rising, poses finite, peak memory;
     hamming_matrix launches 0;
 26. bench_torch's front-end microloop at KITTI width (the frame build and
     the motion-only track step, 30 steps back to back): frames/s, ms and
     launches a step, hamming_best2's launches; the fused launcher held and
     timed at the step's own two matcher inputs; one step on the card
     against the CPU;
 27. the vocabulary builder (csrc/vocab.cu): the first 8 worlds of the L6
     recipe through scripts/torch_train_vocab_l6.py's harvest (80 frames
     at 560x420, extraction on the card; world 0's frames against the CPU
     extraction), k=10 L=6 trained on that corpus on the card, counting
     the launches of vocab_assign, vocab_majority and vocab_seed_draw, and
     through the CPU path (identical trees, both times, RNG passes per
     level); each kernel held exactly against its plain version and timed
     at levels 0, 2 and 5 of that run, vocab_assign at level 0 against
     hamming_best2 under an all-open mask; 4,000,000 random descriptors
     trained twice on the card (identical trees; seconds, launches, RNG
     passes, peak memory), each kernel held exactly against its plain
     version at levels 0 and 5 of the second run; the seed draw timed
     beside torch.cumsum of the same float64 p; both redesigned kernels
     held on adversarial inputs (tie-forcing, binade-crossing, zero-run,
     power-of-two-sum and zero-sum nodes, nodes just over the chain's
     2,048 rows, uniforms on the cdf's own values; nodes ending inside a
     k-word, group or chunk, empty clusters, rows in no cluster).

The run's order differs from the numbering: phase 22 runs in processes of
its own while the main process holds the CUDA-vs-CPU checks of phases 4,
7, 10 and 14 and the CPU halves of phases 23, 24, 26 and 27 (which report
no card times), after phase 21 and the card checks of phases 23 to 27; phase 24's
viewer runs on the drives of phases 8 and 17; phase 18 runs last.
Nothing of the JAX package is imported. The second-to-last line is a JSON object describing each kernel; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
N_FRAMES = 30
STEP = 0.14          # m per frame: the bench's KITTI-width forward dolly
WORLD_SEED = 7700
SHAPES = [(2000, 2000), (4096, 2000), (1, 1), (127, 129), (200, 150), (257, 64), (0, 7)]
# local mapping at KITTI width: triangulation matches one keyframe's 2000
# features against 10 neighbours, forward fusion 2000 points against 8
MAPPING_SHAPES = [(2000, 2000, 10), (2000, 2000, 8)]  # (N, M, T)
N_ORBIT = 144        # the bench's 630-degree orbit (bench.py)
N_MAP_FRAMES = 24    # its first frames, for the mapping-on drive (4 keyframes by frame 14)
# the JAX reference's synchronous drive of the same orbit closes one loop at
# frame 84, keyframe 9 against keyframe 0 (485 matched map points)
REF_LOOP_FRAME, REF_LOOP_PAIR = 84, (9, 0)
RELOC_FRAME = 60     # a mid-orbit frame relocalized against the saved map
SMALL_MAP_FRAMES = 20
# CUDA vs CPU with mapping on at 320x240: measured 1.02e-4 (pose) and 0.0024
# (map points) on an H100 80GB HBM3 at 700 W, see PERF.md
SMALL_MAP_POSE_TOL = 1e-3     # m and rotation entries
SMALL_MAP_POINTS_TOL = 0.02   # relative difference of live map-point counts
# the other sensors at tum_rgbd_config("freiburg1") (640x480, 2000 features,
# the freiburg1 lens, DepthMapFactor 5000): SyntheticStereoWorld(seed 4)
# rendered through the lens on forward_trajectory(60, step 0.12); the
# localization run re-tracks frames 59 down to 40
TUM_FRAMES, TUM_STEP, TUM_SEED, LOC_FROM = 60, 0.12, 4, 40
# the JAX reference System on the CPU over the same frames (ROADMAP.md,
# PERF.md): RGB-D init at frame 0, 60/60 tracked, 10 keyframes, ATE 0.0581 m
# over 7.159 m; re-tracked 20/20 in localization mode, ATE 0.0912 m, then a
# keyframe on the next frame; monocular init at frame 5, 55/60 tracked, 45
# keyframes, Sim3-aligned ATE 0.2857 m
REF_RGBD = {"tracked": 60, "keyframes": 10, "ate": 0.0581, "loc_tracked": 20, "loc_ate": 0.0912}
REF_MONO = {"init": 5, "tracked": 55, "keyframes": 45, "ate_sim3": 0.2857}
SMALL_LENS = (0.25, -0.15, -0.002, 0.001, 0.0)  # the synthetic lens of tests/test_undistort.py
SMALL_SENSOR_POSE_TOL = 1e-3
# RGB-D at close range (phase 16): the freiburg1 configuration over
# SyntheticStereoWorld(seed 4, z_min 1 m, z_max 6 m) through its lens on
# forward_trajectory(60, step 0.05), the depth passed as uint16 (metres x
# 5000: 6 m is 30000), points crossing ThDepth (3.1 m) as the camera closes
# in; localization then re-tracks frames 59 down to 50. The JAX reference on
# the CPU (scripts/ref_rgbd_close_range.py jax): 60/60 tracked, keyframes at
# frames 0, 14, 16, 20, 25, 31, 37, 43, 49, 55, the close-point trigger held
# at frame 14, ATE 0.0064 m over 2.983 m; localization 10/10, no VO frame
CLOSE_FRAMES, CLOSE_STEP, CLOSE_Z, CLOSE_LOC_FROM = 60, 0.05, (1.0, 6.0), 50
REF_CLOSE = {"tracked": 60, "kf_frames": [0, 14, 16, 20, 25, 31, 37, 43, 49, 55],
             "close_frames": [14], "ate": 0.0064, "loc_tracked": 10, "vo_frames": 0}
# phase 17: the other sensors in async mode, RGB-D over the first close-range
# frames (keyframes at 0, 14 and 16), monocular over the first TUM frames
ASYNC_SENSOR_FRAMES = 20
# phase 18: a fresh async System over the orbit's first frames, the last of
# them traced by torch.profiler for the busy share; last in the run (after
# phases 19-22) because the trace slows whatever runs after it in the process
ASYNC_PROFILE_FRAMES = (12, 18)
# phases 19-21: the dense local BA's static shapes at kitti_stereo_config()
# (64 + 64 cameras, 4096 points, 32768 observations, 8 per point)
DENSE_C, DENSE_P, DENSE_O, DENSE_Q = 128, 4096, 32768, 8
DENSE_POSE_TOL = 1e-3      # card vs CPU: rotation entries and m
DENSE_POINT_TOL = 1e-2     # m, 99th percentile over the window's points
DENSE_INLIER_AGREE = 0.99  # share of observations with the same inlier flag
DENSE_PERTURB = 0.03       # m: phase 19's start, off phase 8's solved window
# phase 21: the size of SCALE_1500KF.json (scripts/scale_1500kf.py, about
# KITTI 00): keyframes, points, observations; three LM iterations as there
SCALE_KF, SCALE_PTS, SCALE_OBS, SCALE_ITERS = 1442, 487556, 570794, 3
# the sharded step at world size 1 must equal gba_iteration on the same
# shard exactly; against the flat layout (1,048,576 observation slots
# against one shard's 570,880) only the order of the one-hot sums differs,
# and 24 PCG iterations on a 721 m chain of cameras carry that rounding
# into the poses (first chip run: t 0.154 m, R 2.2e-4, costs 2.6e-4): R and
# the costs are bounded, the rest reported
SCALE_TOL = {"R": 1e-3, "cost": 1e-3}
LIVE_TIMEOUT_S = 480       # phase 22, both ranks
# phase 23, the System's outputs. The arducam-style LEFT/RIGHT blocks of
# tests/test_config_io.py (640x480), written out as a settings file
ARDUCAM_YAML = """%YAML:1.0
Camera.fx: 435.2046959714599
Camera.fy: 435.2046959714599
Camera.cx: 367.4517211914062
Camera.cy: 252.2008514404297
Camera.width: 640
Camera.height: 480
LEFT.height: 480
LEFT.width: 640
LEFT.D: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data: [-0.28, 0.07, 0.0002, 0.00002, 0.0]
LEFT.K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [458.654, 0.0, 367.215, 0.0, 457.296, 248.375, 0.0, 0.0, 1.0]
LEFT.R: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
LEFT.P: !!opencv-matrix
   rows: 3
   cols: 4
   dt: d
   data: [435.2046959714599, 0, 367.4517211914062, 0, 0, 435.2046959714599, 252.2008514404297, 0, 0, 0, 1, 0]
RIGHT.height: 480
RIGHT.width: 640
RIGHT.D: !!opencv-matrix
   rows: 1
   cols: 5
   dt: d
   data: [-0.28, 0.07, 0.0002, 0.00002, 0.0]
RIGHT.K: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [457.587, 0.0, 379.999, 0.0, 456.134, 255.238, 0.0, 0.0, 1.0]
RIGHT.R: !!opencv-matrix
   rows: 3
   cols: 3
   dt: d
   data: [1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0]
RIGHT.P: !!opencv-matrix
   rows: 3
   cols: 4
   dt: d
   data: [435.2046959714599, 0, 367.4517211914062, -47.90639384423901, 0, 435.2046959714599, 252.2008514404297, 0, 0, 0, 1, 0]
"""
RECTIFY_DEG = 1.0      # the KITTI-width maps' rectifying rotation (left +, right -)
RECTIFY_TOL = 1e-3     # remap, card vs CPU, on 0-255 values
IDENTITY_TOL = 1e-4    # an identity map returns the image
PUBLISH_EVERY = 10     # publish_map every 10 frames, as run_slam.py --publish
POSE_TOL = 1e-6        # a published Twc against the rigid inverse of the returned pose
PGM_CELLS_BOUND = 2000  # map processor PGM, card vs CPU (about 0.2% of 1024x1024)
SOR_K = 50             # the gridmapper's setMeanK
SOR_SUBSET = 20_000    # points of phase 21's corridor held card vs CPU
SOR_RTOL = 1e-4        # mean kNN distances, card vs CPU
SOR_KEEP_AGREE = 0.999  # share of equal keep flags, card vs CPU
# phase 24, calibration: an 8x6 board of 0.108 m squares in 60 views at
# 640x480 through the lenses of ARDUCAM_YAML (LEFT/RIGHT K, D with k1 -0.28),
# the corners with 0.2 px of Gaussian noise; the right eye 0.12 m along x and
# turned 0.3 degrees about y
CALIB_BOARD = (8, 6, 0.108)          # inner corners (cols, rows), square size in m
CALIB_SIZE = (640, 480)
CALIB_VIEWS, CALIB_NOISE_PX, CALIB_SEED = 60, 0.2, 24
CALIB_LEFT_K = (458.654, 457.296, 367.215, 248.375)    # fx, fy, cx, cy
CALIB_RIGHT_K = (457.587, 456.134, 379.999, 255.238)
CALIB_DIST = (-0.28, 0.07, 0.0002, 0.00002, 0.0)        # k1 k2 p1 p2 k3
CALIB_BASELINE, CALIB_TOE_RAD = 0.12, np.deg2rad(0.3)
CALIB_TRUTH_PX = 5.0       # fx, fy, cx, cy of the card's solve against the truth
CALIB_RMS_MAX = 0.25       # px
CALIB_BASELINE_TOL = 0.01  # m
# the card's LM in tools.calibration.CALIB_DTYPE against the CPU's float64
# solve of the same views: K (fx, fy, cx, cy) in px, the rms in px
CALIB_K_TOL, CALIB_RMS_TOL = 0.05, 1e-3
VIEWER_STRIDE = 5          # run_slam.py --viz's stride
# phase 25, the scale proof's twin (scripts/torch_scale_1500kf.py) at the
# reference script's default of 1,500 keyframes asked for. The final counts
# are those scripts/scale_1500kf.py gives on this tree's reference code (CPU),
# which the twin's CPU test holds at 100 keyframes: SCALE_1500KF.json's
# 487,556 points were recorded before the reference's add_keyframe began
# re-validating bindings of culled points (its keyframes and observations
# are unchanged)
TWIN_REQUEST = 1500
TWIN_KF, TWIN_PTS, TWIN_OBS = 1442, 487577, 570794
RECORD_KF, RECORD_PTS, RECORD_OBS = 1442, 487556, 570794  # SCALE_1500KF.json
# phase 26, bench_torch's front-end microloop at KITTI width, one step on the
# card against the same step on the CPU: the pose in m and rad, and the match
# and inlier counts within the lane's descriptor rate (97% of descriptors
# identical, tests/test_torch_frame.py; hazard 3 flips descriptor bits)
FRONTEND_POSE_TOL = 1e-4
FRONTEND_COUNT_RATE = 0.03
# phase 27, the vocabulary builder: the first worlds of the L6 recipe
# (scripts/torch_train_vocab_l6.py: 10 frames a world at 560x420, 1,600
# features), trained at k=10, L=6 on the card and through the CPU path;
# then random descriptors at the size of the reference's L6 corpus, twice.
# World 0's frames, card against CPU extraction: identical keypoint slots
# and at least VOCAB_DESC_RATE of the descriptors identical (hazards 1-3 of
# ROADMAP.md queue 3)
VOCAB_WORLDS = 8
VOCAB_FULL, VOCAB_FULL_SEED = 4_000_000, 27
VOCAB_FULL_HELD = (0, 5)  # levels of the full-size run whose kernels are held against their plain versions
VOCAB_DESC_RATE = 0.997
VOCAB_KERNELS = ("vocab_assign", "vocab_majority", "vocab_seed_draw")
VOCAB_REPLACES = {"vocab_assign": "orb_slam2_2021_tpu/ops/hamming_pallas.py:37",
                  "vocab_majority": "orb_slam2_2021_tpu/place/vocab.py:51",
                  "vocab_seed_draw": "orb_slam2_2021_tpu/place/vocab.py:58"}


T_START = time.perf_counter()


def log(msg):
    """A line of the run's log, behind the seconds since the start."""
    print(f"[{time.perf_counter() - T_START:7.1f} s] {msg}", flush=True)


def card_info() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return res.stdout.strip().splitlines()[0]


def time_ms(fn, iters=50, warm=5):
    """Mean device time of one call, by CUDA events over `iters` calls
    after `warm` warm-up calls."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters=50, warm=5):
    """Mean device time of one call: CUDA events around `iters` calls queued
    behind a sleep kernel, so the card runs them back to back and the host's
    launch cost stays hidden."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = time.perf_counter() - t0
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2e9 * (2 * iters * one + 1e-3)))  # ~2 GHz SM clock
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# published peaks of one H100 SXM at 700 W (NVIDIA data sheet): the bounds
# below are the larger of bytes over the memory rate and int8 operations over
# the tensor cores' dense rate
H100_BYTES_PER_S = 3.35e12
H100_INT8_OPS_PER_S = 1979e12
H100_FP32_FLOPS_PER_S = 67e12  # outside the tensor cores
H100_FP64_TENSOR_FLOPS_PER_S = 67e12  # float64 on the tensor cores (data sheet)
LANE_MASK_DENSITY = 0.02     # open share of a lane matcher's candidate mask
MAPPING_MASK_DENSITY = 0.05  # of an epipolar or projection-window mask


def _bound(n_bytes, n_ops):
    """(bound in ms, "bytes" or "operations")."""
    t_bytes = 1e3 * n_bytes / H100_BYTES_PER_S
    t_ops = 1e3 * n_ops / H100_INT8_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def matrix_bound(n, m):
    """hamming_matrix: both packed inputs read once, the int16 matrix written
    once; 2*256 int8 operations per entry."""
    return _bound((n + m) * 32 + n * m * 2, 2 * n * m * 256)


def best2_bound(n, m, t):
    """hamming_best2: packed inputs and the bool mask read once, 20 bytes of
    results per row written once; 2*256 int8 operations per entry."""
    return _bound(n * 32 + t * m * 32 + t * n * m + t * n * 20, 2 * t * n * m * 256)


def _bits(rng, shape, p):
    """Packed words whose bits are set with probability p."""
    bits = rng.random((*shape, 32)) < p
    return np.packbits(bits, axis=-1, bitorder="little").view(np.uint32)[..., 0]


def hamming_inputs(rng, n, m, t, density, dev):
    """Descriptors and mask for one call. b holds near-copies of a's rows
    (small distances) and duplicated columns (ties: the first occurrence must
    win); the mask is open with probability `density`, and three rows are
    edge cases: row 0 all masked, row 1 all open, row 2 open at one column
    only. t=None gives b [m, 8] and mask [n, m], else b [t, m, 8] and mask
    [t, n, m]."""
    tt = 1 if t is None else t
    a = rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, (tt, m, 8), dtype=np.uint32)
    k = min(n, m) // 2
    if k:
        b[:, :k] = a[None, :k] ^ _bits(rng, (tt, k, 8), 0.04)
    if m >= 4:
        b[:, m // 2:m // 2 + m // 4] = b[:, :m // 4]
    mask = rng.random((tt, n, m)) < density
    mask[:, 0:1] = False
    mask[:, 1:2] = True
    if n > 2:
        mask[:, 2] = False
        mask[:, 2, min(5, m - 1)] = True
    if t is None:
        b, mask = b[0], mask[0]
    f = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(dev)  # noqa: E731
    return f(a.view(np.int32)), f(b.view(np.int32)), f(mask)


def _unfused(H, a, b, mask):
    """The chain the matchers ran before the fused kernel: the matrix
    kernel, where, then best_two."""
    if b.dim() == 2:
        d = H.hamming_matrix(a, b)
    else:
        T, M = b.shape[0], b.shape[1]
        d = H.hamming_matrix(a, b.reshape(T * M, 8)).view(a.shape[0], T, M).permute(1, 0, 2)
    return H.best_two(torch.where(mask, d, torch.full_like(d, H.MAX_DIST)))


def hold_hamming(a, b, mask, label):
    """Both launchers against their plain versions, exactly, and the fused
    one against itself on a second run. Returns the max abs error."""
    from orb_slam2_2021_tpu_torch.ops import hamming as H

    err = 0
    if b.dim() == 2:
        out, ref = H.hamming_matrix(a, b), H.hamming_matrix_plain(a, b)
        torch.cuda.synchronize()
        if out.dtype != torch.int16 or out.shape != ref.shape or not torch.equal(out, ref):
            raise AssertionError(f"hamming_matrix disagrees with its plain version at {label}")
        if out.numel():
            err = int((out.int() - ref.int()).abs().max())
    got = H.hamming_best2(a, b, mask)
    again = H.hamming_best2(a, b, mask)
    ref = H.hamming_best2_plain(a, b, mask)
    torch.cuda.synchronize()
    for name, x, y, z in zip(("best_idx", "best", "second_idx", "second"), got, ref, again):
        if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y):
            raise AssertionError(f"hamming_best2 {name} disagrees with its plain version at {label}")
        if not torch.equal(x, z):
            raise AssertionError(f"hamming_best2 {name} differs between two runs at {label}")
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    log(f"hamming {label}: hamming_matrix and hamming_best2 == plain (tolerance 0), "
        f"best2 repeatable")
    return err


def time_hamming(a, b, mask, label, iters=50):
    """Each launcher's device time (device_ms) in turns (plain, kernel,
    kernel, plain; better of two), beside its bound and its yardsticks: torch.cdist(p=0) on
    pre-unpacked float bits for the matrix (the port never calls it), the
    unfused chain for the fused launcher."""
    from orb_slam2_2021_tpu_torch.ops import hamming as H

    n = a.shape[0]
    bf = b.reshape(-1, 8)
    T, m = (1, b.shape[0]) if b.dim() == 2 else (b.shape[0], b.shape[1])
    shifts = torch.arange(32, device=a.device, dtype=torch.int32)
    fa = ((a[:, :, None] >> shifts) & 1).reshape(n, 256).float()
    fb = ((bf[:, :, None] >> shifts) & 1).reshape(-1, 256).float()
    few = max(3, iters // 5)

    def turns(kernel, plain, plain_iters):
        p1 = device_ms(plain, iters=plain_iters)
        k1 = device_ms(kernel, iters=iters)
        k2 = device_ms(kernel, iters=iters)
        p2 = device_ms(plain, iters=plain_iters)
        return min(k1, k2), min(p1, p2)

    mat_ms, mat_plain = turns(lambda: H.hamming_matrix(a, bf), lambda: H.hamming_matrix_plain(a, bf), few)
    lib = device_ms(lambda: torch.cdist(fa, fb, p=0), iters=few)
    b2_ms, b2_plain = turns(lambda: H.hamming_best2(a, b, mask),
                            lambda: H.hamming_best2_plain(a, b, mask), few)
    unfused = device_ms(lambda: _unfused(H, a, b, mask), iters=iters)
    mb, mby = matrix_bound(n, T * m)
    bb, bby = best2_bound(n, m, T)
    rows = {
        "hamming_matrix": {"shape": [n, T * m], "ms": mat_ms, "plain_ms": mat_plain, "bound_ms": mb,
                           "bound_by": mby, "library_ms": lib},
        "hamming_best2": {"shape": [T, n, m], "ms": b2_ms, "plain_ms": b2_plain, "bound_ms": bb,
                          "bound_by": bby, "library_ms": None, "unfused_ms": unfused},
    }
    log(f"hamming {label}: matrix {n}x{T * m} {mat_ms:.4f} ms (bound {mb:.4f} ms by {mby}, "
        f"{100 * mb / mat_ms:.0f}%), plain {mat_plain:.4f} ms, torch.cdist(p=0) {lib:.4f} ms; "
        f"best2 T={T} {n}x{m} {b2_ms:.4f} ms (bound {bb:.4f} ms by {bby}, {100 * bb / b2_ms:.0f}%), "
        f"plain {b2_plain:.4f} ms, unfused chain {unfused:.4f} ms "
        f"(device time by CUDA events behind a sleep, mean of {iters}, better of two runs)")
    return rows


def check_hamming(dev):
    """Phase 3: both launchers at the lane's shapes, the ragged shapes and
    M == 1, exactly; both timed at 4096x2000."""
    rng = np.random.default_rng(0)
    max_err, times = 0, {}
    for n, m in SHAPES + [(300, 1)]:
        density = LANE_MASK_DENSITY if n * m > 10 ** 6 else 0.3
        a, b, mask = hamming_inputs(rng, n, m, None, density, dev)
        max_err = max(max_err, hold_hamming(a, b, mask, f"{n}x{m}"))
        if (n, m) == (4096, 2000):
            times["lane"] = time_hamming(a, b, mask, f"{n}x{m} (local-point search)")
    return max_err, times


def check_hamming_mapping_shapes(dev):
    """Phase 6: the launchers at the mapping units' shapes, one keyframe's
    2000 features against T = 10 and 8 stacked keyframes (the matrix at
    2000 x T*2000, the fused launcher at [T, 2000, 2000]), and a small
    batched M == 1 case, exactly; both timed at T = 10."""
    rng = np.random.default_rng(1)
    max_err, times = 0, {}
    for n, m, t in MAPPING_SHAPES + [(70, 1, 3)]:
        a, b, mask = hamming_inputs(rng, n, m, t, MAPPING_MASK_DENSITY, dev)
        max_err = max(max_err, hold_hamming(a, b, mask, f"T={t} {n}x{m}"))
        flat = mask.permute(1, 0, 2).reshape(n, t * m).contiguous()  # the T sets as one
        max_err = max(max_err, hold_hamming(a, b.reshape(t * m, 8), flat, f"{n}x{t * m}"))
        if t == 10:
            times["mapping"] = time_hamming(a, b, mask, f"T={t} {n}x{m} (triangulation)", iters=20)
    return max_err, times


def render_frames(cfg, n_frames, step, seed):
    from orb_slam2_2021_tpu_torch.io.synthetic import SyntheticStereoWorld, forward_trajectory

    world = SyntheticStereoWorld(cfg, seed=seed)
    gt = forward_trajectory(n_frames, step=step)
    frames = []
    for R, t in gt:
        left, right = world.render(R, t)
        frames.append(np.clip(np.stack([left, right]), 0, 255).astype(np.uint8))
    return frames, gt


def check_small_against_cpu(dev):
    """The lane on CUDA vs the port's CPU path (held against JAX by the
    tests) on a 320x240 sequence: same tracked flags and keyframes, poses
    within 1 mm / 1e-3."""
    from orb_slam2_2021_tpu_torch.config import synthetic_config
    from orb_slam2_2021_tpu_torch.pipeline.system import System

    cfg = synthetic_config(width=320, height=240)
    frames, _ = render_frames(cfg, 6, 0.12, 3)
    gpu = System(cfg, enable_mapping=False, device=dev)
    cpu = System(cfg, enable_mapping=False, device="cpu")
    worst = 0.0
    for i, pair in enumerate(frames):
        pg = gpu.track_stereo(pair[0], pair[1], timestamp=0.1 * i)
        pc = cpu.track_stereo(pair[0], pair[1], timestamp=0.1 * i)
        if (pg is None) != (pc is None) or gpu.map.n_kf != cpu.map.n_kf:
            raise AssertionError(f"small sequence frame {i}: CUDA and CPU tracking differ")
        if pg is not None:
            worst = max(worst, float(np.abs(pg[1] - pc[1]).max()), float(np.abs(pg[0] - pc[0]).max()))
    if worst > 1e-3:
        raise AssertionError(f"small sequence: CUDA vs CPU pose difference {worst:.2e} > 1e-3")
    log(f"small 320x240 sequence: CUDA lane agrees with the CPU path (max pose diff {worst:.2e})")


def check_mapping_small_against_cpu(dev):
    """The System with local mapping and the grid on, CUDA vs the port's CPU
    path (held against the JAX System by the tests) on the tests' 320x240
    sequence: same tracked flags, keyframe counts and local-BA solves; poses
    and live map-point counts within the stated tolerances."""
    from orb_slam2_2021_tpu_torch.config import synthetic_config
    from orb_slam2_2021_tpu_torch.pipeline.system import System

    cfg = synthetic_config(width=320, height=240)
    frames, _ = render_frames(cfg, SMALL_MAP_FRAMES, 0.12, 3)
    gpu = System(cfg, enable_mapping=True, enable_loop_closing=False, device=dev)
    cpu = System(cfg, enable_mapping=True, enable_loop_closing=False, device="cpu")
    worst, worst_pts = 0.0, 0.0
    for i, pair in enumerate(frames):
        pg = gpu.track_stereo(pair[0], pair[1], timestamp=0.1 * i)
        pc = cpu.track_stereo(pair[0], pair[1], timestamp=0.1 * i)
        if (pg is None) != (pc is None) or gpu.map.n_kf != cpu.map.n_kf:
            raise AssertionError(f"mapping-on small sequence frame {i}: CUDA and CPU tracking differ")
        if pg is not None:
            worst = max(worst, float(np.abs(pg[1] - pc[1]).max()), float(np.abs(pg[0] - pc[0]).max()))
        n_g, n_c = int(gpu.map.mp_valid.sum()), int(cpu.map.mp_valid.sum())
        worst_pts = max(worst_pts, abs(n_g - n_c) / max(n_c, 1))
    gpu.shutdown()
    cpu.shutdown()
    n_ba = (len(gpu.local_mapper.ba_solve_times), len(cpu.local_mapper.ba_solve_times))
    log(f"mapping-on 320x240 sequence, {SMALL_MAP_FRAMES} frames: {gpu.map.n_kf} keyframes, "
        f"local BA solves {n_ba[0]} (CUDA) / {n_ba[1]} (CPU), max pose diff {worst:.2e} "
        f"(tolerance {SMALL_MAP_POSE_TOL}), max relative map-point count diff {worst_pts:.4f} "
        f"(tolerance {SMALL_MAP_POINTS_TOL})")
    if n_ba[0] != n_ba[1] or n_ba[0] < 1:
        raise AssertionError(f"local BA solves differ or never ran: {n_ba}")
    if worst > SMALL_MAP_POSE_TOL or worst_pts > SMALL_MAP_POINTS_TOL:
        raise AssertionError("mapping-on small sequence: CUDA and CPU disagree beyond tolerance")
    occ = int((gpu.occupancy_grid().data == 100).sum())
    if occ == 0:
        raise AssertionError("mapping-on small sequence: empty occupancy grid")


def _ate(est, gt):
    from orb_slam2_2021_tpu_torch.io.trajectory import ate_rmse

    gt_mats = []
    for R, t in gt[: len(est)]:
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        gt_mats.append(T)
    length = float(sum(np.linalg.norm(gt[i + 1][1] - gt[i][1]) for i in range(len(gt) - 1)))
    return ate_rmse(est, gt_mats), length


def _ate_alignment(est, gt):
    """The rigid map from the estimate's frame to the ground truth's that
    ate_rmse fits (Horn on the camera centres), as a function of a point."""
    e = np.asarray([T[:3, 3] for T in est], np.float64)
    g = np.asarray([t for _, t in gt[: len(est)]], np.float64)
    mu_e, mu_g = e.mean(0), g.mean(0)
    U, _, Vt = np.linalg.svd((e - mu_e).T @ (g - mu_g))
    S = np.eye(3)
    if np.linalg.det(U @ Vt) < 0:
        S[2, 2] = -1
    R = Vt.T @ S @ U.T
    return lambda x: R @ (np.asarray(x, np.float64) - mu_e) + mu_g


def render_orbit():
    """The bench's world and path at KITTI width, as bench_torch.py renders
    them: SyntheticCylinderWorld(seed 7) on orbit_trajectory(144, 630
    degrees, r 1.5 m), uint8 pairs, rendered by forked processes. Call it
    before anything touches the card: the children inherit the world, never
    a CUDA context."""
    import bench_torch
    from orb_slam2_2021_tpu_torch.config import kitti_stereo_config

    t0 = time.perf_counter()
    frames, gt = bench_torch.orbit_frames(kitti_stereo_config(), N_ORBIT)
    log(f"rendered {len(frames)} cylinder-world frames in {time.perf_counter() - t0:.1f} s")
    return frames, gt


def drive_kitti_mapping(dev, frames, gt, dense=False, publish=False, viz_dir=None):
    """Mapping on at KITTI width over the first N_MAP_FRAMES frames of the
    bench's orbit in the cylinder world; Hamming launches from the mapping
    units are counted apart from the lane's. `dense`: the dense local BA
    (use_cg_local_ba=False, phase 20). `publish`: phase 23's pub/sub on
    the drive, outside the timed calls. `viz_dir`: phase 24's Viewer
    (stride VIEWER_STRIDE) writing its PNGs there, outside the timed calls."""
    import dataclasses

    from orb_slam2_2021_tpu_torch.config import kitti_stereo_config
    from orb_slam2_2021_tpu_torch.ops.hamming import HAMMING_BEST2_KERNEL, HAMMING_KERNEL
    from orb_slam2_2021_tpu_torch.pipeline.system import System

    cfg = kitti_stereo_config()
    if dense:
        cfg = cfg.replace(optim=dataclasses.replace(cfg.optim, use_cg_local_ba=False))
    label = "kitti dense-BA mapping drive" if dense else "kitti mapping drive"
    frames, gt = frames[:N_MAP_FRAMES], gt[:N_MAP_FRAMES]
    sys_ = System(cfg, enable_mapping=True, enable_loop_closing=False, device=dev)

    lm = sys_.local_mapper
    counts = {"mapping": 0, "keyframes": 0}
    process = lm.process_pending

    def counted_process():
        n0, q = HAMMING_BEST2_KERNEL.launches, len(lm.queue)
        process()
        counts["mapping"] += HAMMING_BEST2_KERNEL.launches - n0
        counts["keyframes"] += q

    lm.process_pending = counted_process
    pub = DrivePublisher(sys_) if publish else None
    viewer = DriveViewer(sys_, viz_dir) if viz_dir else None
    HAMMING_BEST2_KERNEL.reset_counts()
    HAMMING_KERNEL.reset_counts()
    tracked = 0
    for i, pair in enumerate(frames):
        pose = sys_.track_stereo(pair[0], pair[1], timestamp=0.1 * i)
        if pose is not None:
            tracked += 1
        if pub is not None:
            pub.frame(i, 0.1 * i, pose)
        if viewer is not None:
            viewer.frame(pair[0])
    sys_.shutdown()
    launches, matrix_launches = HAMMING_BEST2_KERNEL.launches, HAMMING_KERNEL.launches
    published = pub.check(label, sync=True) if pub is not None else None
    viewed = viewer.check(label, len(frames)) if viewer is not None else None

    ate, length = _ate(sys_.trajectory_kitti(), gt)
    ms = 1e3 * np.asarray(sys_.frame_times)
    kf_rows = [r for r in sys_.metrics if r["keyframe"]]
    ms_kf = [r["ms_total"] for r in kf_rows]
    ms_map = [r["ms_mapping"] for r in kf_rows]
    ba_ms = [1e3 * s for s, _ in lm.ba_solve_times]
    n_created = int(sys_.map.next_mp)
    n_init = int((sys_.map.mp_first_kf == 0).sum())
    occ = int((sys_.occupancy_grid().data == 100).sum())
    log(f"{label} {cfg.width}x{cfg.height}: {tracked}/{N_MAP_FRAMES} tracked, "
        f"{sys_.map.n_kf} live keyframes ({sys_.map.next_kf} created), "
        f"{len(ba_ms)} local BA solves, {sys_.map.next_mp} map points created "
        f"({int(sys_.map.mp_valid.sum())} live), {occ} occupied grid cells, "
        f"ATE {ate:.4f} m over {length:.3f} m")
    log(f"per-frame ms (host clock): median {np.median(ms):.2f}, median over keyframe frames "
        f"{np.median(ms_kf):.2f}, max {ms.max():.2f}")
    log(f"ms_mapping per keyframe frame: {[round(x, 2) for x in ms_map]}")
    log(f"{label}: local BA ms per solve (15 LM iterations, ends in the device->host read): "
        f"{[round(x, 2) for x in ba_ms]}")
    log(f"hamming_best2 launches: {launches} in the drive, {counts['mapping']} from the mapping "
        f"units over {counts['keyframes']} keyframes "
        f"({counts['mapping'] / max(counts['keyframes'], 1):.1f} per keyframe); "
        f"hamming_matrix launches: {matrix_launches}")
    if tracked < N_MAP_FRAMES - 2:
        raise AssertionError(f"tracked {tracked}/{N_MAP_FRAMES} frames")
    if sys_.map.next_kf < 4:
        raise AssertionError(f"only {sys_.map.next_kf} keyframes")
    if len(ba_ms) < 2:
        raise AssertionError(f"only {len(ba_ms)} local BA solves")
    if n_created - n_init <= 0:
        raise AssertionError("no map points beyond the initial keyframe's")
    if occ <= 0:
        raise AssertionError("empty occupancy grid")
    if not (np.isfinite(ate) and ate < 0.05 * length):
        raise AssertionError(f"ATE {ate:.4f} m is not below 5% of {length:.3f} m")
    if counts["mapping"] <= 0:
        raise AssertionError("the mapping units never launched hamming_best2")
    if matrix_launches != 0:
        raise AssertionError(f"the mapping drive launched hamming_matrix {matrix_launches} times")
    return {"launches": launches, "mapping_launches": counts["mapping"],
            "keyframes": counts["keyframes"], "matrix_launches": matrix_launches,
            "ba_ms": ba_ms, "system": sys_, "published": published, "viewed": viewed}


def _sim3_matches(rng, n=500):
    """Matched points in two camera frames under a known rigid S12 (25%
    gross outliers) with noisy KITTI-intrinsic pixels."""
    ang = np.deg2rad(9.0)
    R12 = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0], [-np.sin(ang), 0, np.cos(ang)]])
    x2 = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 12, n)], 1)
    x1 = x2 @ R12.T + np.array([0.4, -0.1, 0.3])
    bad = rng.random(n) < 0.25
    x1[bad] += rng.normal(0, 1.0, (bad.sum(), 3))

    def proj(x):
        return np.stack([718.856 * x[:, 0] / x[:, 2] + 607.19, 718.856 * x[:, 1] / x[:, 2] + 185.22], 1)

    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return (f(x1), f(x2), f(proj(x1) + rng.normal(0, 0.5, (n, 2))),
            f(proj(x2) + rng.normal(0, 0.5, (n, 2))), f(np.ones(n)), f(np.full(n, 1.44)),
            torch.ones(n, dtype=torch.bool))


def _pnp_matches(rng, n=2000):
    """A frame's 2000 feature slots, 40% matched to map points under a known
    pose, 30% of those gross outliers."""
    xw = np.stack([rng.uniform(-4, 4, n), rng.uniform(-2, 2, n), rng.uniform(5, 15, n)], 1)
    a = np.deg2rad(4.0)
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
    xc = xw @ R.T + np.array([0.1, 0.0, -0.3])
    uv = np.stack([718.856 * xc[:, 0] / xc[:, 2] + 607.19, 718.856 * xc[:, 1] / xc[:, 2] + 185.22], 1)
    uv += rng.normal(0, 0.5, uv.shape)
    bad = rng.random(n) < 0.3
    uv[bad] += rng.uniform(-40, 40, (bad.sum(), 2))
    valid = rng.random(n) < 0.4
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return [f(xw), f(uv), f(np.ones(n)), torch.from_numpy(valid)], valid


def _ring_pose_graph(rng, K=24, K_pad=32, E_pad=256):
    """Keyframes on a circle with accumulated drift, odometry and covisibility
    edges and one loop edge, padded as loop closing pads it."""
    from orb_slam2_2021_tpu_torch.geometry.sim3 import sim3_compose, sim3_exp, sim3_inverse
    from orb_slam2_2021_tpu_torch.optim.sim3_opt import PoseGraph

    ang = torch.linspace(0, 2 * np.pi * (K - 1) / K, K)
    xi = torch.zeros(K, 7)
    xi[:, 4] = ang
    xi[:, 0] = 3.0 * torch.cos(ang)
    xi[:, 2] = 3.0 * torch.sin(ang)
    gt = sim3_exp(xi)
    drift = torch.from_numpy(rng.normal(0, 0.01, (K, 7)).astype(np.float32)).cumsum(0)
    drift[:, 6] = 0
    est = sim3_compose(*sim3_exp(drift), *gt)
    ei = list(range(K - 1)) + list(range(K - 3)) + [K - 1]
    ej = list(range(1, K)) + list(range(3, K)) + [0]
    meas = []
    for e, (a, b) in enumerate(zip(ei, ej)):
        S = gt if e == len(ei) - 1 else est
        meas.append(sim3_compose(S[0][a], S[1][a], S[2][a], *sim3_inverse(S[0][b], S[1][b], S[2][b])))

    def pad(x, n, fill):
        out = fill(n)
        out[: len(x)] = x
        return out

    eye = lambda n: torch.eye(3).repeat(n, 1, 1)  # noqa: E731
    zeros3 = lambda n: torch.zeros(n, 3)  # noqa: E731
    zeros_i = lambda n: torch.zeros(n, dtype=torch.int64)  # noqa: E731
    return PoseGraph(
        s=pad(est[0], K_pad, torch.ones), R=pad(est[1], K_pad, eye), t=pad(est[2], K_pad, zeros3),
        edge_i=pad(torch.tensor(ei), E_pad, zeros_i), edge_j=pad(torch.tensor(ej), E_pad, zeros_i),
        m_s=pad(torch.stack([m[0] for m in meas]), E_pad, torch.ones),
        m_R=pad(torch.stack([m[1] for m in meas]), E_pad, eye),
        m_t=pad(torch.stack([m[2] for m in meas]), E_pad, zeros3),
        weight=pad(torch.ones(len(ei)), E_pad, torch.zeros),
        fixed=pad(torch.arange(K) == 0, K_pad, lambda n: torch.ones(n, dtype=torch.bool)),
    )


def check_loop_numerics(dev):
    """Loop-closing units on the card against the CPU path (held against the
    JAX reference by the tests), the same RANSAC samples on both devices;
    each timed on the card by CUDA events. Returns {unit: ms}."""
    from orb_slam2_2021_tpu_torch.optim.sim3_opt import essential_graph_solve, optimize_sim3_relative
    from orb_slam2_2021_tpu_torch.place.bundle import PlaceRecognition
    from orb_slam2_2021_tpu_torch.solvers.epnp import epnp_ransac
    from orb_slam2_2021_tpu_torch.solvers.horn_sim3 import sample_indices, sim3_ransac

    rng = np.random.default_rng(3)
    ms = {}
    pr = PlaceRecognition.load_default(dev)
    desc = torch.from_numpy(rng.integers(0, 2 ** 32, (2000, 8), dtype=np.uint32).view(np.int32))
    valid = torch.from_numpy(rng.random(2000) < 0.95)
    dd, dv = desc.to(dev), valid.to(dev)
    words = pr.transform(dd, dv)
    if not torch.equal(words.cpu(), pr.transform(desc, valid)):
        raise AssertionError("vocab_transform: CUDA words differ from the CPU path")
    ms["vocab_transform_2000"] = time_ms(lambda: pr.transform(dd, dv), iters=20)
    log(f"vocab_transform, 10^6-word tree, 2000 descriptors: CUDA == CPU (tolerance 0), "
        f"{ms['vocab_transform_2000']:.3f} ms")

    fx, fy, cx, cy = 718.856, 718.856, 607.19, 185.22
    args = _sim3_matches(rng)
    idx = sample_indices(np.ones(500, bool), 3, 128, torch.Generator().manual_seed(2000))
    out = {}
    for d in ("cpu", dev):
        a = [x.to(d) for x in args]
        s, R, t, inl, _ = sim3_ransac(idx.to(d), *a, fx, fy, cx, cy, True)
        sr, Rr, tr, inr, _ = optimize_sim3_relative(s, R, t, *a[:4], 1.0 / a[4], 1.0 / a[5], a[6],
                                                    fx, fy, cx, cy, True)
        out[str(d)] = [x.cpu() for x in (R, t, inl, Rr, tr, inr)]
    c, g = out["cpu"], out[str(dev)]
    dR = max(float((c[0] - g[0]).abs().max()), float((c[3] - g[3]).abs().max()))
    dt = max(float((c[1] - g[1]).abs().max()), float((c[4] - g[4]).abs().max()))
    if not (torch.equal(c[2], g[2]) and torch.equal(c[5], g[5])) or dR > 1e-4 or dt > 1e-3:
        raise AssertionError(f"Sim3 RANSAC/refine: CUDA vs CPU inliers differ or R {dR:.2e} / t {dt:.2e}")
    a = [x.to(dev) for x in args]
    di = idx.to(dev)
    ms["sim3_ransac_128x500"] = time_ms(lambda: sim3_ransac(di, *a, fx, fy, cx, cy, True), iters=10)
    s0, R0, t0 = (x.to(dev) for x in (torch.tensor(1.0), c[0], c[1]))
    ms["sim3_refine_500"] = time_ms(lambda: optimize_sim3_relative(
        s0, R0, t0, *a[:4], 1.0 / a[4], 1.0 / a[5], a[6], fx, fy, cx, cy, True), iters=5, warm=2)
    log(f"Sim3 RANSAC (128 hypotheses, 500 matches) + refine: inlier masks identical, R within "
        f"{dR:.2e}, t within {dt:.2e} m (tolerances 1e-4, 1e-3); {ms['sim3_ransac_128x500']:.3f} ms "
        f"and {ms['sim3_refine_500']:.3f} ms")

    pargs, pvalid = _pnp_matches(rng)
    pidx = sample_indices(pvalid, 6, 256, torch.Generator().manual_seed(21))
    out = {}
    for d in ("cpu", dev):
        out[str(d)] = [x.cpu() for x in epnp_ransac(pidx.to(d), *[x.to(d) for x in pargs], fx, fy, cx, cy)]
    c, g = out["cpu"], out[str(dev)]
    dR, dt = float((c[0] - g[0]).abs().max()), float((c[1] - g[1]).abs().max())
    # the refit's normal equations are float32 products summed in another
    # order by cuBLAS, so a match on the chi2 gate can flip: a rate, not
    # identity
    n_flip = int((c[2] != g[2]).sum())
    if n_flip > max(2, int(0.01 * int(c[3]))) or dR > 1e-3 or dt > 1e-2:
        raise AssertionError(f"EPnP RANSAC: CUDA vs CPU {n_flip} inliers differ, R {dR:.2e} / t {dt:.2e}")
    pa, pi = [x.to(dev) for x in pargs], pidx.to(dev)
    ms["epnp_ransac_256x2000"] = time_ms(lambda: epnp_ransac(pi, *pa, fx, fy, cx, cy), iters=5, warm=2)
    log(f"EPnP RANSAC (256 hypotheses, 2000 slots, {int(c[3])} inliers on the CPU, {int(g[3])} on "
        f"the card): {n_flip} inlier flags differ (tolerance 1% of the inliers), R within {dR:.2e}, "
        f"t within {dt:.2e} m (tolerances 1e-3, 1e-2); {ms['epnp_ransac_256x2000']:.3f} ms")

    gph = _ring_pose_graph(rng)
    sc, Rc, tc = essential_graph_solve(gph, fix_scale=True)
    gg = type(gph)(*(x.to(dev) for x in gph))
    first = essential_graph_solve(gg, fix_scale=True)
    again = essential_graph_solve(gg, fix_scale=True)
    dR = float((Rc - first[1].cpu()).abs().max())
    dt = float((tc - first[2].cpu()).abs().max())
    if not all(torch.equal(x, y) for x, y in zip(first, again)) or dR > 1e-4 or dt > 1e-3:
        raise AssertionError(f"essential graph: not repeatable on the card, or R {dR:.2e} / t {dt:.2e}")
    ms["essential_graph_K32_E256"] = time_ms(lambda: essential_graph_solve(gg, fix_scale=True),
                                             iters=2, warm=1)
    log(f"essential graph (32 vertices, 256 edges, 20 LM x 40 PCG): repeatable on the card, "
        f"R within {dR:.2e}, t within {dt:.2e} m of the CPU path (tolerances 1e-4, 1e-3); "
        f"{ms['essential_graph_K32_E256']:.1f} ms")
    return ms


def check_reloc_small_against_cpu(dev):
    """A map from the port's CPU path at 320x240 (the drive of
    tests/test_persistence.py), saved, booted on CUDA and on the CPU, both
    shown the frame at gt[8]: same keyframe, poses within 1 mm / 1e-3."""
    import tempfile

    from orb_slam2_2021_tpu_torch.config import synthetic_config
    from orb_slam2_2021_tpu_torch.pipeline.system import System

    cfg = synthetic_config(width=320, height=240)
    frames, _ = render_frames(cfg, 28, 0.12, 6)
    t0 = time.perf_counter()
    cpu = System(cfg, device="cpu")
    for i, pair in enumerate(frames):
        cpu.track_stereo(pair[0], pair[1], timestamp=0.1 * i)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "map.npz")
        cpu.save_map(path)
        log(f"320x240 map on the CPU path: {cpu.map.n_kf} keyframes, "
            f"{int(cpu.map.mp_valid.sum())} map points, {time.perf_counter() - t0:.1f} s")
        booted = {d: System.from_map_file(cfg, path, device=d) for d in ("cpu", dev)}
    res = {}
    for d, s in booted.items():
        landed = {}
        bow = s.tracker._relocalize_bow

        def hooked(*a, s=s, bow=bow, landed=landed):
            ok = bow(*a)
            landed["kf"] = s.tracker.ref_kf if ok else None
            return ok

        s.tracker._relocalize_bow = hooked
        pose = s.track_stereo(frames[8][0], frames[8][1], timestamp=99.0)
        res[d] = (pose, landed.get("kf"), s.tracker.state.name)
    (pc, kc, sc), (pg, kg, sg) = res["cpu"], res[dev]
    if pc is None or pg is None or kc is None or kc != kg or sc != sg or sg != "OK":
        raise AssertionError(f"320x240 relocalization: CUDA {kg} {sg} vs CPU {kc} {sc}")
    worst = max(float(np.abs(pg[1] - pc[1]).max()), float(np.abs(pg[0] - pc[0]).max()))
    log(f"320x240 save/load/relocalize: CUDA and CPU both on keyframe {kg}, state OK, "
        f"max pose diff {worst:.2e} (tolerance 1e-3)")
    if worst > 1e-3:
        raise AssertionError("320x240 relocalization: CUDA and CPU poses differ beyond 1e-3")


def drive_kitti_default(dev, frames, gt, map_path):
    """The System at the reference's defaults over the whole orbit at KITTI
    width. Hamming launches are counted per path: all of them over the
    drive, those inside the mapping units, inside loop closing, and per loop
    stage; the loop closer's Hamming shapes are recorded. The map is saved
    to `map_path` (phase 23 reads it)."""
    from orb_slam2_2021_tpu_torch.config import kitti_stereo_config
    from orb_slam2_2021_tpu_torch.frontend import matchers
    from orb_slam2_2021_tpu_torch.ops.hamming import HAMMING_BEST2_KERNEL, HAMMING_KERNEL, hamming_best2
    from orb_slam2_2021_tpu_torch.pipeline import mapping_steps
    from orb_slam2_2021_tpu_torch.pipeline.system import System

    cfg = kitti_stereo_config()
    sys_ = System(cfg, device=dev)
    lm, lc = sys_.local_mapper, sys_.loop_closer
    if lc is None or sys_.place.voc.L != 6:
        raise AssertionError("the default System has no loop closer or not the 10^6-word vocabulary")
    counts = {"mapping_and_loop": 0, "loop_closing": 0, "compute_sim3": 0, "correct_loop": 0}
    shapes = set()
    loops, replays = [], []

    def counting(fn, key, record_shapes=False):
        def wrapped(*a, **kw):
            n0 = HAMMING_BEST2_KERNEL.launches
            if record_shapes:
                def rec(x, y, mask):  # (N, M, T): T = 0 for a [M, 8] side
                    shapes.add((int(x.shape[0]), int(y.shape[-2]), int(y.shape[0]) if y.dim() == 3 else 0))
                    return hamming_best2(x, y, mask)
                matchers.hamming_best2 = mapping_steps.hamming_best2 = rec
            try:
                return fn(*a, **kw)
            finally:
                matchers.hamming_best2 = mapping_steps.hamming_best2 = hamming_best2
                counts[key] += HAMMING_BEST2_KERNEL.launches - n0
        return wrapped

    correct = lc._correct_loop

    def correct_hook(k, loop_kf, *a):
        loops.append((len(sys_.frame_times), k, loop_kf))
        return correct(k, loop_kf, *a)

    lc._correct_loop = correct_hook
    lm.process_pending = counting(lm.process_pending, "mapping_and_loop")
    lc.process_pending = counting(lc.process_pending, "loop_closing")
    lc._compute_sim3 = counting(lc._compute_sim3, "compute_sim3", record_shapes=True)
    lc._correct_loop = counting(lc._correct_loop, "correct_loop", record_shapes=True)
    process_new = sys_.grid_mapper.process_new

    def grid_hook(loop_closed=False):
        if loop_closed:
            replays.append(len(sys_.frame_times))
        return process_new(loop_closed)

    sys_.grid_mapper.process_new = grid_hook

    HAMMING_BEST2_KERNEL.reset_counts()
    HAMMING_KERNEL.reset_counts()
    tracked = 0
    for i, pair in enumerate(frames):
        if sys_.track_stereo(pair[0], pair[1], timestamp=0.1 * i) is not None:
            tracked += 1
    sys_.shutdown()
    launches, matrix_launches = HAMMING_BEST2_KERNEL.launches, HAMMING_KERNEL.launches

    est = sys_.trajectory_kitti()
    ate, length = _ate(est, gt)
    ms = 1e3 * np.asarray(sys_.frame_times)
    log(f"kitti default-System drive {cfg.width}x{cfg.height}: {tracked}/{len(frames)} tracked, "
        f"{sys_.map.n_kf} live keyframes ({sys_.map.next_kf} created), "
        f"{int(sys_.map.mp_valid.sum())} live map points, {lc.n_loops} loop(s), "
        f"ATE {ate:.4f} m over {length:.3f} m")
    log(f"per-frame ms (host clock): median {np.median(ms):.2f}, max {ms.max():.2f}")
    for frame, k, loop_kf in loops:
        log(f"loop at frame {frame}: keyframe {k} against keyframe {loop_kf} "
            f"(JAX reference on the CPU: frame {REF_LOOP_FRAME}, keyframe {REF_LOOP_PAIR[0]} "
            f"against keyframe {REF_LOOP_PAIR[1]})")
    lt = lc.loop_times
    if loops:
        f0 = loops[0][0]
        log(f"loop frame {f0}: {ms[f0]:.1f} ms in all; compute_sim3 {1e3 * lt['compute_sim3']:.1f} ms, "
            f"correction {1e3 * lt['correct']:.1f} ms, essential graph {1e3 * lt['essential_graph']:.1f} ms, "
            f"global BA {1e3 * lt['global_ba']:.1f} ms (runs {lc.gba_runs}); grid replayed at frames "
            f"{replays}")
    mapping_units = counts["mapping_and_loop"] - counts["loop_closing"]
    log(f"hamming_best2 launches: {launches} in the drive, {mapping_units} from the mapping units, "
        f"{counts['loop_closing']} from loop closing ({counts['compute_sim3']} in compute_sim3, "
        f"{counts['correct_loop']} in correct_loop); loop-closing shapes (N, M, T) {sorted(shapes)}; "
        f"hamming_matrix launches: {matrix_launches}")
    if tracked < len(frames) - 2:
        raise AssertionError(f"tracked {tracked}/{len(frames)} frames")
    if lc.n_loops < 1 or not loops:
        raise AssertionError("no loop closed")
    if (loops[0][1], loops[0][2]) != REF_LOOP_PAIR or abs(loops[0][0] - REF_LOOP_FRAME) > 5:
        raise AssertionError(f"loop {loops[0]} is not the reference's pair {REF_LOOP_PAIR} "
                             f"near frame {REF_LOOP_FRAME}")
    if not any(r["iters"] for r in lc.gba_runs):
        raise AssertionError("global BA never ran")
    if not replays or replays[0] != loops[0][0]:
        raise AssertionError(f"the grid was not replayed on the loop frame: {replays}")
    if not (np.isfinite(ate) and ate < 0.05 * length):
        raise AssertionError(f"ATE {ate:.4f} m is not below 5% of {length:.3f} m")
    if counts["loop_closing"] <= 0 or mapping_units <= 0:
        raise AssertionError("mapping or loop closing never launched hamming_best2")
    if matrix_launches != 0:
        raise AssertionError(f"the default drive launched hamming_matrix {matrix_launches} times")

    # save, boot from the file on the card, relocalize a mid-orbit frame; its
    # camera centre, put in the ground truth's frame by the drive's ATE
    # alignment, must meet the ATE bound
    sys_.save_map(map_path)
    booted = System.from_map_file(cfg, map_path, device=dev)
    t0 = time.perf_counter()
    pose = booted.track_stereo(frames[RELOC_FRAME][0], frames[RELOC_FRAME][1], timestamp=99.0)
    t_reloc = time.perf_counter() - t0
    if pose is None or booted.tracker.state.name != "OK":
        raise AssertionError("relocalization against the reloaded KITTI-width map failed")
    c_reloc = -pose[0].T @ pose[1]
    to_gt = _ate_alignment(est, gt)
    err = float(np.linalg.norm(to_gt(c_reloc) - gt[RELOC_FRAME][1]))
    d = float(np.linalg.norm(c_reloc - est[RELOC_FRAME][:3, 3]))
    log(f"reloaded map ({booted.map.n_kf} keyframes): frame {RELOC_FRAME} relocalized on keyframe "
        f"{booted.tracker.ref_kf} in {1e3 * t_reloc:.1f} ms; aligned error {err:.4f} m against the "
        f"ground truth (bound 5% of {length:.3f} m), {d:.4f} m from the drive's own estimate")
    if not err < 0.05 * length:
        raise AssertionError(f"relocalized {err:.3f} m away from the ground truth")
    return {"launches": launches, "mapping_launches": mapping_units,
            "loop_launches": counts["loop_closing"], "shapes": sorted(shapes),
            "matrix_launches": matrix_launches, "ms": ms}


def check_hamming_loop_shapes(dev, shapes):
    """Phase 11: both launchers at the two largest shapes loop closing gave
    the fused launcher in the drive, exactly, with a half-open mask (the
    descriptor-only matcher's mask is valid x valid); both timed."""
    rng = np.random.default_rng(2)
    max_err, times = 0, {}
    for n, m, t in sorted(shapes, key=lambda s: s[0] * s[1] * max(s[2], 1))[-2:]:
        a, b, mask = hamming_inputs(rng, n, m, t or None, 0.5, dev)
        label = f"{n}x{m}" + (f" T={t}" if t else "")
        max_err = max(max_err, hold_hamming(a, b, mask, f"{label} (loop-closing shape)"))
        times[f"loop {label}"] = time_hamming(a, b, mask, f"{label} (loop-closing shape)", iters=20)
    return max_err, times


def check_hamming_sensor_shapes(dev, shapes, loop_shapes):
    """The fused launcher at the largest shape the RGB-D and monocular drives
    gave it that phases 3, 6 and 11 did not already hold, exactly, with a
    mask open at MAPPING_MASK_DENSITY; timed."""
    known = {(n, m, 0) for n, m in SHAPES} | set(MAPPING_SHAPES) | set(loop_shapes)
    new = sorted(shapes - known, key=lambda s: s[0] * s[1] * max(s[2], 1))
    log(f"hamming_best2 shapes (N, M, T) in the RGB-D and monocular drives: {len(shapes)} distinct, "
        f"{len(new)} not held before; largest {new[-1] if new else None}")
    if not new:
        return 0, {}
    n, m, t = new[-1]
    rng = np.random.default_rng(4)
    a, b, mask = hamming_inputs(rng, n, m, t or None, MAPPING_MASK_DENSITY, dev)
    label = f"{n}x{m}" + (f" T={t}" if t else "")
    err = hold_hamming(a, b, mask, f"{label} (sensor-drive shape)")
    return err, {f"sensors {label}": time_hamming(a, b, mask, f"{label} (sensor-drive shape)", iters=20)}


def drive_kitti(dev):
    from orb_slam2_2021_tpu_torch.config import kitti_stereo_config
    from orb_slam2_2021_tpu_torch.io.trajectory import ate_rmse
    from orb_slam2_2021_tpu_torch.frontend.frame import build_stereo_frame_from_u8
    from orb_slam2_2021_tpu_torch.ops.hamming import HAMMING_BEST2_KERNEL, HAMMING_KERNEL
    from orb_slam2_2021_tpu_torch.pipeline.system import System

    cfg = kitti_stereo_config()
    frames, gt = render_frames(cfg, N_FRAMES, STEP, WORLD_SEED)
    sys_ = System(cfg, enable_mapping=False, device=dev)

    # every Frame tensor lives on the card
    frame = build_stereo_frame_from_u8(torch.from_numpy(frames[0]).to(dev), cfg)
    tensors = list(frame.kp) + [frame.u_right, frame.depth, frame.sad_dist]
    if not all(t.device.type == "cuda" for t in tensors):
        raise AssertionError("a Frame tensor is not on the card")
    if frame.kp.capacity != cfg.orb.n_features:
        raise AssertionError("frame capacity differs from n_features")

    HAMMING_BEST2_KERNEL.reset_counts()
    HAMMING_KERNEL.reset_counts()
    tracked = 0
    for i, pair in enumerate(frames):
        if sys_.track_stereo(pair[0], pair[1], timestamp=0.1 * i) is not None:
            tracked += 1
    sys_.shutdown()
    launches, matrix_launches = HAMMING_BEST2_KERNEL.launches, HAMMING_KERNEL.launches

    est = sys_.trajectory_kitti()
    gt_mats = []
    for R, t in gt[: len(est)]:
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        gt_mats.append(T)
    ate = ate_rmse(est, gt_mats)
    length = float(sum(np.linalg.norm(gt[i + 1][1] - gt[i][1]) for i in range(N_FRAMES - 1)))
    ms = 1e3 * np.asarray(sys_.frame_times)
    log(f"kitti drive {cfg.width}x{cfg.height}, {cfg.orb.n_features} features: "
        f"{tracked}/{N_FRAMES} tracked, {sys_.map.n_kf} keyframes, ATE {ate:.4f} m over {length:.3f} m, "
        f"hamming_best2 launches {launches} ({launches / N_FRAMES:.1f} per frame), "
        f"hamming_matrix launches {matrix_launches}")
    log(f"per-frame ms (host clock, each frame ends in a device->host read): median "
        f"{np.median(ms):.2f}, median after the first frame {np.median(ms[1:]):.2f}, "
        f"first {ms[0]:.2f}, max {ms.max():.2f}")
    if tracked < N_FRAMES - 2:
        raise AssertionError(f"tracked {tracked}/{N_FRAMES} frames")
    if sys_.map.n_kf < 2:
        raise AssertionError(f"only {sys_.map.n_kf} keyframes")
    if not (np.isfinite(ate) and ate < 0.05 * length):
        raise AssertionError(f"ATE {ate:.4f} m is not below 5% of {length:.3f} m")
    if launches <= 0:
        raise AssertionError("the lane drive never launched hamming_best2")
    if matrix_launches != 0:
        raise AssertionError(f"the lane drive launched hamming_matrix {matrix_launches} times")
    return {"launches": launches, "matrix_launches": matrix_launches}


_TUM_WORLD = None


def _render_rgbd(pose):
    R, t = pose
    img, depth = _TUM_WORLD.render_rgbd(R, t, dist_coef=_TUM_WORLD.cfg.dist_coef)
    # depth in the config's DepthMapFactor units, kept float32: uint16 would
    # overflow past 13.1 m at a factor of 5000, and the world spans 4-28 m
    return img, (depth * _TUM_WORLD.cfg.depth_map_factor).astype(np.float32)


def render_tum(workers=8):
    """TUM_FRAMES + 4 RGB-D frames of SyntheticStereoWorld(seed TUM_SEED) at
    the freiburg1 configuration, through its lens, on
    forward_trajectory(step TUM_STEP); forked like render_orbit, before
    anything touches the card."""
    import multiprocessing

    from orb_slam2_2021_tpu_torch.config import tum_rgbd_config
    from orb_slam2_2021_tpu_torch.io.synthetic import SyntheticStereoWorld, forward_trajectory

    global _TUM_WORLD
    _TUM_WORLD = SyntheticStereoWorld(tum_rgbd_config("freiburg1"), seed=TUM_SEED)
    gt = forward_trajectory(TUM_FRAMES + 4, step=TUM_STEP)
    t0 = time.perf_counter()
    with multiprocessing.get_context("fork").Pool(workers) as pool:
        frames = pool.map(_render_rgbd, gt, chunksize=4)
    _TUM_WORLD = None
    log(f"rendered {len(frames)} freiburg1 RGB-D frames in {time.perf_counter() - t0:.1f} s "
        f"({workers} processes)")
    return frames, gt


class record_shapes:
    """Within the block, every matcher's and mapping unit's hamming_best2
    call adds its (N, M, T) to `shapes` (T = 0 for an [M, 8] side)."""

    def __init__(self, shapes):
        self.shapes = shapes

    def __enter__(self):
        from orb_slam2_2021_tpu_torch.frontend import matchers
        from orb_slam2_2021_tpu_torch.ops.hamming import hamming_best2
        from orb_slam2_2021_tpu_torch.pipeline import mapping_steps

        def rec(x, y, mask):
            self.shapes.add((int(x.shape[0]), int(y.shape[-2]), int(y.shape[0]) if y.dim() == 3 else 0))
            return hamming_best2(x, y, mask)

        self._undo = (matchers, mapping_steps, hamming_best2)
        matchers.hamming_best2 = mapping_steps.hamming_best2 = rec
        return self

    def __exit__(self, *exc):
        matchers, mapping_steps, fn = self._undo
        matchers.hamming_best2 = mapping_steps.hamming_best2 = fn


def _launch_counts():
    from orb_slam2_2021_tpu_torch.ops.hamming import HAMMING_BEST2_KERNEL, HAMMING_KERNEL

    return HAMMING_BEST2_KERNEL.launches, HAMMING_KERNEL.launches


def _zero_launch_counts():
    from orb_slam2_2021_tpu_torch.ops.hamming import HAMMING_BEST2_KERNEL, HAMMING_KERNEL

    HAMMING_BEST2_KERNEL.reset_counts()
    HAMMING_KERNEL.reset_counts()


def _check_drive_launches(name, best2, matrix):
    log(f"{name}: hamming_best2 launches {best2}, hamming_matrix launches {matrix}")
    if best2 <= 0:
        raise AssertionError(f"the {name} never launched hamming_best2")
    if matrix != 0:
        raise AssertionError(f"the {name} launched hamming_matrix {matrix} times")


def _read_tum(path):
    rows = np.loadtxt(path, ndmin=2)
    Ts = []
    for r in rows:
        qx, qy, qz, qw = r[4:8]
        R = np.array([
            [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)],
            [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)],
            [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)]])
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, r[1:4]
        Ts.append(T)
    return rows, Ts


def _require_on_card(tensors, what):
    if not all(t.device.type == "cuda" for t in tensors):
        raise AssertionError(f"a tensor of {what} is not on the card")


def drive_tum_rgbd(dev, frames, gt, shapes):
    """Phase 12: System(tum_rgbd_config("freiburg1"), sensor="rgbd") at the
    defaults over TUM_FRAMES frames; every Frame tensor on the card; the TUM
    trajectory written and read back."""
    import tempfile

    from orb_slam2_2021_tpu_torch.config import tum_rgbd_config
    from orb_slam2_2021_tpu_torch.frontend.frame import build_rgbd_frame
    from orb_slam2_2021_tpu_torch.pipeline.system import System

    cfg = tum_rgbd_config("freiburg1")
    sys_ = System(cfg, sensor="rgbd", device=dev)
    if sys_.loop_closer is None or sys_.place.voc.L != 6:
        raise AssertionError("the RGB-D System is not at the defaults")
    img, depth = frames[0]
    frame = build_rgbd_frame(torch.from_numpy(img).to(dev), torch.from_numpy(depth).to(dev), cfg,
                             1.0 / cfg.depth_map_factor)
    _require_on_card(list(frame.kp) + [frame.u_right, frame.depth, frame.sad_dist], "an RGB-D Frame")

    _zero_launch_counts()
    tracked = 0
    with record_shapes(shapes):
        for i in range(TUM_FRAMES):
            img, depth = frames[i]
            if sys_.track_rgbd(img, depth, timestamp=0.1 * i) is not None:
                tracked += 1
    best2, matrix = _launch_counts()
    est = sys_.trajectory_kitti()
    ate, length = _ate(est, gt[:TUM_FRAMES])
    ms = 1e3 * np.asarray(sys_.frame_times)
    kf_frames = [r["frame_id"] for r in sys_.metrics if r["keyframe"]]
    log(f"phase 12, RGB-D drive {cfg.width}x{cfg.height}, {cfg.orb.n_features} features, freiburg1 "
        f"lens: {tracked}/{TUM_FRAMES} tracked, {sys_.map.n_kf} live keyframes ({sys_.map.next_kf} "
        f"created, at frames {kf_frames}), {int(sys_.map.mp_valid.sum())} live map points, "
        f"{sys_.loop_closer.n_loops} loop(s), ATE {ate:.4f} m over {length:.3f} m (JAX reference on "
        f"the CPU: {REF_RGBD['tracked']}/60, {REF_RGBD['keyframes']} keyframes, ATE {REF_RGBD['ate']} m)")
    log(f"phase 12 per-frame ms (host clock): median {np.median(ms):.2f}, median after the first "
        f"frame {np.median(ms[1:]):.2f}, max {ms.max():.2f}; "
        f"{best2 / TUM_FRAMES:.1f} hamming_best2 launches per frame")
    _check_drive_launches("RGB-D drive", best2, matrix)
    if tracked < TUM_FRAMES - 2:
        raise AssertionError(f"RGB-D: tracked {tracked}/{TUM_FRAMES} frames")
    if sys_.map.next_kf < 2:
        raise AssertionError(f"RGB-D: only {sys_.map.next_kf} keyframes")
    if not (np.isfinite(ate) and ate < 0.05 * length):
        raise AssertionError(f"RGB-D: ATE {ate:.4f} m is not below 5% of {length:.3f} m")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "traj_tum.txt")
        sys_.save_trajectory_tum(path)
        rows, Ts = _read_tum(path)
    stamped = sys_.trajectory_tum()
    qn = np.linalg.norm(rows[:, 4:8], axis=1)
    dt = max(float(np.abs(A[:3, 3] - B[:3, 3]).max()) for A, B in zip(Ts, est))
    dR = max(float(np.abs(A[:3, :3] - B[:3, :3]).max()) for A, B in zip(Ts, est))
    ortho = max(float(np.abs(B[:3, :3] @ B[:3, :3].T - np.eye(3)).max()) for B in est)
    dts = float(np.abs(rows[:, 0] - np.asarray([s for s, _ in stamped])).max())
    log(f"phase 12 TUM file: {len(rows)} rows, quaternion norms within {np.abs(qn - 1).max():.2e} "
        f"of 1, positions within {dt:.2e} and rotations within {dR:.2e} of trajectory_kitti() "
        f"(whose rotations are orthonormal to {ortho:.2e}), stamps within {dts:.1e}")
    # a quaternion's rotation is orthonormal, so it meets a float32 rotation
    # only as closely as that rotation is orthonormal
    if (len(rows) != TUM_FRAMES or np.abs(qn - 1).max() > 1e-6 or dt > 1e-6 or dts > 1e-6
            or dR > ortho + 1e-6):
        raise AssertionError("the TUM trajectory file does not read back as the trajectory")
    return sys_, {"launches": best2, "matrix_launches": matrix, "ate": ate, "length": length,
                  "est": est, "median_ms": float(np.median(ms))}


def drive_localization(dev, sys_, frames, gt, rgbd):
    """Phase 13: localization mode on phase 12's System, frames
    TUM_FRAMES-1 down to LOC_FROM re-tracked (a revisit): no keyframe and no
    map point added, the frames tracked within phase 12's ATE bound; then
    localization off and new frames past the drive's end until mapping
    inserts a keyframe (the reference did on the first)."""
    est, length = rgbd["est"], rgbd["length"]
    to_gt = _ate_alignment(est, gt[:TUM_FRAMES])
    sys_.activate_localization_mode()
    kf0, mp0 = int(sys_.map.next_kf), int(sys_.map.next_mp)
    revisit = list(range(TUM_FRAMES - 1, LOC_FROM - 1, -1))
    _zero_launch_counts()
    errs, vo = [], []
    t0 = len(sys_.frame_times)
    for j, i in enumerate(revisit):
        img, depth = frames[i]
        pose = sys_.track_rgbd(img, depth, timestamp=10.0 + 0.1 * j)
        vo.append(bool(sys_.tracker.vo_mode))
        if pose is not None:
            c = -pose[0].T @ pose[1]
            errs.append(float(np.linalg.norm(to_gt(c) - gt[i][1])))
    best2, matrix = _launch_counts()
    ms = 1e3 * np.asarray(sys_.frame_times[t0:])
    err = float(np.sqrt(np.mean(np.square(errs)))) if errs else float("inf")
    n = len(revisit)
    log(f"phase 13, localization mode on the RGB-D map: {len(errs)}/{n} re-tracked (frames "
        f"{revisit[0]}..{revisit[-1]}), keyframes {kf0} -> {int(sys_.map.next_kf)}, map points "
        f"{mp0} -> {int(sys_.map.next_mp)}, VO mode on {sum(vo)} frames, ATE of these frames "
        f"{err:.4f} m (phase 12's alignment; bound 5% of {length:.3f} m; JAX reference: "
        f"{REF_RGBD['loc_tracked']}/20, {REF_RGBD['loc_ate']} m); median {np.median(ms):.2f} ms")
    _check_drive_launches("localization run", best2, matrix)
    if int(sys_.map.next_kf) != kf0 or int(sys_.map.next_mp) != mp0:
        raise AssertionError("localization mode added keyframes or map points")
    if len(errs) < n - 2 or not err < 0.05 * length:
        raise AssertionError(f"localization: {len(errs)}/{n} tracked, ATE {err:.4f} m")
    sys_.deactivate_localization_mode()
    after = []
    for i in range(TUM_FRAMES, len(frames)):
        after.append(sys_.track_rgbd(*frames[i], timestamp=20.0 + 0.1 * i) is not None)
        if int(sys_.map.next_kf) > kf0:
            break
    sys_.shutdown()
    log(f"phase 13, localization off: frames {TUM_FRAMES}..{TUM_FRAMES + len(after) - 1} tracked "
        f"{after}, keyframes {kf0} -> {int(sys_.map.next_kf)} (JAX reference: a keyframe on frame "
        f"{TUM_FRAMES})")
    if not all(after) or int(sys_.map.next_kf) <= kf0:
        raise AssertionError("mapping did not resume after localization mode")
    return {"launches": best2, "matrix_launches": matrix}


def drive_tum_mono(dev, frames, gt, shapes):
    """Phase 14: System(tum_rgbd_config("freiburg1"), sensor="mono") at the
    defaults over the same frames' images."""
    from orb_slam2_2021_tpu_torch.config import tum_rgbd_config
    from orb_slam2_2021_tpu_torch.io.trajectory import ate_rmse
    from orb_slam2_2021_tpu_torch.pipeline.system import System

    cfg = tum_rgbd_config("freiburg1")
    sys_ = System(cfg, sensor="mono", device=dev)
    if sys_.loop_closer is None or sys_.loop_closer.fix_scale or not sys_.local_mapper.monocular:
        raise AssertionError("the monocular System is not wired for a free scale")
    _zero_launch_counts()
    tracked, init = 0, None
    with record_shapes(shapes):
        for i in range(TUM_FRAMES):
            if sys_.track_monocular(frames[i][0], timestamp=0.1 * i) is not None:
                tracked += 1
                init = i if init is None else init
    sys_.shutdown()
    best2, matrix = _launch_counts()
    est = sys_.trajectory_kitti()
    _, length = _ate(est, gt[:TUM_FRAMES])
    gt_mats = []
    for R, t in gt[TUM_FRAMES - len(est):TUM_FRAMES]:
        T = np.eye(4)
        T[:3, :3], T[:3, 3] = R, t
        gt_mats.append(T)
    ate = ate_rmse(est, gt_mats, with_scale=True)
    ms = 1e3 * np.asarray(sys_.frame_times)
    bound = max(1.5 * REF_MONO["ate_sim3"], 0.30 * length)
    log(f"phase 14, monocular drive {cfg.width}x{cfg.height}: initialized at frame {init}, "
        f"{tracked}/{TUM_FRAMES} tracked, {sys_.map.n_kf} live keyframes ({sys_.map.next_kf} created), "
        f"{int(sys_.map.mp_valid.sum())} live map points, {sys_.loop_closer.n_loops} loop(s), "
        f"Sim3-aligned ATE {ate:.4f} m over {length:.3f} m (bound {bound:.4f} m; JAX reference on the "
        f"CPU: init {REF_MONO['init']}, {REF_MONO['tracked']}/60, {REF_MONO['keyframes']} keyframes, "
        f"ATE {REF_MONO['ate_sim3']} m)")
    log(f"phase 14 per-frame ms (host clock): median {np.median(ms):.2f}, max {ms.max():.2f}; "
        f"{best2 / TUM_FRAMES:.1f} hamming_best2 launches per frame")
    _check_drive_launches("monocular drive", best2, matrix)
    if init is None or init > REF_MONO["init"] + 3:
        raise AssertionError(f"monocular: initialized at frame {init}")
    if tracked < TUM_FRAMES - init - 2:
        raise AssertionError(f"monocular: tracked {tracked}/{TUM_FRAMES} frames")
    if not (np.isfinite(ate) and ate <= bound):
        raise AssertionError(f"monocular: scaled ATE {ate:.4f} m above {bound:.4f} m")
    return {"launches": best2, "matrix_launches": matrix, "median_ms": float(np.median(ms))}


def _small_pair(systems, track, n_frames, tol, label, flag=None):
    """Drive a CUDA and a CPU System (dict device -> System) with
    `track(system, i)` over n_frames: same tracked flags, keyframe counts
    and, with `flag(system)`, flags after every frame; poses within `tol`.
    Returns the worst pose difference."""
    worst = 0.0
    g, c = systems["cuda"], systems["cpu"]
    for i in range(n_frames):
        pg, pc = track(g, i), track(c, i)
        if (pg is None) != (pc is None) or g.map.next_kf != c.map.next_kf:
            raise AssertionError(f"{label} frame {i}: CUDA and CPU tracking differ")
        if flag is not None and flag(g) != flag(c):
            raise AssertionError(f"{label} frame {i}: CUDA and CPU flags differ")
        if pg is not None:
            worst = max(worst, float(np.abs(pg[1] - pc[1]).max()), float(np.abs(pg[0] - pc[0]).max()))
    if worst > tol:
        raise AssertionError(f"{label}: CUDA vs CPU pose difference {worst:.2e} (tolerance {tol})")
    return worst


def check_sensors_small_against_cpu(dev):
    """The RGB-D System through the synthetic lens, the monocular System and
    localization mode, CUDA against the port's CPU path (held against the
    JAX System by tests/test_torch_sensors.py) at 320x240, mapping on and
    loop closing off: same tracked flags, keyframes (and VO flags), poses
    within SMALL_SENSOR_POSE_TOL."""
    from orb_slam2_2021_tpu_torch.config import synthetic_config
    from orb_slam2_2021_tpu_torch.io.synthetic import SyntheticStereoWorld, forward_trajectory
    from orb_slam2_2021_tpu_torch.pipeline.system import System

    cfg = synthetic_config(width=320, height=240)
    rcfg = cfg.replace(dist_coef=SMALL_LENS, depth_map_factor=5000.0)
    world = SyntheticStereoWorld(rcfg, seed=4)
    rgbd = []
    for R, t in forward_trajectory(12, step=0.12):
        img, depth = world.render_rgbd(R, t, dist_coef=SMALL_LENS)
        rgbd.append((img, (depth * 5000.0).astype(np.float32)))
    make = lambda c, **kw: {d: System(c, enable_loop_closing=False, device=d, **kw)  # noqa: E731
                            for d in ("cuda", "cpu")}
    worst = _small_pair(make(rcfg, sensor="rgbd"), lambda s, i: s.track_rgbd(*rgbd[i], timestamp=0.1 * i),
                              12, SMALL_SENSOR_POSE_TOL, "RGB-D 320x240")
    log(f"RGB-D 320x240 through the lens, 12 frames, CUDA vs CPU: same tracked flags and keyframes, "
        f"max pose diff {worst:.2e} (tolerance {SMALL_SENSOR_POSE_TOL})")

    world = SyntheticStereoWorld(cfg, seed=9)
    mono = [world.render(R, t)[0] for R, t in forward_trajectory(16, step=0.12)]
    systems = make(cfg, sensor="mono")
    worst = _small_pair(systems, lambda s, i: s.track_monocular(mono[i], timestamp=0.1 * i),
                              16, SMALL_SENSOR_POSE_TOL, "monocular 320x240")
    init = [r["frame_id"] for r in systems["cuda"].metrics if r["state"] == "OK"][:1]
    log(f"monocular 320x240, 16 frames, the same init_sampler seeds on both devices, CUDA vs CPU: "
        f"initialized at frame {init[0] if init else None} on both, {systems['cuda'].map.next_kf} "
        f"keyframes, max pose diff {worst:.2e} (tolerance {SMALL_SENSOR_POSE_TOL})")
    if not init or systems["cuda"].map.next_kf < 3:
        raise AssertionError("monocular 320x240: no initialization or no mapping keyframe")

    world = SyntheticStereoWorld(cfg, seed=3)
    gt = forward_trajectory(22, step=0.12)
    stereo = [np.clip(np.stack(world.render(R, t)), 0, 255).astype(np.uint8) for R, t in gt]
    systems = make(cfg)
    for i in range(10):
        for s in systems.values():
            s.track_stereo(stereo[i][0], stereo[i][1], timestamp=0.1 * i)
    saved = systems["cpu"].map.mp_valid.copy()
    if not np.array_equal(saved, systems["cuda"].map.mp_valid):
        raise AssertionError("localization 320x240: the maps differ before localization")
    hide = np.nonzero(saved)[0][8:]
    for s in systems.values():
        s.activate_localization_mode()
        s.map.mp_valid[hide] = False
    kf0 = systems["cpu"].map.next_kf
    # 6 frames forward with all but 8 map points hidden (VO points carry the
    # pose), then the map back for 6 more frames forward: the reference-
    # keyframe search relocalizes on the first and ends VO mode. Every count
    # these decisions gate on stays far from its threshold. A jump back to
    # mapped frames 4-7 instead (tests/test_torch_sensors.py) leaves the
    # motion model a 1.6 m velocity, and its inlier count near the gate
    # parts CUDA from the CPU (PERF.md)
    order = list(range(10, 22))
    vo = {"cuda": [], "cpu": []}

    def track_loc(s, j):
        if j == 6:
            s.map.mp_valid[:] = saved
        pose = s.track_stereo(stereo[order[j]][0], stereo[order[j]][1], timestamp=1.0 + 0.1 * j)
        vo["cuda" if s is systems["cuda"] else "cpu"].append(s.tracker.vo_mode)
        return pose

    worst = _small_pair(systems, track_loc, len(order), SMALL_SENSOR_POSE_TOL, "localization 320x240",
                        lambda s: s.tracker.vo_mode)
    flags = "".join("1" if v else "0" for v in vo["cuda"])
    log(f"localization mode 320x240, {len(order)} frames, CUDA vs CPU: same tracked flags and VO "
        f"flags ({flags}), no keyframe added, max pose diff {worst:.2e} (tolerance "
        f"{SMALL_SENSOR_POSE_TOL})")
    if systems["cuda"].map.next_kf != kf0 or not any(vo["cuda"][:6]) or vo["cuda"][-1]:
        raise AssertionError(f"localization 320x240: keyframes added or VO flags {flags}")


def check_two_view(dev):
    """two_view_init on the card against the CPU on one fixed scene and set
    of samples (2000 matches, 256 minimal sets), with its eigenproblems in
    float64 (the default, asserted) and in float32 (reported): the same
    model choice and verdict, the `good` mask to 1%, and R and t within a
    tenth of the CPU estimate's own error against the scene's truth (the
    refit's float32 sums run in another order on the card)."""
    from orb_slam2_2021_tpu_torch.geometry.so3 import so3_exp
    from orb_slam2_2021_tpu_torch.solvers import two_view
    from orb_slam2_2021_tpu_torch.solvers.horn_sim3 import sample_indices

    rng = np.random.default_rng(11)
    n, fx, cx, cy = 2000, 517.3, 318.6, 255.3
    pts = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(4, 12, n)], 1)
    R = so3_exp(torch.tensor([0.01, -0.03, 0.005])).numpy().astype(np.float64)
    t_true = np.array([0.3, 0.02, 0.05])
    x2 = pts @ R.T + t_true
    proj = lambda x: np.stack([fx * x[:, 0] / x[:, 2] + cx, fx * x[:, 1] / x[:, 2] + cy], 1)  # noqa: E731
    p1 = (proj(pts) + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    p2 = (proj(x2) + rng.normal(0, 0.5, (n, 2))).astype(np.float32)
    bad = rng.random(n) < 0.2
    p2[bad] += rng.uniform(-30, 30, (bad.sum(), 2)).astype(np.float32)
    valid = rng.random(n) < 0.9
    idx = sample_indices(valid, 8, 256, torch.Generator().manual_seed(5))
    args = [torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(valid)]
    rows, ms = {}, None
    default = two_view.EIG_DTYPE
    for dtype in (torch.float64, torch.float32):
        two_view.EIG_DTYPE = dtype
        res = {}
        for d in ("cpu", dev):
            r = two_view.two_view_init(idx.to(d), *[a.to(d) for a in args], fx, fx, cx, cy)
            res[str(d)] = [x.cpu() for x in r]
        c, g = res["cpu"], res[str(dev)]
        rows[dtype] = {"same_choice": bool(c[0] == g[0]) and bool(c[1] == g[1]),
                       "ok": bool(c[0]), "used_h": bool(c[1]),
                       "good_diff": int((c[5] != g[5]).sum()), "n_good": int(c[5].sum()),
                       "dR": float((c[2] - g[2]).abs().max()), "dt": float((c[3] - g[3]).abs().max())}
        if dtype == default:
            cpu_default = c
            dargs = [idx.to(dev)] + [a.to(dev) for a in args]
            ms = time_ms(lambda: two_view.two_view_init(*dargs, fx, fx, cx, cy), iters=5, warm=2)
    two_view.EIG_DTYPE = default
    for dtype, r in rows.items():
        log(f"two_view_init, 2000 matches, 256 sets, eigenproblems in {str(dtype)[6:]}: CUDA vs CPU "
            f"same ok/used_h {r['same_choice']} (ok {r['ok']}, used_h {r['used_h']}), "
            f"{r['good_diff']} of {r['n_good']} good flags differ, R within {r['dR']:.2e}, "
            f"t within {r['dt']:.2e}")
    r = rows[default]
    R_cpu, t_cpu = cpu_default[2].double().numpy(), cpu_default[3].double().numpy()
    tol_R = 0.1 * float(np.abs(R_cpu - R).max())
    tol_t = 0.1 * float(np.abs(t_cpu / np.linalg.norm(t_cpu) - t_true / np.linalg.norm(t_true)).max())
    log(f"two_view_init on the card ({str(default)[6:]} eigenproblems): {ms:.3f} ms; tolerances R "
        f"{tol_R:.2e}, t {tol_t:.2e} (a tenth of the CPU estimate's error against the truth)")
    if not (r["same_choice"] and r["ok"]) or r["good_diff"] > max(2, r["n_good"] // 100) \
            or r["dR"] > tol_R or r["dt"] > tol_t:
        raise AssertionError(f"two_view_init: CUDA and CPU disagree: {r}")
    return ms

def close_range_world(cfg, synthetic):
    """The close-range RGB-D world and path, from either package's
    synthetic module (the reference script renders the same frames)."""
    world = synthetic.SyntheticStereoWorld(cfg, seed=TUM_SEED, z_min=CLOSE_Z[0], z_max=CLOSE_Z[1])
    return world, synthetic.forward_trajectory(CLOSE_FRAMES, step=CLOSE_STEP)


def close_range_frame(world, pose):
    """(uint8 image, uint16 depth in DepthMapFactor units) at a pose."""
    img, depth = world.render_rgbd(*pose, dist_coef=world.cfg.dist_coef)
    raw = np.round(depth * world.cfg.depth_map_factor)
    if raw.max() >= 65535:
        raise ValueError(f"depth {depth.max():.2f} m overflows uint16")
    return np.clip(img, 0, 255).astype(np.uint8), raw.astype(np.uint16)


def count_close_triggers(tracker, fired):
    """Wrap the tracker's keyframe decision: append the frame id whenever
    the close-point trigger (fewer than 100 tracked and more than 70
    untracked points closer than ThDepth) holds there."""
    decide = tracker._need_new_keyframe

    def gate(frame, frame_id):
        verdict = decide(frame, frame_id)
        if tracker._kf_close_counts is not None:
            tracked_close, untracked_close = tracker._kf_close_counts
        else:
            depth = np.asarray(tracker._frame_host_arrays(frame)["depth"])
            close = (depth > 0) & (depth < tracker.cfg.resolved_depth_th())
            tracked_close = int((close & (tracker._bind_cur >= 0)).sum())
            untracked_close = int((close & (tracker._bind_cur < 0)).sum())
        if tracked_close < 100 and untracked_close > 70:
            fired.append(int(frame_id))
        return verdict

    tracker._need_new_keyframe = gate


_CLOSE_WORLD = None


def _render_close(pose):
    return close_range_frame(_CLOSE_WORLD, pose)


def render_close(workers=8):
    """The close-range RGB-D frames, forked like render_orbit."""
    import multiprocessing

    from orb_slam2_2021_tpu_torch import config
    from orb_slam2_2021_tpu_torch.io import synthetic

    global _CLOSE_WORLD
    _CLOSE_WORLD, gt = close_range_world(config.tum_rgbd_config("freiburg1"), synthetic)
    t0 = time.perf_counter()
    with multiprocessing.get_context("fork").Pool(workers) as pool:
        frames = pool.map(_render_close, gt, chunksize=4)
    _CLOSE_WORLD = None
    log(f"rendered {len(frames)} close-range RGB-D frames (uint16 depth) in "
        f"{time.perf_counter() - t0:.1f} s ({workers} processes)")
    return frames, gt


def drive_tum_close(dev, frames, gt):
    """Phase 16: System(tum_rgbd_config("freiburg1"), sensor="rgbd") over
    the close-range frames with uint16 depth; the close-point trigger must
    hold at least once; then localization mode over the last frames."""
    from orb_slam2_2021_tpu_torch.config import tum_rgbd_config
    from orb_slam2_2021_tpu_torch.pipeline.system import System

    cfg = tum_rgbd_config("freiburg1")
    sys_ = System(cfg, sensor="rgbd", device=dev)
    fired = []
    count_close_triggers(sys_.tracker, fired)
    _zero_launch_counts()
    tracked = sum(sys_.track_rgbd(img, depth, timestamp=0.1 * i) is not None
                  for i, (img, depth) in enumerate(frames))
    best2, matrix = _launch_counts()
    kf_frames = [r["frame_id"] for r in sys_.metrics if r["keyframe"]]
    ate, length = _ate(sys_.trajectory_kitti(), gt)
    ms = 1e3 * np.asarray(sys_.frame_times)
    sys_.activate_localization_mode()
    kf0, mp0 = int(sys_.map.next_kf), int(sys_.map.next_mp)
    loc_tracked, vo = 0, 0
    for j, i in enumerate(range(CLOSE_FRAMES - 1, CLOSE_LOC_FROM - 1, -1)):
        loc_tracked += sys_.track_rgbd(*frames[i], timestamp=10.0 + 0.1 * j) is not None
        vo += bool(sys_.tracker.vo_mode)
    grew = int(sys_.map.next_kf) != kf0 or int(sys_.map.next_mp) != mp0
    sys_.shutdown()
    n_loc = CLOSE_FRAMES - CLOSE_LOC_FROM
    log(f"phase 16, close-range RGB-D drive {cfg.width}x{cfg.height}, depth uint16 up to "
        f"{max(int(d.max()) for _, d in frames)} (z {CLOSE_Z[0]}-{CLOSE_Z[1]} m): {tracked}/{CLOSE_FRAMES} "
        f"tracked, keyframes at frames {kf_frames}, close-point trigger held at frames {sorted(set(fired))}, "
        f"ATE {ate:.4f} m over {length:.3f} m; localization {loc_tracked}/{n_loc} re-tracked, VO mode on "
        f"{vo} frames, map grew: {grew} (JAX reference on the CPU: {REF_CLOSE['tracked']}/60, keyframes at "
        f"{REF_CLOSE['kf_frames']}, trigger at {REF_CLOSE['close_frames']}, ATE {REF_CLOSE['ate']} m; "
        f"localization {REF_CLOSE['loc_tracked']}/10, {REF_CLOSE['vo_frames']} VO frames)")
    log(f"phase 16 per-frame ms (host clock): median {np.median(ms):.2f}, max {ms.max():.2f}")
    _check_drive_launches("close-range RGB-D drive", best2, matrix)
    if tracked < CLOSE_FRAMES - 2:
        raise AssertionError(f"close-range RGB-D: tracked {tracked}/{CLOSE_FRAMES} frames")
    if not fired:
        raise AssertionError("close-range RGB-D: the close-point keyframe trigger never held")
    if not (np.isfinite(ate) and ate < 0.05 * length):
        raise AssertionError(f"close-range RGB-D: ATE {ate:.4f} m is not below 5% of {length:.3f} m")
    if loc_tracked < n_loc - 2 or grew:
        raise AssertionError(f"close-range localization: {loc_tracked}/{n_loc} tracked, map grew: {grew}")
    return {"launches": best2, "matrix_launches": matrix}


def _check_threads(sys_, what):
    """After shutdown (which raises what a thread died of): both threads
    joined and neither kept an error."""
    lc = sys_.loop_closer
    alive = sys_._worker.is_alive() or (lc is not None and lc.gba_thread is not None
                                        and lc.gba_thread.is_alive())
    errors = [x.error for x in (sys_.local_mapper, lc) if x is not None and x.error is not None]
    if alive or errors:
        raise AssertionError(f"{what}: a thread still runs or died: alive {alive}, errors {errors}")


def _busy_share(prof):
    """Device busy share of a profiled stretch: the union of the kernels'
    intervals over the span from the first kernel's start to the last one's
    end, with the kernel count per stream id."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        events = json.load(open(path))["traceEvents"]
    kernels = sorted((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)), e["args"].get("stream"))
                     for e in events if e.get("cat") == "kernel")
    if not kernels:
        return float("nan"), {}
    busy, end = 0.0, -np.inf
    for a, b, _ in kernels:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = max(b for _, b, _ in kernels) - kernels[0][0]
    per_stream = {}
    for _, _, st in kernels:
        per_stream[str(st)] = per_stream.get(str(st), 0) + 1
    return busy / span, per_stream


def drive_async_bench(dev, frames, gt, sync_ms):
    """Phase 15: bench_torch.py's drive (System(kitti_stereo_config(),
    async_mode=True), prefetch, the orbit's frames): every frame tracked,
    ATE, invariants, threads joined; reports the loop, global BA, launches
    per thread, the lane's median and p90 (and its waits for the map lock,
    the `lock.wait` spans of io/trace.py's recorder on the lane's thread)
    beside phase 11's synchronous median on the same frames, and fps."""
    import threading

    import bench_torch

    from orb_slam2_2021_tpu_torch.config import kitti_stereo_config
    from orb_slam2_2021_tpu_torch.io import trace
    from orb_slam2_2021_tpu_torch.ops.hamming import HAMMING_BEST2_KERNEL
    from orb_slam2_2021_tpu_torch.pipeline.system import System

    cfg = kitti_stereo_config()
    sys_ = System(cfg, async_mode=True, device=dev)
    lc = sys_.loop_closer
    loops = []
    correct = lc._correct_loop

    def correct_hook(k, loop_kf, *a):
        loops.append((len(sys_.frame_times), k, loop_kf))
        return correct(k, loop_kf, *a)

    lc._correct_loop = correct_hook
    idle = []  # was the worker idle as each frame began?
    _zero_launch_counts()
    trace.start()
    try:
        fps = bench_torch.drive(sys_, frames, bench_torch.WARMUP_FRAMES,
                                hook=lambda i: idle.append(sys_.local_mapper.idle()))
    finally:
        rec = trace.stop()
    sys_.shutdown()
    _check_threads(sys_, "async bench drive")
    best2, matrix = _launch_counts()
    by_thread = dict(HAMMING_BEST2_KERNEL.launches_by_thread)
    states = [r["state"] for r in sys_.metrics]
    ate, length = _ate(sys_.trajectory_kitti(), gt)
    bad = sys_.map.check_invariants()
    w = bench_torch.WARMUP_FRAMES
    ms = 1e3 * np.asarray(sys_.frame_times)
    sync = np.asarray(sync_ms)[w:]
    waits = rec.seconds_by_key("lock.wait", tid=threading.get_native_id())  # frame id -> s
    lock = 1e3 * np.asarray([waits.get(i, 0.0) for i in range(len(sys_.frame_times))])[w:]
    idle = np.asarray(idle[w:], bool)
    log(f"phase 15, async prefetch drive (bench_torch.drive) {cfg.width}x{cfg.height}: "
        f"{states.count('OK')}/{len(frames)} tracked, {sys_.map.n_kf} live keyframes "
        f"({sys_.map.next_kf} created), {int(sys_.map.mp_valid.sum())} live map points, "
        f"{lc.n_loops} loop(s), ATE {ate:.4f} m over {length:.3f} m, {len(bad)} invariant violations")
    for frame, k, loop_kf in loops:
        log(f"phase 15 loop at frame {frame}: keyframe {k} against keyframe {loop_kf} (synchronous "
            f"phase 11 and the JAX reference: frame {REF_LOOP_FRAME}, keyframe {REF_LOOP_PAIR[0]} "
            f"against {REF_LOOP_PAIR[1]}; async timing may move or miss it)")
    log(f"phase 15 global BA runs on their thread: {lc.gba_runs}")
    log(f"phase 15 lane ms per frame over frames {w}..{len(frames) - 1} (host clock): median "
        f"{np.median(ms[w:]):.2f}, p90 {np.percentile(ms[w:], 90):.2f}, max {ms[w:].max():.2f}; "
        f"synchronous phase 11 on the same frames: median {np.median(sync):.2f}, p90 "
        f"{np.percentile(sync, 90):.2f}; {fps:.3f} frames/s over the timed frames; the lane's wait "
        f"for the map lock: median {np.median(lock):.2f}, p90 {np.percentile(lock, 90):.2f}, "
        f"{lock.sum() / ms[w:].sum():.3f} of the lane's time")
    for name, sel in (("idle", idle), ("busy", ~idle)):
        if sel.any():
            log(f"phase 15 frames begun with the mapping worker {name}: {int(sel.sum())}, lane median "
                f"{np.median(ms[w:][sel]):.2f} ms (sync on the same frames {np.median(sync[sel]):.2f}), "
                f"map-lock wait median {np.median(lock[sel]):.2f} ms")
    log(f"phase 15 hamming_best2 launches per thread: {by_thread} ({best2} in all); "
        f"hamming_matrix launches {matrix}")
    _check_drive_launches("async bench drive", best2, matrix)
    if states.count("OK") != len(frames):
        raise AssertionError(f"async bench drive: {len(frames) - states.count('OK')} frames not tracked")
    if not (np.isfinite(ate) and ate < 0.05 * length):
        raise AssertionError(f"async bench drive: ATE {ate:.4f} m is not below 5% of {length:.3f} m")
    if bad:
        raise AssertionError("async bench drive: map invariants broken:\n" + "\n".join(bad[:20]))
    if by_thread.get("mapping", 0) <= 0 or by_thread.get("MainThread", 0) <= 0:
        raise AssertionError(f"async bench drive: launches per thread {by_thread}")
    return {"launches_by_thread": by_thread, "matrix_launches": matrix, "fps": fps,
            "median_ms": float(np.median(ms[w:]))}


def drive_async_sensors(dev, close_frames, tum_frames, viz_dir):
    """Phase 17: the RGB-D System in async mode over the first
    ASYNC_SENSOR_FRAMES close-range frames and the monocular one over the
    first TUM frames: tracked, keyframes mapped by the worker, invariants
    clean, threads joined. Phase 23's pub/sub and phase 24's Viewer (its
    PNGs to `viz_dir`) run on the RGB-D drive, outside the timed calls."""
    from orb_slam2_2021_tpu_torch.config import tum_rgbd_config
    from orb_slam2_2021_tpu_torch.pipeline.system import System

    cfg = tum_rgbd_config("freiburg1")
    n = ASYNC_SENSOR_FRAMES
    out = {}
    for sensor in ("rgbd", "mono"):
        sys_ = System(cfg, sensor=sensor, async_mode=True, device=dev)
        pub = DrivePublisher(sys_) if sensor == "rgbd" else None
        viewer = DriveViewer(sys_, viz_dir) if sensor == "rgbd" else None
        _zero_launch_counts()
        tracked, init = 0, None
        for i in range(n):
            pose = (sys_.track_rgbd(*close_frames[i], timestamp=0.1 * i) if sensor == "rgbd"
                    else sys_.track_monocular(tum_frames[i][0], timestamp=0.1 * i))
            if pose is not None:
                tracked += 1
                init = i if init is None else init
            if pub is not None:
                pub.frame(i, 0.1 * i, pose)
            if viewer is not None:
                viewer.frame(close_frames[i][0])
        sys_.shutdown()
        _check_threads(sys_, f"async {sensor} drive")
        best2, matrix = _launch_counts()
        bad = sys_.map.check_invariants()
        ms = 1e3 * np.asarray(sys_.frame_times)
        log(f"phase 17, async {sensor} drive: {tracked}/{n} tracked (first at frame {init}), "
            f"{sys_.map.next_kf} keyframes created, {len(bad)} invariant violations, median "
            f"{np.median(ms):.2f} ms; hamming_best2 launches per thread "
            f"{dict(_best2_by_thread())}")
        _check_drive_launches(f"async {sensor} drive", best2, matrix)
        first_ok = 0 if sensor == "rgbd" else REF_MONO["init"] + 3
        if init is None or init > first_ok or tracked < n - init - 2 or sys_.map.next_kf < 3 or bad:
            raise AssertionError(f"async {sensor} drive: tracked {tracked}/{n} from frame {init}, "
                                 f"{sys_.map.next_kf} keyframes, invariants {bad[:5]}")
        out[sensor] = {"launches": best2, "matrix_launches": matrix}
        if pub is not None:
            out[sensor]["published"] = pub.check(f"async {sensor} drive", sync=False)
        if viewer is not None:
            out[sensor]["viewed"] = viewer.check(f"async {sensor} drive", n)
    return out


def profile_async_stretch(dev, frames):
    """Phase 18: a fresh async System (bench_torch.drive) over the orbit's
    first ASYNC_PROFILE_FRAMES[1] frames, the frames from
    ASYNC_PROFILE_FRAMES[0] on traced by torch.profiler (CUDA activity
    only): the device busy share and the kernels on each stream."""
    import bench_torch
    from torch.profiler import ProfilerActivity, profile

    from orb_slam2_2021_tpu_torch.config import kitti_stereo_config
    from orb_slam2_2021_tpu_torch.pipeline.system import System

    first, last = ASYNC_PROFILE_FRAMES
    sys_ = System(kitti_stereo_config(), async_mode=True, device=dev)
    prof = profile(activities=[ProfilerActivity.CUDA])

    def on_frame(i):
        if i == first:
            prof.start()

    bench_torch.drive(sys_, frames[:last], 0, hook=on_frame)
    torch.cuda.synchronize(dev)
    prof.stop()
    sys_.shutdown()
    _check_threads(sys_, "profiled async drive")
    busy, per_stream = _busy_share(prof)
    ms = 1e3 * np.asarray(sys_.frame_times[first:])
    log(f"phase 18 device busy share of async frames {first}..{last - 1} (torch.profiler, CUDA "
        f"activity only; union of kernel intervals over their span): {busy:.3f}; kernels per "
        f"stream id {per_stream}; lane median {np.median(ms):.2f} ms under the trace")
    return busy


def _kernels_in(fn):
    """(result, kernel launches, summed kernel ms) of one call, by
    torch.profiler with CUDA activity."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    return out, len(kern), sum(e.device_time_total for e in kern) / 1e3


def _event_ms(fn):
    """(result, ms between CUDA events around one call)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def _dense_cfg():
    import dataclasses

    from orb_slam2_2021_tpu_torch.config import kitti_stereo_config

    cfg = kitti_stereo_config()
    return cfg.replace(optim=dataclasses.replace(cfg.optim, use_cg_local_ba=False))


def check_dense_ba_unit(dev, mapped):
    """Phase 19: the dense local BA (make_local_ba) of the last keyframe's
    window of phase 8's map, at the static shapes, on the card against the
    CPU path; the eigenproblem in float32 and in float64 on both; device
    time by CUDA events and launches per solve by torch.profiler. Phase 8
    has already solved that window, so its free poses and its points start
    perturbed (seeded: DENSE_PERTURB m)."""
    from orb_slam2_2021_tpu_torch.convert import camera_from_config
    from orb_slam2_2021_tpu_torch.optim import ba as tba
    from orb_slam2_2021_tpu_torch.optim.assemble import upload_problem
    from orb_slam2_2021_tpu_torch.pipeline.local_mapping import LocalMapping

    cfg = _dense_cfg()
    ocfg = cfg.optim
    m = mapped.map
    k = int(np.nonzero(m.kf_valid)[0].max())
    with m.lock:
        window = LocalMapping(cfg, m, "cpu")._local_ba_window(k)
    if window is None:
        raise AssertionError(f"keyframe {k} of phase 8's map has no local BA window")
    prob_h, cams, cam_free, mp = window[:4]
    rng = np.random.default_rng(19)
    free = prob_h.cam_free
    t0 = prob_h.t.copy()
    t0[free] += rng.normal(0, DENSE_PERTURB, (int(free.sum()), 3))
    xw0 = prob_h.xw.copy()
    xw0[: len(mp)] += rng.normal(0, DENSE_PERTURB, (len(mp), 3))
    prob_h = prob_h._replace(t=t0.astype(np.float32), xw=xw0.astype(np.float32))
    shape = (prob_h.R.shape[0], prob_h.xw.shape[0], prob_h.obs_cam.shape[0], prob_h.pt_obs.shape[1])
    if shape != (DENSE_C, DENSE_P, DENSE_O, DENSE_Q):
        raise AssertionError(f"dense window padded to {shape}")
    n_obs = int(prob_h.obs_valid.sum())
    cam = camera_from_config(cfg)
    solve = tba.make_local_ba(ocfg)
    gpu, cpu = upload_problem(prob_h, dev), upload_problem(prob_h, "cpu")

    def step(p):
        lam = torch.tensor(ocfg.lm_lambda_init, dtype=torch.float32, device=p.R.device)
        return tba._lm_step(cam, p, p.R, p.t, p.xw, p.obs_valid.float(), lam, True, ocfg)[:3]

    default = tba.EIG_DTYPE
    res = {}
    try:
        for dt in (torch.float32, torch.float64):
            tba.EIG_DTYPE = dt
            name = str(dt).split(".")[-1]
            res[name] = {"step_cuda": [x.cpu().numpy() for x in step(gpu)],
                         "step_cpu": [x.numpy() for x in step(cpu)],
                         "cpu": [x.numpy() for x in solve(cam, cpu)]}
            solve(cam, gpu)  # warm
            out, ms = _event_ms(lambda: solve(cam, gpu))
            res[name]["cuda"] = [x.cpu().numpy() for x in out]
            res[name]["ms"] = ms
        tba.EIG_DTYPE = default
        _, launches, kernel_ms = _kernels_in(lambda: solve(cam, gpu))
    finally:
        tba.EIG_DTYPE = default

    nc, npt = len(cams), len(mp)

    def diffs(a, b):
        dR = float(np.abs(a[0][:nc] - b[0][:nc]).max())
        dt = float(np.abs(a[1][:nc] - b[1][:nc]).max())
        dx = np.abs(a[2][:npt] - b[2][:npt]).max(axis=1)
        return dR, dt, float(np.percentile(dx, 99)), float(dx.max())

    ref = res["float64"]["cpu"]
    log(f"phase 19, dense local BA of keyframe {k}'s window: {nc} cameras ({int(cam_free.sum())} free), "
        f"{npt} points, {n_obs} observations, padded to C={DENSE_C}, P={DENSE_P}, O={DENSE_O}, "
        f"Q={DENSE_Q}; default eigenproblem dtype {str(default).split('.')[-1]}")
    for name in ("float32", "float64"):
        r = res[name]
        sc, sp = diffs(r["step_cuda"], res["float64"]["step_cpu"]), diffs(r["step_cpu"], res["float64"]["step_cpu"])
        log(f"phase 19 eigh {name}: first step, card vs CPU float64 (R, t m, xw p99 m, xw max m) {sc}; "
            f"CPU {name} vs CPU float64 {sp}")
        cu, cp = diffs(r["cuda"], ref), diffs(r["cpu"], ref)
        agree_cu = float((r["cuda"][3] == ref[3])[prob_h.obs_valid].mean())
        log(f"phase 19 eigh {name}: solve, card vs CPU float64 {cu}, inlier flags agreeing "
            f"{agree_cu:.5f}; CPU {name} vs CPU float64 {cp}; card solve {r['ms']:.2f} ms (CUDA events)")
    card, host = res[str(default).split(".")[-1]]["cuda"], res[str(default).split(".")[-1]]["cpu"]
    dR, dt, dx99, _ = diffs(card, host)
    agree = float((card[3] == host[3])[prob_h.obs_valid].mean())
    moved = float(np.abs(host[1][:nc] - prob_h.t[:nc]).max())
    log(f"phase 19 default dtype, card vs CPU: R {dR:.2e}, t {dt:.2e} m, points p99 {dx99:.2e} m "
        f"(tolerances {DENSE_POSE_TOL}, {DENSE_POSE_TOL} m, {DENSE_POINT_TOL} m), inlier flags agreeing "
        f"{agree:.5f} (bound {DENSE_INLIER_AGREE}); the solve moved the cameras by up to {moved:.4f} m; "
        f"{launches} kernel launches and {kernel_ms:.2f} ms of kernel time per solve (torch.profiler)")
    if not (dR < DENSE_POSE_TOL and dt < DENSE_POSE_TOL and dx99 < DENSE_POINT_TOL):
        raise AssertionError("the dense local BA on the card disagrees with the CPU path")
    if agree < DENSE_INLIER_AGREE:
        raise AssertionError(f"inlier flags agree at {agree:.4f}")
    return {"ms_float32": res["float32"]["ms"], "ms_float64": res["float64"]["ms"],
            "launches": launches, "kernel_ms": kernel_ms}


def check_dist_gba(dev):
    """Phase 21: world size 1 under NCCL. Three iterations of the sharded
    global-BA step (make_dist_gba_iteration) against gba_iteration on a
    corridor problem at SCALE_1500KF.json's size, then make_dist_ba against
    ba_solve at the local-BA shape; ms per iteration and the one-hot's
    bytes."""
    import tempfile

    import torch.distributed as dist

    from orb_slam2_2021_tpu_torch.config import kitti_stereo_config
    from orb_slam2_2021_tpu_torch.convert import camera_from_config
    from orb_slam2_2021_tpu_torch.optim.assemble import global_problem_shapes, upload_problem
    from orb_slam2_2021_tpu_torch.optim.ba import ba_solve
    from orb_slam2_2021_tpu_torch.optim.ba_cg import flat_index, gba_iteration
    from orb_slam2_2021_tpu_torch.parallel.corridor import corridor_problem
    from orb_slam2_2021_tpu_torch.parallel.dist_ba import (make_dist_ba, make_dist_gba_iteration,
                                                           shard_ba_problem, upload_shard)
    from orb_slam2_2021_tpu_torch.parallel.multihost import init_process

    cfg = kitti_stereo_config()
    ocfg, cam = cfg.optim, camera_from_config(cfg)
    n_kf, n_pts, n_obs = SCALE_KF, SCALE_PTS, SCALE_OBS
    shapes = global_problem_shapes(n_kf, n_pts, n_obs)
    t0 = time.perf_counter()
    prob, *_ = corridor_problem(cam, n_kf, n_pts, n_obs, seed=0, window=8, C_pad=shapes[0],
                                P_pad=shapes[1], O_pad=shapes[2])
    packed = shard_ba_problem(prob, 1)
    log(f"phase 21, corridor problem {n_kf} keyframes, {n_pts} points, {n_obs} observations "
        f"(padded {shapes}; one shard: {packed.obs_cam.shape[0]} observation slots) built in "
        f"{time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        group, _ = init_process(f"file://{tmp}/rendezvous", 1, 0, device=dev)
        try:
            backend = dist.get_backend(group)
            if backend != "nccl":
                raise AssertionError(f"world size 1 on the card ran {backend}, not NCCL")
            torch.cuda.reset_peak_memory_stats(dev)
            dstep = make_dist_gba_iteration(ocfg, cam, group)
            runs = {}
            # the flat layout of _run_global_ba's single-process path; then
            # one shard, by gba_iteration and by the sharded step
            for name in ("flat", "shard", "sharded"):
                if name != "sharded":
                    p = upload_problem(prob, dev) if name == "flat" else upload_shard(packed, 0, 1, dev)
                    index = flat_index(p)
                step = dstep if name == "sharded" else (lambda *a: gba_iteration(cam, *a, ocfg))
                R, t, xw, lam = p.R, p.t, p.xw, torch.tensor(ocfg.lm_lambda_init, device=dev)
                active = p.obs_valid.float()
                ms, costs = [], []
                for _ in range(SCALE_ITERS):
                    (R, t, xw, lam, cost), dt_ms = _event_ms(
                        lambda: step(p, index, R, t, xw, lam, active, True))
                    ms.append(dt_ms)
                    costs.append(float(cost))
                runs[name] = {"R": R.cpu().numpy(), "t": t.cpu().numpy(), "xw": xw.cpu().numpy(),
                              "lam": float(lam), "ms": ms, "costs": costs,
                              "onehot_bytes": index.onehot.numel() * index.onehot.element_size()}
                if name == "flat":
                    del p, index
                del R, t, xw, active
            peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
            a, b, f = runs["sharded"], runs["shard"], runs["flat"]
            exact = all(np.array_equal(a[k], b[k]) for k in ("R", "t", "xw", "costs")) and a["lam"] == b["lam"]
            dR = float(np.abs(a["R"] - f["R"]).max())
            dt = float(np.abs(a["t"] - f["t"]).max())
            dx = float(np.percentile(np.abs(a["xw"][:n_pts] - f["xw"][:n_pts]).max(axis=1), 99))
            dc = max(abs(x - y) / y for x, y in zip(a["costs"], f["costs"]))
            moved = float(np.abs(a["t"][:n_kf] - prob.t[:n_kf]).max())
            for name, r in runs.items():
                log(f"phase 21 {name} ({backend + ' group' if name == 'sharded' else 'gba_iteration'}): "
                    f"ms per iteration (CUDA events) {[round(x, 2) for x in r['ms']]}, costs "
                    f"{[round(x, 1) for x in r['costs']]}, one-hot {r['onehot_bytes'] / 1e9:.3f} GB")
            log(f"phase 21 sharded step vs gba_iteration on the same shard: identical {exact}; against "
                f"the flat layout after {SCALE_ITERS} iterations (the same sums in another order): R "
                f"{dR:.2e}, t {dt:.2e} m (cameras moved up to {moved:.3f} m), points p99 {dx:.2e} m, "
                f"costs {dc:.2e} relative, lambda {a['lam']} / {f['lam']} (bounds {SCALE_TOL}); peak "
                f"device memory {peak_gb:.2f} GB")
            if not exact:
                raise AssertionError("the sharded step at world size 1 differs from gba_iteration")
            if not (dR < SCALE_TOL["R"] and dc < SCALE_TOL["cost"] and a["lam"] == f["lam"]):
                raise AssertionError("the sharded global BA disagrees with the flat layout's")
            if not a["costs"][-1] < a["costs"][0]:
                raise AssertionError("the global BA did not lower the cost")

            # make_dist_ba against ba_solve at the local-BA shape: on the
            # same shard exactly, and beside the padded layout
            lp, *_ = corridor_problem(cam, DENSE_C, DENSE_P, 24000, seed=1, window=DENSE_Q - 1,
                                      n_fixed=DENSE_C // 2, O_pad=DENSE_O)
            shard = upload_shard(shard_ba_problem(lp, 1), 0, 1, dev)
            iters = (ocfg.local_ba_iters1, ocfg.local_ba_iters2)
            (R1, t1, x1, i1), ms_solve = _event_ms(lambda: ba_solve(cam, shard, ocfg, *iters))
            (R2, t2, x2, i2), ms_dist = _event_ms(lambda: make_dist_ba(ocfg, group)(cam, shard))
            R3, t3, x3, i3 = ba_solve(cam, upload_problem(lp, dev), ocfg, *iters)
            same = all(torch.equal(u, v) for u, v in ((R1, R2), (t1, t2), (x1, x2), (i1, i2)))
            n = int(lp.obs_valid.sum())
            d = [float((R2 - R3).abs().max()), float((t2 - t3).abs().max()),
                 float(torch.quantile((x2 - x3).abs().amax(dim=1), 0.99))]
            flags = bool(torch.equal(i2[:n], i3[:n]))
            log(f"phase 21 make_dist_ba vs ba_solve at C={DENSE_C}, P={DENSE_P}, O={DENSE_O} ({n} "
                f"observations): identical on the same shard {same}; against the padded layout R, t, "
                f"points p99 differ by {d}, inlier flags identical {flags}; {ms_dist:.2f} ms against "
                f"{ms_solve:.2f} ms (CUDA events)")
            if not (same and flags):
                raise AssertionError("make_dist_ba disagrees with ba_solve")
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    return {"ms_flat": runs["flat"]["ms"], "ms_shard": runs["shard"]["ms"], "ms_sharded": runs["sharded"]["ms"],
            "onehot_gb": runs["sharded"]["onehot_bytes"] / 1e9, "peak_gb": peak_gb,
            "points": np.asarray(prob.xw[:n_pts], np.float32)}


def start_dist_live(frames, gt, device="cuda", config="kitti"):
    """Phase 22, started: scripts/torch_dist_live_2proc.py at KITTI width
    over the orbit of phase 11 in a process group of its own (rank 0 the
    default sync System with a GbaClient, rank 1 a GbaServer, both on this
    card). Returns what finish_dist_live needs."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_live_")
    path = os.path.join(tmp, "frames.npz")
    np.savez(path, frames=np.asarray(frames, np.uint8), gt_R=np.asarray([R for R, _ in gt]),
             gt_t=np.asarray([t for _, t in gt]))
    cmd = [sys.executable, os.path.join(REPO, "scripts", "torch_dist_live_2proc.py"), "--device",
           device, "--config", config, "--frames-file", path, "--no-ref", "--out",
           os.path.join(tmp, "out")]
    log("phase 22 started: two ranks in processes of their own")
    p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         start_new_session=True, cwd=REPO)
    return p, tmp, time.perf_counter()


def stop_dist_live(started):
    """Kill phase 22's process group if it still runs; remove its files."""
    import shutil
    import signal

    p, tmp, _ = started
    if p.poll() is None:
        os.killpg(p.pid, signal.SIGKILL)
        p.wait()
    shutil.rmtree(tmp, ignore_errors=True)


def finish_dist_live(started, sync_ms):
    """Phase 22, joined: the loop must fire at the reference's pair and
    frame, the server solve, the leader write back, and ATE stay within
    bound. The caller stops the group (stop_dist_live) whatever happens."""
    p, tmp, t0 = started
    try:
        stdout, _ = p.communicate(timeout=max(1.0, LIVE_TIMEOUT_S - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"the two-rank live drive outlived {LIVE_TIMEOUT_S} s")
    wall = time.perf_counter() - t0
    if p.returncode != 0 or not stdout.strip():
        logs = ""
        for role in ("leader", "server"):
            lp = os.path.join(tmp, "out", f"{role}.log")
            if os.path.exists(lp):
                logs += f"\n{role}: " + open(lp).read()[-2000:]
        raise AssertionError(f"two-rank live drive failed (exit {p.returncode}):\n{stdout[-3000:]}{logs}")
    res = json.loads(stdout.strip().splitlines()[-1])
    lead, srv = res["leader"], res["server"]
    loop = lead["loops"][0] if lead["loops"] else None
    written = [g for g in lead["gba_runs"] if g["outcome"] == "written"]
    log(f"phase 22, two ranks ({lead['backend']}, one card): leader {lead['n_ok']}/{lead['n_frames']} tracked, "
        f"{lead['n_kf']} keyframes, loops {lead['loops']} (phase 11 and the JAX reference: frame "
        f"{REF_LOOP_FRAME}, keyframe {REF_LOOP_PAIR[0]} against {REF_LOOP_PAIR[1]}), global BA runs "
        f"{lead['gba_runs']}, ms per GBA iteration {[round(x, 1) for x in lead['gba_iter_ms']]}; server "
        f"solved {srv['solved']}; ATE {lead['ate']:.4f} m over {lead['length']:.3f} m; leader median "
        f"{lead['ms_median']:.2f} ms per frame (sync phase 11: {np.median(sync_ms):.2f}; this one ran "
        f"beside the CUDA-vs-CPU checks); {wall:.1f} s in all")
    _check_drive_launches("two-rank live drive", lead["hamming_best2_launches"], lead["hamming_matrix_launches"])
    if not res["ok"]:
        raise AssertionError("the two-rank live drive's own checks failed")
    if loop is None or (loop[1], loop[2]) != REF_LOOP_PAIR or abs(loop[0] - REF_LOOP_FRAME) > 5:
        raise AssertionError(f"loop {loop} is not the reference's pair {REF_LOOP_PAIR} near frame {REF_LOOP_FRAME}")
    if srv["solved"] < 1 or not written:
        raise AssertionError("the server solved nothing or nothing was written back")
    if not lead["ate"] < 0.05 * lead["length"]:
        raise AssertionError(f"ATE {lead['ate']:.4f} m is not below 5% of {lead['length']:.3f} m")
    return {"launches": lead["hamming_best2_launches"], "matrix_launches": lead["hamming_matrix_launches"]}


def _nd(d):
    """An ndarray from its NDJSON form ({"__nd__", "dtype", "shape", "data"})."""
    return np.asarray(d["data"], dtype=d["dtype"]).reshape(d["shape"])


class DrivePublisher:
    """Phase 23's pub/sub on a drive: a SystemPublisher and a TcpPublisher
    on the five topics of run_slam.py --publish, read by a subscriber socket
    on a thread of its own. `frame` runs after each track_* call, outside
    the timed call; `check` closes the publisher and holds what arrived."""

    def __init__(self, sys_):
        import socket
        import threading

        from orb_slam2_2021_tpu_torch.io.pubsub import (TOPIC_GRID, TOPIC_GRID_POSE, TOPIC_METRICS,
                                                        TOPIC_POINTCLOUD, TOPIC_POSE, MessageBus,
                                                        SystemPublisher, TcpPublisher)

        self.sys_ = sys_
        bus = MessageBus()
        self.spub = SystemPublisher(sys_, bus)
        self.tcp = TcpPublisher(bus, [TOPIC_POSE, TOPIC_POINTCLOUD, TOPIC_GRID, TOPIC_GRID_POSE,
                                      TOPIC_METRICS])
        self.sock = socket.create_connection(("127.0.0.1", self.tcp.port), timeout=30)
        self.sock.settimeout(None)
        deadline = time.perf_counter() + 30
        while self.tcp.n_subscribers == 0:
            if time.perf_counter() > deadline:
                raise AssertionError("the publisher never accepted the subscriber")
            time.sleep(0.01)
        self.lines = []   # (topic, bytes, message) in arrival order
        self.poses = []   # (timestamp, (R, t)) of each call that returned a pose
        self.maps = []    # (timestamp, host ms of publish_map, cloud, grid) read at that frame
        self.reader = threading.Thread(target=self._read, name="subscriber", daemon=True)
        self.reader.start()

    def _read(self):
        with self.sock.makefile("rb") as f:
            for line in f:
                msg = json.loads(line)
                self.lines.append((msg["topic"], len(line), msg["msg"]))

    def frame(self, i, ts, pose):
        if pose is not None:
            self.poses.append((ts, pose))
        self.spub.publish_frame(ts)
        if i % PUBLISH_EVERY == 0:
            t0 = time.perf_counter()
            self.spub.publish_map(ts)
            ms = 1e3 * (time.perf_counter() - t0)
            self.maps.append((ts, ms, self.sys_.point_cloud(), self.sys_.occupancy_grid().data))

    def check(self, name, sync):
        """Every call that returned a pose gave one os2_pose line whose Twc
        inverts it; every os2_metrics line is a valid record; one map
        message per publish_map (in a sync drive the last cloud and grid
        equal the System's at that frame); the laser-scan relay of the
        final cloud has finite ranges."""
        from orb_slam2_2021_tpu_torch.io.metrics import validate_record
        from orb_slam2_2021_tpu_torch.io.pubsub import pointcloud_to_laserscan

        self.tcp.close()
        self.reader.join(timeout=60)
        self.sock.close()
        if self.reader.is_alive():
            raise AssertionError(f"{name}: the subscriber never saw the publisher close")
        by_topic = {}
        for topic, n_bytes, msg in self.lines:
            by_topic.setdefault(topic, []).append((n_bytes, msg))
        pose_msgs = [m for _, m in by_topic.get("os2_pose", [])]
        worst = 0.0
        for ts, (R, t) in self.poses:
            got = [m for m in pose_msgs if m["t"] == ts]
            if len(got) != 1:
                raise AssertionError(f"{name}: {len(got)} os2_pose lines for the pose of t={ts}")
            # the rigid inverse (R^T, -R^T t) in float64: the tracker's R is
            # orthonormal only to float32 drift, so inv(Twc) is not R
            Twc = _nd(got[0]["Twc"])
            Rt = np.asarray(R, np.float64).T
            worst = max(worst, float(np.abs(Twc[:3, :3] - Rt).max()),
                        float(np.abs(Twc[:3, 3] + Rt @ np.asarray(t, np.float64)).max()))
        if not self.poses or worst > POSE_TOL:
            raise AssertionError(f"{name}: {len(self.poses)} poses, Twc off by {worst:.2e}")
        metrics = [m for _, m in by_topic.get("os2_metrics", [])]
        for rec in metrics:
            validate_record(rec)
        clouds, grids = by_topic.get("os2_pointcloud", []), by_topic.get("os2_gm", [])
        if not metrics or len(clouds) != len(self.maps) or len(grids) != len(self.maps):
            raise AssertionError(f"{name}: {len(metrics)} metrics, {len(clouds)} clouds and "
                                 f"{len(grids)} grids for {len(self.maps)} map publications")
        ts, ms, cloud, grid = self.maps[-1]
        if sync and not (np.array_equal(_nd(clouds[-1][1]["points"]), cloud)
                         and np.array_equal(_nd(grids[-1][1]["data"]), grid)):
            raise AssertionError(f"{name}: the last published cloud or grid is not the System's")
        map_bytes = sum(n for topic in ("os2_pointcloud", "os2_gm", "os2_gm_pose")
                        for n, m in by_topic.get(topic, []) if m["t"] == ts)
        final = self.sys_.point_cloud()
        ranges, _ = pointcloud_to_laserscan(final)
        n_finite = int(np.isfinite(ranges).sum())
        if n_finite == 0:
            raise AssertionError(f"{name}: the laser scan of the final cloud has no finite range")
        pub_ms = [round(m[1], 2) for m in self.maps]
        log(f"phase 23 pub/sub, {name}: {len(self.lines)} lines ({sum(n for _, n, _ in self.lines)} bytes), "
            f"{len(pose_msgs)} os2_pose for {len(self.poses)} returned poses (Twc within {worst:.1e}), "
            f"{len(metrics)} valid os2_metrics, {len(self.maps)} map publications; the last "
            f"publish_map (t={ts:.1f}, {len(cloud)} points, grid {grid.shape[0]}x{grid.shape[1]}): "
            f"{map_bytes} bytes, host ms per publish_map {pub_ms}; laser scan of the final "
            f"{len(final)} points: {n_finite}/{len(ranges)} finite ranges")
        return {"lines": len(self.lines), "map_bytes": map_bytes, "publish_map_ms": pub_ms,
                "scan_finite": n_finite}


def kitti_lens(deg):
    """(K, D, R, P, size) of a KITTI-width rectification: K of
    kitti_stereo_config(), the SMALL_LENS coefficients, a rotation of `deg`
    degrees about the camera's y axis, P = [K | 0], 1241x376."""
    from orb_slam2_2021_tpu_torch.config import kitti_stereo_config

    cfg = kitti_stereo_config()
    K = np.array([[cfg.fx, 0, cfg.cx], [0, cfg.fy, cfg.cy], [0, 0, 1.0]])
    th = np.deg2rad(deg)
    R = np.array([[np.cos(th), 0, np.sin(th)], [0, 1, 0], [-np.sin(th), 0, np.cos(th)]])
    return K, np.asarray(SMALL_LENS), R, np.concatenate([K, np.zeros((3, 1))], axis=1), (cfg.width, cfg.height)


def remap_bound(h, w):
    """A remapped pair: per image the uint8 image and the two float32 maps
    read once, the float32 output written once; no arithmetic bound."""
    return _bound(2 * h * w * (1 + 8 + 4), 0)


def sor_bound(n):
    """The SOR kNN: the [N, N] float32 distances written and read once;
    3 FMAs (6 float32 operations) per pair over the fp32 rate."""
    t_bytes = 1e3 * 8.0 * n * n / H100_BYTES_PER_S
    t_ops = 1e3 * 6.0 * n * n / H100_FP32_FLOPS_PER_S
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_rectify(dev, orbit_pair, work):
    """Phase 23, rectify: maps from the arducam settings (640x480) and at
    KITTI width (kitti_stereo_config()'s K, SMALL_LENS, a RECTIFY_DEG
    rotation); a rendered pair remapped on the card and on the CPU path;
    pixels with no corner inside exactly 0 on both; an identity map; device
    ms and launches per pair."""
    from orb_slam2_2021_tpu_torch.config import synthetic_config
    from orb_slam2_2021_tpu_torch.io.rectify import build_rectify_map, rectification_from_yaml, remap
    from orb_slam2_2021_tpu_torch.io.synthetic import SyntheticStereoWorld, forward_trajectory

    path = os.path.join(work, "arducam.yaml")
    with open(path, "w") as f:
        f.write(ARDUCAM_YAML)
    world = SyntheticStereoWorld(synthetic_config(width=640, height=480), seed=WORLD_SEED)
    pair640 = np.clip(np.stack(world.render(*forward_trajectory(1, STEP)[0])), 0, 255).astype(np.uint8)
    kitti = tuple(build_rectify_map(*kitti_lens(d)) for d in (RECTIFY_DEG, -RECTIFY_DEG))
    out = {}
    for label, maps, pair in (("arducam 640x480", rectification_from_yaml(path), pair640),
                              ("KITTI 1241x376", kitti, orbit_pair)):
        h, w = maps[0].map_x.shape
        on_card = [torch.from_numpy(img).to(dev) for img in pair]
        card = [remap(img, m, dev) for img, m in zip(on_card, maps)]
        cpu = [remap(img, m, "cpu") for img, m in zip(pair, maps)]
        _require_on_card(card, "remap")
        err, n_out = 0.0, 0
        for g, c, m in zip(card, cpu, maps):
            if g.dtype != torch.float32 or tuple(g.shape) != (h, w):
                raise AssertionError(f"remap gave {g.dtype} {tuple(g.shape)}")
            err = max(err, float((g.cpu() - c).abs().max()))
            outside = torch.from_numpy((m.map_x < -1) | (m.map_x >= w) | (m.map_y < -1) | (m.map_y >= h))
            n_out += int(outside.sum())
            if not ((g.cpu()[outside] == 0).all() and (c[outside] == 0).all()):
                raise AssertionError(f"{label}: a pixel with no corner inside the image is not 0")
        _, launches, kern_ms = _kernels_in(lambda: [remap(i, m, dev) for i, m in zip(on_card, maps)])
        ms = device_ms(lambda: [remap(i, m, dev) for i, m in zip(on_card, maps)])
        bound, by = remap_bound(h, w)
        log(f"phase 23 rectify {label}: card vs CPU max |diff| {err:.2e} (bound {RECTIFY_TOL}), "
            f"{n_out} pixels with no corner inside, 0 on both; per pair (images on the card, uint8): "
            f"{launches} launches, {ms:.4f} ms (device_ms), {kern_ms:.4f} ms of kernels (profiler); "
            f"bound {bound:.4f} ms by {by}")
        if err > RECTIFY_TOL:
            raise AssertionError(f"{label}: remap card vs CPU differs by {err}")
        out[label] = {"ms": ms, "launches": launches, "bound_ms": bound, "max_abs_err": err}
    K, _, _, P, size = kitti_lens(0.0)
    ident = build_rectify_map(K, np.zeros(5), np.eye(3), P, size)
    img = torch.from_numpy(orbit_pair[0]).to(dev)
    err = float((remap(img, ident, dev) - img.float()).abs().max())
    log(f"phase 23 rectify identity map {size[0]}x{size[1]}: max |diff| {err:.2e} (bound {IDENTITY_TOL})")
    if err > IDENTITY_TOL:
        raise AssertionError(f"the identity map moved the image by {err}")
    return out


def check_map_processor(dev, map_path, out_dir):
    """Phase 23, map processor: MapProcessor on the card over phase 11's
    saved map; its PLY, TUM and PGM files; one TUM row per live keyframe."""
    from orb_slam2_2021_tpu_torch.config import kitti_stereo_config
    from orb_slam2_2021_tpu_torch.tools.map_processor import MapProcessor

    t0 = time.perf_counter()
    mp = MapProcessor(map_path, kitti_stereo_config(), device=dev)
    os.makedirs(out_dir, exist_ok=True)
    files = {f: os.path.join(out_dir, f) for f in ("pointcloud.ply", "kf_trajectory_tum.txt", "gridmap.pgm")}
    mp.save_point_cloud_ply(files["pointcloud.ply"])
    mp.save_trajectory_tum(files["kf_trajectory_tum.txt"])
    grid = mp.save_grid_map_pgm(files["gridmap.pgm"])
    secs = time.perf_counter() - t0
    n_kf, n_mp = int(mp.map.kf_valid.sum()), int(mp.map.mp_valid.sum())
    rows = np.loadtxt(files["kf_trajectory_tum.txt"], ndmin=2)
    n_ply = int(open(files["pointcloud.ply"]).read().split("element vertex ")[1].split()[0])
    log(f"phase 23 map processor on the card, phase 11's map ({n_kf} keyframes, {n_mp} points): "
        f"{n_ply} points kept by the filter, {len(rows)} TUM rows, grid {grid.data.shape}, "
        f"{int((grid.data == 100).sum())} occupied and {int((grid.data == 0).sum())} free cells; "
        f"{secs:.2f} s (host clock, load to the last file)")
    if any(os.path.getsize(p) == 0 for p in files.values()):
        raise AssertionError("the map processor wrote an empty file")
    if len(rows) != n_kf or rows.shape[1] != 8:
        raise AssertionError(f"{len(rows)} TUM rows for {n_kf} live keyframes")
    if not 0 < n_ply <= n_mp:
        raise AssertionError(f"the filtered cloud has {n_ply} of {n_mp} points")
    return {"files": files, "n_kf": n_kf, "n_points": n_mp, "kept": n_ply}


def check_map_processor_cpu(card, map_path, out_dir):
    """Phase 23's CPU half: the same map processed on the CPU path; the PGM
    against the card's, cell for cell."""
    from orb_slam2_2021_tpu_torch.config import kitti_stereo_config
    from orb_slam2_2021_tpu_torch.tools.map_processor import MapProcessor

    mp = MapProcessor(map_path, kitti_stereo_config(), device="cpu")
    os.makedirs(out_dir, exist_ok=True)
    pgm = os.path.join(out_dir, "gridmap.pgm")
    mp.save_grid_map_pgm(pgm)
    a, b = open(card["files"]["gridmap.pgm"], "rb").read(), open(pgm, "rb").read()
    if len(a) != len(b):
        raise AssertionError("the card's and the CPU's PGM differ in size")
    n_diff = int((np.frombuffer(a, np.uint8) != np.frombuffer(b, np.uint8)).sum())
    log(f"phase 23 map processor PGM, card vs CPU path: {n_diff} cells differ (bound {PGM_CELLS_BOUND})")
    if n_diff > PGM_CELLS_BOUND:
        raise AssertionError(f"{n_diff} PGM cells differ between the card and the CPU")
    return n_diff


def check_sor(dev, points):
    """Phase 23, SOR at real size: the filter on phase 21's corridor
    points on the card (time, block size, peak memory, kept share,
    launches, kernel time, bound); the kNN means of a SOR_SUBSET-point
    subset on the card, for the CPU half."""
    from orb_slam2_2021_tpu_torch.tools.map_processor import (mean_knn_distances, sor_block_rows,
                                                              statistical_outlier_filter)

    n = len(points)
    torch.cuda.reset_peak_memory_stats(dev)
    # one run at full size (about 8 s): CUDA events around the call, inside
    # the profiler's window
    (keep, ms), launches, kern_ms = _kernels_in(
        lambda: _event_ms(lambda: statistical_outlier_filter(points, SOR_K, device=dev)))
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    bound, by = sor_bound(n)
    log(f"phase 23 SOR at {n} points (k={SOR_K}): {ms:.1f} ms (CUDA events, upload to mask), "
        f"{kern_ms:.1f} ms of device activity over {launches} launches and copies (profiler); blocks of "
        f"{sor_block_rows(n)} rows, peak device memory {peak_gb:.2f} GB; kept {keep.mean():.4f}; "
        f"bound {bound:.1f} ms by {by}, {bound / kern_ms:.1%} of the device time")
    if not 0.5 < keep.mean() < 1.0:
        raise AssertionError(f"the filter kept {keep.mean():.4f} of the corridor")
    rng = np.random.default_rng(WORLD_SEED)
    sub = np.ascontiguousarray(points[np.sort(rng.choice(n, SOR_SUBSET, replace=False))], np.float32)
    ps = torch.from_numpy(sub).to(dev)
    md = mean_knn_distances(ps, SOR_K).cpu().numpy()
    sub_ms = device_ms(lambda: mean_knn_distances(ps, SOR_K), iters=5, warm=1)
    _, sub_launches, _ = _kernels_in(lambda: mean_knn_distances(ps, SOR_K))
    log(f"phase 23 SOR kNN means at {SOR_SUBSET} points: {sub_ms:.3f} ms (device_ms), "
        f"{sub_launches} launches; bound {sor_bound(SOR_SUBSET)[0]:.3f} ms")
    torch.cuda.empty_cache()
    return {"n": n, "ms": ms, "kernel_ms": kern_ms, "launches": launches, "bound_ms": bound,
            "peak_gb": peak_gb, "kept": float(keep.mean()), "subset": sub, "subset_md": md,
            "subset_keep": statistical_outlier_filter(sub, SOR_K, device=dev),
            "subset_ms": sub_ms, "subset_launches": sub_launches}


def check_sor_cpu(card):
    """Phase 23's CPU half of the SOR: the subset's kNN means and keep flags
    on the CPU path against the card's."""
    from orb_slam2_2021_tpu_torch.tools.map_processor import (mean_knn_distances,
                                                              statistical_outlier_filter)

    sub = card["subset"]
    md = mean_knn_distances(torch.from_numpy(sub), SOR_K).numpy()
    rel = float(np.max(np.abs(card["subset_md"] - md) / md))
    agree = float((statistical_outlier_filter(sub, SOR_K, device="cpu") == card["subset_keep"]).mean())
    log(f"phase 23 SOR at {len(sub)} points, card vs CPU path: kNN means within {rel:.2e} relative "
        f"(bound {SOR_RTOL}), keep flags equal on {agree:.5f} (bound {SOR_KEEP_AGREE})")
    if rel > SOR_RTOL or agree < SOR_KEEP_AGREE:
        raise AssertionError("the SOR on the card disagrees with the CPU path")
    return rel, agree


class DriveViewer:
    """Phase 24's Viewer on a drive: `Viewer(sys_, out_dir, stride=
    VIEWER_STRIDE)` updated after each track_* call, outside the timed
    call, with the host ms of each update that draws; `check` counts the
    PNGs and reports the ms and, in async mode, the map lock's hold per
    update."""

    def __init__(self, sys_, out_dir):
        from orb_slam2_2021_tpu_torch.viz import Viewer

        self.out_dir = out_dir
        self.viewer = Viewer(sys_, out_dir=out_dir, stride=VIEWER_STRIDE)
        self.async_mode = sys_.async_mode
        self.ms = []

    def frame(self, image):
        t0 = time.perf_counter()
        drawn = self.viewer.update(image)
        if drawn is not None:
            self.ms.append(1e3 * (time.perf_counter() - t0))

    def check(self, label, n_frames):
        n_drawn = -(-n_frames // VIEWER_STRIDE)
        pngs = sorted(os.listdir(self.out_dir))
        holds = 1e3 * np.asarray(self.viewer.lock_holds)
        hold = (f"map lock held {np.median(holds):.3f} ms per update (median; max {holds.max():.3f})"
                if len(holds) else "no map lock (sync)")
        log(f"phase 24 viewer on the {label}: {len(pngs)} PNGs for {n_frames} frames at stride "
            f"{VIEWER_STRIDE}, host ms per drawn update median {np.median(self.ms):.2f} (max "
            f"{max(self.ms):.2f}); {hold}")
        want = sorted(f"{kind}_{i:06d}.png" for kind in ("frame", "map")
                      for i in range(0, n_frames, VIEWER_STRIDE))
        if pngs != want or len(self.ms) != n_drawn:
            raise AssertionError(f"{label} viewer wrote {pngs}, drew {len(self.ms)} updates")
        if len(holds) != (n_drawn if self.async_mode else 0):
            raise AssertionError(f"{label} viewer held the map lock {len(holds)} times")
        return {"pngs": len(pngs), "ms": self.ms, "lock_hold_ms": holds.tolist()}


def _project_lens(K, dist, R, t, obj):
    """Board corners [M, 3] through the pose (R, t) and the Brown lens of
    `K` (fx, fy, cx, cy) and `dist` -> pixels [M, 2]."""
    fx, fy, cx, cy = K
    k1, k2, p1, p2, k3 = dist
    xc = obj @ R.T + t
    x, y = xc[:, 0] / xc[:, 2], xc[:, 1] / xc[:, 2]
    r2 = x * x + y * y
    rad = 1 + k1 * r2 + k2 * r2 ** 2 + k3 * r2 ** 3
    xd = x * rad + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * rad + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return np.stack([fx * xd + cx, fy * yd + cy], axis=1)


def calibration_views():
    """Phase 24's stereo views: CALIB_VIEWS poses of the board (tilted up to
    0.5 rad, its center 0.9-2.2 m away at a random place in the image),
    kept where every corner lands inside both images; the corners projected
    through each eye's lens, with CALIB_NOISE_PX of noise. Returns (left
    views, right views), each a list of [M, 2] float64 arrays."""
    from orb_slam2_2021_tpu_torch.tools.calibration import _rodrigues_np, board_points

    obj = board_points(*CALIB_BOARD)
    center = obj.mean(axis=0)
    w, h = CALIB_SIZE
    fx, fy, cx, cy = CALIB_LEFT_K
    R_rl = _rodrigues_np(np.array([0.0, CALIB_TOE_RAD, 0.0]))
    t_rl = np.array([-CALIB_BASELINE, 0.0, 0.0])
    rng = np.random.default_rng(CALIB_SEED)
    left, right = [], []
    while len(left) < CALIB_VIEWS:
        R = _rodrigues_np(rng.uniform(-0.5, 0.5, 3))
        z = rng.uniform(0.9, 2.2)
        u, v = rng.uniform(0.2, 0.8) * w, rng.uniform(0.2, 0.8) * h
        t = np.array([(u - cx) / fx * z, (v - cy) / fy * z, z]) - R @ center
        pl = _project_lens(CALIB_LEFT_K, CALIB_DIST, R, t, obj)
        pr = _project_lens(CALIB_RIGHT_K, CALIB_DIST, R_rl @ R, R_rl @ t + t_rl, obj)
        inside = [(p[:, 0] >= 2).all() and (p[:, 0] <= w - 3).all() and (p[:, 1] >= 2).all()
                  and (p[:, 1] <= h - 3).all() for p in (pl, pr)]
        if all(inside):
            left.append(pl + rng.normal(0.0, CALIB_NOISE_PX, pl.shape))
            right.append(pr + rng.normal(0.0, CALIB_NOISE_PX, pr.shape))
    return left, right


def _calibrators():
    from orb_slam2_2021_tpu_torch.tools.calibration import StereoCalibrator

    left, right = calibration_views()
    stereo = StereoCalibrator(*CALIB_BOARD, CALIB_SIZE)
    for vl, vr in zip(left, right):
        stereo.add_view(vl, vr)
    return stereo


def _syncs_in(fn):
    """(result, the places (file:line) of the host syncs the call made), as
    torch's sync debug mode warns of them (its note that the mode is a
    prototype is not one)."""
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, [f"{os.path.relpath(w.filename, REPO)}:{w.lineno}" for w in caught
                 if "called a synchronizing" in str(w.message)]


def lm_bound(n_views, n_pts, iters, dtype):
    """The LM's least time: its float operations over the card's peak rate
    (its bytes, tiny inputs and outputs, bound nothing). Per iteration:
    JtJ and Jt r (2 * rows * P^2 and 2 * rows * P), the LU solve (2/3 P^3),
    two residuals and the forward-mode Jacobian (P + 2 evaluations of about
    60 operations a corner)."""
    P, rows = 9 + 6 * n_views, 2 * n_views * n_pts
    ops = iters * (2 * rows * P * P + 2 * rows * P + 2 * P ** 3 / 3 + (P + 2) * 60 * n_views * n_pts)
    rate = H100_FP32_FLOPS_PER_S if dtype == torch.float32 else H100_FP64_TENSOR_FLOPS_PER_S
    return 1e3 * ops / rate, "operations"


def _k_params(K):
    return np.array([K[0, 0], K[1, 1], K[0, 2], K[1, 2]])


def check_calibration(dev, work):
    """Phase 24, calibration on the card: the LM of the left eye's 60 views
    (device ms by CUDA events, launches, host syncs inside the iterations)
    in float32 and float64; the stereo solve through StereoCalibrator on the
    card against the truth; its YAML through rectification_from_yaml and a
    pair remapped on the card against the CPU path."""
    from orb_slam2_2021_tpu_torch.io.rectify import rectification_from_yaml, remap
    from orb_slam2_2021_tpu_torch.tools import calibration as cal

    stereo = _calibrators()
    mono = stereo.left
    V, M = len(mono.views), len(mono.obj)
    probe = torch.ones(4, device=dev)
    if len(_syncs_in(lambda: probe.sum().item())[1]) != 1:  # the counter sees a readback
        raise AssertionError("the sync debug mode did not report a .item() readback")
    lm = {}
    default = cal.CALIB_DTYPE
    try:
        for dtype in (torch.float32, torch.float64):
            cal.CALIB_DTYPE = dtype
            inputs = mono.lm_inputs(dev)
            run = lambda: cal.lm_refine(*inputs)  # noqa: E731
            run()
            (theta, rms), ms = _event_ms(run)
            _, launches, kern_ms = _kernels_in(run)
            _, where = _syncs_in(run)
            syncs = len(where)
            bound, by = lm_bound(V, M, 30, dtype)
            name = str(dtype).split(".")[-1]
            lm[name] = {"ms": ms, "kernel_ms": kern_ms, "launches": launches, "syncs": syncs,
                        "bound_ms": bound, "theta": theta.cpu().numpy().astype(np.float64),
                        "rms": float(rms)}
            log(f"phase 24 calibration LM {name}, {V} views x {M} corners, 30 iterations on the card: "
                f"{ms:.3f} ms (CUDA events), {kern_ms:.3f} ms of kernels, {launches} launches "
                f"(profiler), {syncs} host syncs inside (sync debug mode), 1 readback a solve; "
                f"bound {bound:.4f} ms by {by}; rms {float(rms):.4f} px")
            if syncs:
                raise AssertionError(f"the {name} LM synced with the host at {where}")
    finally:
        cal.CALIB_DTYPE = default
    _, where = _syncs_in(lambda: mono.calibrate(device=dev))
    calib_syncs = len(where)
    t0 = time.perf_counter()
    card = stereo.calibrate(device=dev)
    stereo_s = time.perf_counter() - t0
    truth = {"left": np.array(CALIB_LEFT_K), "right": np.array(CALIB_RIGHT_K)}
    errs = {eye: np.abs(_k_params(getattr(card, eye).K) - truth[eye]) for eye in truth}
    log(f"phase 24 calibration on the card ({str(default).split('.')[-1]}): MonoCalibrator.calibrate "
        f"made {calib_syncs} host syncs (3 uploads, 1 readback); StereoCalibrator.calibrate "
        f"{1e3 * stereo_s:.1f} ms (host clock); K (fx, fy, cx, cy) left "
        f"{np.round(_k_params(card.left.K), 3).tolist()}, right "
        f"{np.round(_k_params(card.right.K), 3).tolist()}, off the truth by up to "
        f"{max(e.max() for e in errs.values()):.3f} px (bound {CALIB_TRUTH_PX}); k1 "
        f"{card.left.dist[0]:.4f} / {card.right.dist[0]:.4f} (truth {CALIB_DIST[0]}); rms "
        f"{card.left.rms:.4f} / {card.right.rms:.4f} px (bound {CALIB_RMS_MAX}); baseline "
        f"{card.baseline:.5f} m (truth {CALIB_BASELINE})")
    if max(e.max() for e in errs.values()) > CALIB_TRUTH_PX:
        raise AssertionError(f"calibration K off the truth by {errs}")
    if max(card.left.rms, card.right.rms) > CALIB_RMS_MAX:
        raise AssertionError(f"calibration rms {card.left.rms}, {card.right.rms}")
    if abs(card.baseline - CALIB_BASELINE) > CALIB_BASELINE_TOL:
        raise AssertionError(f"calibration baseline {card.baseline}")
    path = os.path.join(work, "calibrated.yaml")
    with open(path, "w") as f:
        f.write(cal.stereo_yaml(card))
    maps = rectification_from_yaml(path)
    pair = np.random.default_rng(CALIB_SEED).integers(0, 256, (2, CALIB_SIZE[1], CALIB_SIZE[0]),
                                                      dtype=np.uint8)
    on_card = [remap(torch.from_numpy(img).to(dev), m, dev) for img, m in zip(pair, maps)]
    _require_on_card(on_card, "remap")
    err = max(float((g.cpu() - remap(img, m, "cpu")).abs().max()) for g, img, m in zip(on_card, pair, maps))
    log(f"phase 24 stereo_yaml -> rectification_from_yaml -> remap of a pair: card vs CPU max |diff| "
        f"{err:.2e} (bound {RECTIFY_TOL})")
    if err > RECTIFY_TOL:
        raise AssertionError(f"calibrated remap card vs CPU differs by {err}")
    return {"lm": lm, "card": card, "mono": mono}


def check_calibration_cpu(card):
    """Phase 24's CPU half: the left eye's LM on the CPU in float64 and
    float32 against the card's solves; the card's in CALIB_DTYPE must be
    within CALIB_K_TOL px (K) and CALIB_RMS_TOL px (rms) of the CPU's
    float64."""
    from orb_slam2_2021_tpu_torch.tools import calibration as cal

    mono = card["mono"]
    default = cal.CALIB_DTYPE
    cpu = {}
    try:
        for dtype in (torch.float64, torch.float32):
            cal.CALIB_DTYPE = dtype
            cpu[str(dtype).split(".")[-1]] = mono.calibrate(device="cpu")
    finally:
        cal.CALIB_DTYPE = default
    rows = []
    for name, lm in card["lm"].items():
        res = mono.result(lm["theta"], lm["rms"])
        for ref in ("float64", "float32"):
            dk = np.abs(_k_params(res.K) - _k_params(cpu[ref].K)).max()
            dd = np.abs(res.dist - cpu[ref].dist).max()
            drms = abs(res.rms - cpu[ref].rms)
            rows.append((name, ref, dk, dd, drms))
            log(f"phase 24 calibration LM, card {name} vs CPU {ref}: K {dk:.2e} px, dist {dd:.2e}, "
                f"rms {drms:.2e} px (bounds {CALIB_K_TOL} px, {CALIB_RMS_TOL} px)")
    dk = np.abs(_k_params(cpu["float32"].K) - _k_params(cpu["float64"].K)).max()
    log(f"phase 24 calibration LM, CPU float32 vs CPU float64: K {dk:.2e} px, rms "
        f"{abs(cpu['float32'].rms - cpu['float64'].rms):.2e} px")
    kept = str(cal.CALIB_DTYPE).split(".")[-1]
    for name, ref, dk, _, drms in rows:
        if name == kept and ref == "float64" and (dk > CALIB_K_TOL or drms > CALIB_RMS_TOL):
            raise AssertionError(f"the card's {name} LM is {dk} px (K) and {drms} px (rms) off the "
                                 f"CPU's float64 solve")


def check_scale_twin(dev):
    """Phase 25: scripts/torch_scale_1500kf.py at full size on the card: the
    corridor map grown through the port's map paths (the final counts the
    reference script's), one global-BA assembly and three gba_iteration
    steps, the essential graph over every keyframe and its host write-back;
    no cost may rise, every pose finite; logs the curves, the ms, the
    launches, the graph's sizes and the peak memory."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch_scale_1500kf as twin

    torch.cuda.empty_cache()
    _zero_launch_counts()
    rec = twin.run(TWIN_REQUEST, dev, log=lambda msg: log(f"phase 25 {msg}"))
    best2, matrix = _launch_counts()
    gba, eg = rec["gba"], rec["essential_graph"]
    counts = (rec["n_kf_final"], rec["n_mp_final"], rec["n_obs_final"])
    log(f"phase 25 scale twin, {TWIN_REQUEST} keyframes asked for: {counts[0]} keyframes, {counts[1]} "
        f"points, {counts[2]} observations (the reference script on this tree: {TWIN_KF}, {TWIN_PTS}, "
        f"{TWIN_OBS}; SCALE_1500KF.json: {RECORD_KF}, {RECORD_PTS}, {RECORD_OBS}); growth "
        f"{rec['grow_s']:.2f} s; curve rows (n_kf, n_mp, ms add_kf, ms loop candidates, ms snapshot, "
        f"ms cull) {[(r['n_kf'], r['n_mp'], round(r['ms_add_kf'], 3), round(r['ms_loop_candidates'], 3), round(r['ms_snapshot'], 3), round(r['ms_kf_cull'], 3)) for r in rec['curves']]}")
    log(f"phase 25 global BA at C={gba['C']}, P={gba['P']}, O={gba['O']} (padded {gba['C_pad']}/"
        f"{gba['P_pad']}/{gba['O_pad']}): assembly {gba['assemble_s']:.2f} s, upload "
        f"{gba['upload_s']:.2f} s, flat index {gba['flat_index_ms']:.1f} ms, one-hot "
        f"{gba['onehot_bytes'] / 1e9:.2f} GB; iterations {[round(x, 2) for x in gba['iter_ms']]} ms (CUDA "
        f"events), candidate costs {gba['costs']}, robust cost {gba['cost_before']:.6e} -> "
        f"{gba['cost_after']:.6e} ({'fell' if gba['cost_after'] < gba['cost_before'] else 'stayed'}), "
        f"lambda {gba['lam']:.3g}")
    log(f"phase 25 essential graph over K={eg['K']} keyframes (padded {eg['K_pad']}), E={eg['E']} edges "
        f"(padded {eg['E_pad']}): {eg['s']:.3f} s in all, solve {eg['solve_ms']:.1f} ms (CUDA events), "
        f"{eg['launches']} launches (profiler, one more solve, counted in {eg['launch_count_s']:.1f} s), incidence [E, K] x 2 "
        f"{eg['incidence_bytes'] / 1e6:.1f} MB, write-back over {eg['n_points']} points "
        f"{eg['writeback_s']:.3f} s (host), edge cost {eg['cost_before']:.6e} -> {eg['cost_after']:.6e}; "
        f"peak device memory {rec['peak_memory_bytes'] / 1e9:.2f} GB; whole twin {rec['total_s']:.1f} s; "
        f"hamming_best2 launches {best2}, hamming_matrix launches {matrix}")
    if counts != (TWIN_KF, TWIN_PTS, TWIN_OBS):
        raise AssertionError(f"the scale twin's map has {counts}, the reference script's "
                             f"{(TWIN_KF, TWIN_PTS, TWIN_OBS)}")
    if not (np.isfinite(gba["costs"]).all() and gba["cost_after"] <= gba["cost_before"]):
        raise AssertionError(f"the scale twin's global BA: costs {gba['costs']}, "
                             f"{gba['cost_before']} -> {gba['cost_after']}")
    if not (np.isfinite(eg["cost_after"]) and eg["cost_after"] <= eg["cost_before"]):
        raise AssertionError(f"the essential graph's edge cost rose: {eg['cost_before']} -> {eg['cost_after']}")
    if not rec["poses_finite"] or not eg["launches"] or matrix != 0:
        raise AssertionError(f"scale twin: poses finite {rec['poses_finite']}, essential-graph launches "
                             f"{eg['launches']}, hamming_matrix launches {matrix}")
    return {"matrix_launches": matrix, "best2_launches": best2, "record": rec}


def check_frontend_microloop(dev):
    """Phase 26, on the card: bench_torch's front-end microloop at KITTI
    width (frontend_extra: 30 steps back to back after a warm-up, one fence,
    and one profiled step), counting hamming_best2's launches; then one more
    step whose two matcher calls (the stereo band, match_last_frame's
    radius-7 window) are captured, and the fused launcher held and timed at
    exactly those inputs. Returns the step's result for the CPU half."""
    import bench_torch
    from orb_slam2_2021_tpu_torch.config import kitti_stereo_config
    from orb_slam2_2021_tpu_torch.frontend import frame, matchers

    cfg = kitti_stereo_config()
    _zero_launch_counts()
    extra = bench_torch.frontend_extra(cfg, dev, lean=False)
    best2, matrix = _launch_counts()
    log(f"phase 26 front-end microloop at {cfg.width}x{cfg.height}: {extra['frontend_fps']} frames/s, "
        f"{extra['frontend_ms_per_step']} ms a step (host clock over {bench_torch.FRONTEND_STEPS} steps, "
        f"one fence), {extra['frontend_launches_per_step']} launches a step (profiler)")
    _check_drive_launches("front-end microloop", best2, matrix)
    step, inputs = bench_torch.frontend_step(cfg, dev)
    seen = {}
    undo = (frame.hamming_best2, matchers.hamming_best2)

    def capture(where, fn):
        def call(a, b, mask):
            seen.setdefault(where, (a, b, mask))
            return fn(a, b, mask)
        return call

    frame.hamming_best2 = capture("stereo", undo[0])
    matchers.hamming_best2 = capture("last_frame", undo[1])
    try:
        out = [x.cpu() for x in step(*inputs)]
    finally:
        frame.hamming_best2, matchers.hamming_best2 = undo
    max_err, times = 0, {}
    for where, (a, b, mask) in seen.items():
        label = f"front-end microloop {where} {a.shape[0]}x{b.shape[0]}, {float(mask.float().mean()):.4f} open"
        max_err = max(max_err, hold_hamming(a, b, mask, label))
        times[f"frontend_{where}"] = time_hamming(a, b, mask, label)
    if sorted(seen) != ["last_frame", "stereo"]:
        raise AssertionError(f"the microloop step reached hamming_best2 at {sorted(seen)}")
    return {"extra": extra, "launches": best2, "matrix_launches": matrix, "step": out,
            "max_err": max_err, "times": times}


def check_frontend_microloop_cpu(card):
    """Phase 26's CPU half: the same step on the CPU; the card's pose within
    FRONTEND_POSE_TOL (m, rad) and its match and inlier counts within
    FRONTEND_COUNT_RATE."""
    import math

    import bench_torch
    from orb_slam2_2021_tpu_torch.config import kitti_stereo_config

    step, inputs = bench_torch.frontend_step(kitti_stereo_config(), "cpu")
    R, t, _, _, n_in, n_m = step(*inputs)
    Rg, tg, _, _, n_in_g, n_m_g = card["step"]
    dt = float((tg - t).abs().max())
    cos = (float(torch.trace(Rg.double().T @ R.double())) - 1.0) / 2.0
    dr = math.acos(max(-1.0, min(1.0, cos)))
    counts = [(int(n_m_g), int(n_m)), (int(n_in_g), int(n_in))]
    ok = all(abs(a - b) <= math.ceil(FRONTEND_COUNT_RATE * max(a, b)) for a, b in counts)
    log(f"phase 26 microloop step, card vs CPU: t {dt:.2e} m, R {dr:.2e} rad (bound {FRONTEND_POSE_TOL}); "
        f"(matched, inliers) card {counts[0][0]}, {counts[1][0]}, CPU {counts[0][1]}, {counts[1][1]} "
        f"(within {FRONTEND_COUNT_RATE:.0%})")
    if dt > FRONTEND_POSE_TOL or dr > FRONTEND_POSE_TOL or not ok:
        raise AssertionError(f"the microloop step on the card parts from the CPU's: t {dt}, R {dr}, "
                             f"counts {counts}")


def _vocab_kernels():
    from orb_slam2_2021_tpu_torch.ops import vocab_kernels as vk

    return vk


def _vocab_twin():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    import torch_train_vocab_l6 as l6

    return l6


def _vocab_counts():
    vk = _vocab_kernels()
    return {name: kern.launches for name, kern in zip(VOCAB_KERNELS, vk.KERNELS)}


def _zero_vocab_counts():
    for kern in _vocab_kernels().KERNELS:
        kern.reset_counts()


# adversarial inputs of the two redesigned vocabulary kernels, shared with
# tests/test_torch_vocab_card.py (the host models) and tests/test_torch_cuda.py
SEED_DRAW_CASES = ("random", "256_then_ones", "ties", "ties_over_chain", "pow2_sums", "zero_runs", "n1",
                   "zero_sum")
MAJORITY_SIZES = (0, 1, 31, 33, 128, 129, 300, 512, 513, 4096, 8192, 8193, 20000)  # small, one and several chunks


def seed_draw_case(name, rng):
    """d2 nodes (lists of int32 arrays in 0..256) that stress the seed draw's
    exact scan: random rows up to 10^5; a first row of 256 then ones (every
    binade from 2^-9 up); terms 0.45-0.7 of the sum so far (q in the binade
    just below c's: ties), alone and at the head of nodes just over the
    chain's 2,048 rows (the tiles' ties, among chain nodes); power-of-two
    sums (D / s on powers of two); long runs of zeros; single rows; zero
    sums."""
    if name == "random":
        return [rng.integers(0, 257, n).astype(np.int32) for n in (100_000, 9_000, 4_097, 2_049, 300)]
    if name == "256_then_ones":
        out = []
        for n in (2, 100, 5_000, 100_000):
            d2 = np.ones(n, np.int32)
            d2[0] = 256
            out.append(d2)
        return out
    if name in ("ties", "ties_over_chain"):
        out = []
        for i in range(40 if name == "ties" else 24):
            d2 = [int(rng.integers(1, 4))]
            while len(d2) < 24:
                d2.append(min(256, max(1, round(sum(d2) * rng.uniform(0.45, 0.7)))))
            tail = int(rng.integers(0, 200)) if name == "ties" or i % 3 == 2 else int(rng.integers(2_025, 4_200))
            out.append(np.array(d2 + list(rng.integers(0, 257, tail)), np.int32))
        return out
    if name == "pow2_sums":
        out = []
        for n in (64, 1_024, 8_192):
            d2 = rng.integers(0, 257, n).astype(np.int32)
            d2[-1] = 0
            need, i = (1 << int(np.ceil(np.log2(d2.sum())))) - int(d2.sum()), n - 1
            while need > 0:
                add = min(256 - int(d2[i]), need)
                d2[i] += add
                need -= add
                i -= 1
            out.append(d2)
        return out
    if name == "zero_runs":
        out = []
        for n in (5_000, 60_000):
            d2 = rng.integers(0, 257, n).astype(np.int32)
            d2[: n // 3] = 0
            d2[n // 2: n // 2 + n // 5] = 0
            out.append(d2)
        return out
    if name == "n1":
        return [np.array([7], np.int32), np.array([256], np.int32)]
    if name == "zero_sum":
        return [np.zeros(n, np.int32) for n in (1, 33, 5_000)]
    raise ValueError(name)


def seed_draw_uniforms(nodes, rng):
    """Per node, uniforms that land on the cdf's own values and beside them,
    besides numpy's stream, 0 and the largest below 1: a list of [G]
    float64 arrays."""
    g = len(nodes)
    out = [rng.random(g), np.zeros(g), np.full(g, np.nextafter(1.0, 0.0))]
    exact = np.zeros(g)
    for j, d2 in enumerate(nodes):
        s = d2.astype(np.int64).sum()
        if s:
            cdf = np.cumsum(d2.astype(np.float64) / s)
            exact[j] = (cdf / cdf[-1])[rng.integers(0, len(d2))]
    return out + [exact, np.nextafter(exact, 0.0), np.nextafter(exact, 2.0)]


def majority_case(rng, k, sizes=MAJORITY_SIZES):
    """(rows [R, 8] uint32, assign [R] int64, offsets [G + 1]): random rows
    with runs of repeats (even ties), cluster k - 1 empty, and about 1% of
    the rows in no cluster (-1, k, 99)."""
    rows = rng.integers(0, 2 ** 32, (int(sum(sizes)), 8), dtype=np.uint32)
    rows[5:400] = rows[4]
    assign = rng.integers(0, k, len(rows))
    if k > 1:
        assign[assign == k - 1] = 0
    out = rng.integers(0, len(rows), max(1, len(rows) // 100))
    assign[out] = rng.choice([-1, k, 99], len(out))
    return rows, assign, np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)


def counted_rows(rows, assign, offsets, k):
    """The plain majority's inputs with the rows in no cluster (outside
    0..k-1) left out: the kernels count them nowhere, the plain version takes
    clusters in 0..k-1 only."""
    keep = (assign >= 0) & (assign < k)
    node = torch.repeat_interleave(torch.arange(offsets.shape[0] - 1, device=rows.device),
                                   offsets[1:] - offsets[:-1], output_size=rows.shape[0])
    off = torch.zeros_like(offsets)
    off[1:] = torch.cumsum(torch.bincount(node[keep], minlength=offsets.shape[0] - 1), 0)
    return rows[keep].contiguous(), assign[keep].contiguous(), off


def vocab_bound(name, args):
    """The least time of one call on these inputs: each input read once,
    each output written once, over the memory rate; the assignment's
    2 * 256 bit operations per row and centre as int8 operations (as the
    Hamming bounds count them), the majority's 256 per row."""
    if name == "vocab_assign":
        rows, _, centers = args
        n, g, k = rows.shape[0], centers.shape[0], centers.shape[1]
        return _bound(n * (32 + 8 + 8 + 4) + g * k * 32, n * k * 512)
    if name == "vocab_majority":
        rows, _, offsets, k = args[:4]
        n, g = rows.shape[0], offsets.shape[0] - 1
        return _bound(n * (32 + 8) + (g + 1) * 8 + g * k * (32 + 4), n * 256)
    d2, offsets = args[:2]
    g = offsets.shape[0] - 1
    return _bound(d2.shape[0] * 4 + (g + 1) * 8 + g * 8 + g * (8 + 4), 0)


@contextlib.contextmanager
def _capture_vocab(stats, captured):
    """While open, each vocabulary wrapper's first inputs at each level of a
    training (`stats["level"]`) land in `captured` by (name, level); an
    assignment to one centre (a seeding step) is passed over for the first
    iteration's."""
    vk = _vocab_kernels()
    undo = {name: getattr(vk, name) for name in VOCAB_KERNELS}

    def capture(name):
        def call(*args):
            if name != "vocab_assign" or args[2].shape[1] > 1:
                captured.setdefault((name, stats.get("level")), args)
            return undo[name](*args)
        return call

    for name in VOCAB_KERNELS:
        setattr(vk, name, capture(name))
    try:
        yield
    finally:
        for name, fn in undo.items():
            setattr(vk, name, fn)


def _hold_vocab_levels(captured, levels, label, max_err, times):
    """Each kernel against its plain version at each of `levels` of the
    captured run; its error into max_err, its row into times."""
    for lvl in levels:
        for name in VOCAB_KERNELS:
            err, row = _hold_vocab(name, captured[(name, lvl)], f"level {lvl} of {label}")
            max_err[name] = max(max_err[name], err)
            times[name].append(row)


def _level_rows(levels):
    return [(r["nodes"], r["large"], r["passes"], r["resumes"], r["zero_sum_picks"], r["empty_picks"],
             round(r["seconds"], 3)) for r in levels]


def _hold_vocab(name, args, label):
    """One kernel against its plain version on the captured inputs, exactly,
    and against itself on a second run; its device time beside the plain
    version's and its bound. The seed draw's yardstick is torch.cumsum of a
    float64 p of the same length (numpy's order is not a parallel scan's:
    the port never calls it). Returns (max abs error, timing row)."""
    vk = _vocab_kernels()
    kernel, plain = getattr(vk, name), getattr(vk, name + "_plain")
    # the majority's plan and the seed draw's largest node are the kernels'
    plain_args = {"vocab_majority": args[:4], "vocab_seed_draw": args[:3]}.get(name, args)
    ref = plain(*plain_args)

    def held(what):
        got, again = kernel(*args), kernel(*args)
        torch.cuda.synchronize()
        err = 0
        for x, y, z in zip(got, ref, again):
            if x.dtype != y.dtype or x.shape != y.shape or not torch.equal(x, y):
                raise AssertionError(f"{what} disagrees with its plain version at {label}")
            if not torch.equal(x, z):
                raise AssertionError(f"{what} differs between two runs at {label}")
            if x.numel():
                err = max(err, int((x.long() - y.long()).abs().max()))
        return err

    def timed(fn):
        return min(device_ms(fn, iters=20), device_ms(fn, iters=20))

    err = held(name)
    ms = timed(lambda: kernel(*args))
    plain_ms = time_ms(lambda: plain(*plain_args), iters=2, warm=1)
    bound, by = vocab_bound(name, args)
    library_ms = None
    if name == "vocab_seed_draw":
        p = args[0].double() / max(1.0, float(args[0].sum()))
        library_ms = timed(lambda: torch.cumsum(p, 0))
    if name == "vocab_assign":  # rows, nodes, centres a node
        shape = [args[0].shape[0], args[2].shape[0], args[2].shape[1]]
    elif name == "vocab_majority":
        shape = [args[0].shape[0], args[2].shape[0] - 1, args[3]]
    else:
        shape = [args[0].shape[0], args[1].shape[0] - 1]
    more = f", torch.cumsum {library_ms:.4f} ms" if library_ms is not None else ""
    log(f"phase 27 {name} at {label} (rows, nodes[, k] {shape}): == plain (tolerance 0), repeatable; "
        f"{ms:.4f} ms (bound {bound:.4f} ms by {by}, {100 * bound / ms:.1f}%), plain {plain_ms:.3f} ms{more}")
    return err, {"at": label, "shape": shape, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                 "bound_by": by, "library_ms": library_ms}


def check_vocab_adversarial(dev, level0_seed):
    """The two redesigned kernels on the host models' adversarial inputs:
    every seed-draw case (tests/test_torch_vocab_card.py) in one call and
    (d)'s level-0 distances, with uniforms on and beside the cdf's own
    values; the majority at k = 1, 10, 16 over nodes that
    end inside a k-word, a group and a chunk, with empty clusters and rows in
    no cluster. Each equal to its plain version, twice. Returns how many
    calls were held."""
    vk = _vocab_kernels()
    rng = np.random.default_rng(VOCAB_FULL_SEED)
    held = 0

    def hold_seed(d2, offsets, us, what):
        nonlocal held
        for u in us:
            u = torch.from_numpy(np.ascontiguousarray(u, np.float64)).to(dev)
            got, again = vk.vocab_seed_draw(d2, offsets, u), vk.vocab_seed_draw(d2, offsets, u)
            torch.cuda.synchronize()
            ref = vk.vocab_seed_draw_plain(d2, offsets, u)
            if not all(torch.equal(x, y) and torch.equal(x, z) for x, y, z in zip(got, ref, again)):
                raise AssertionError(f"vocab_seed_draw disagrees with its plain version on {what}")
            held += 1

    for name in SEED_DRAW_CASES:
        nodes = seed_draw_case(name, rng)
        offsets = np.concatenate([[0], np.cumsum([len(x) for x in nodes])]).astype(np.int64)
        hold_seed(torch.from_numpy(np.concatenate(nodes)).to(dev), torch.from_numpy(offsets).to(dev),
                  seed_draw_uniforms(nodes, rng), name)
    d2, offsets = level0_seed[:2]
    hold_seed(d2, offsets, seed_draw_uniforms([d2.cpu().numpy()], rng), "(d) level 0")
    for k in (1, 10, 16):
        rows, assign, offsets = majority_case(rng, k)
        rows = torch.from_numpy(rows.view(np.int32)).to(dev)
        assign, offsets = torch.from_numpy(assign).to(dev), torch.from_numpy(offsets).to(dev)
        ref = vk.vocab_majority_plain(*counted_rows(rows, assign, offsets, k), k)
        got, again = vk.vocab_majority(rows, assign, offsets, k), vk.vocab_majority(rows, assign, offsets, k)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) and torch.equal(x, z) for x, y, z in zip(got, ref, again)):
            raise AssertionError(f"vocab_majority disagrees with its plain version at k={k}")
        held += 1
    return held


def check_vocab_card(dev):
    """Phase 27 on the card. (a) The first VOCAB_WORLDS worlds of the L6
    recipe through the twin's harvest; world 0's frames extracted again on
    the card, slot by slot, for the CPU half. (b) k=10, L=6 over that corpus
    on the card, the vocabulary kernels' launches counted, each kernel's
    first inputs at every level captured. (c) Each kernel held against its
    plain version at levels 0, 2 and 5 of (b) (the deepest level with all
    three where level 5 has no node of more than k rows), and timed;
    vocab_assign at level 0 against hamming_best2 under an all-open mask.
    (d) VOCAB_FULL random descriptors trained twice on the card: identical
    trees, seconds, launches, passes, peak memory; each kernel held against
    its plain version at the VOCAB_FULL_HELD levels of the second run.
    (e) The seed draw and the majority on adversarial inputs
    (check_vocab_adversarial). Returns what the CPU half and the kernels
    line need."""
    from orb_slam2_2021_tpu_torch.frontend.features import extract_orb_batched
    from orb_slam2_2021_tpu_torch.ops import hamming as H

    vk, l6 = _vocab_kernels(), _vocab_twin()
    cfg = l6.config()
    t0 = time.perf_counter()
    corpus, worlds = l6.harvest(1 << 62, dev, max_worlds=VOCAB_WORLDS,
                                workers=max(1, min(VOCAB_WORLDS, os.cpu_count() or 1)))
    harvest_s = time.perf_counter() - t0
    images = l6.world_images(cfg, 0)
    kp, _ = extract_orb_batched(torch.from_numpy(np.stack(images)).to(dev), cfg.orb)
    kp = [x.cpu() for x in (kp.xy, kp.octave, kp.valid, kp.desc)]
    again = [kp[3][b][kp[2][b]].numpy().view(np.uint32) for b in range(len(images))]
    if not all(np.array_equal(a, b) for a, b in zip(again, worlds[0])):
        raise AssertionError("world 0 extracted again on the card differs from its harvest")
    log(f"phase 27 (a) harvest of {len(worlds)} worlds of the L6 recipe ({cfg.width}x{cfg.height}, "
        f"{cfg.orb.n_features} features, {sum(len(w) for w in worlds)} frames): {len(corpus)} "
        f"descriptors in {harvest_s:.1f} s (rendering in worker processes, extraction on the card)")

    captured, stats = {}, {}
    _zero_vocab_counts()
    with _capture_vocab(stats, captured):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        voc = l6.train(corpus, dev, stats)
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t0
    launches = _vocab_counts()
    levels = stats["levels"]
    log(f"phase 27 (b) k=10 L=6 over {len(corpus)} descriptors on the card: {card_s:.2f} s; launches "
        f"{launches}; per level (nodes, nodes of more than k rows, RNG passes, resumes, zero-sum "
        f"picks, empty-cluster picks, s) {_level_rows(levels)}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"the vocabulary builder did not launch every kernel: {launches}")

    full_levels = [lvl for lvl in range(len(levels))
                   if all((name, lvl) in captured for name in VOCAB_KERNELS)]
    held = sorted({0, 2, max(lvl for lvl in full_levels if lvl <= 5)} & set(full_levels))
    max_err, times = dict.fromkeys(VOCAB_KERNELS, 0), {name: [] for name in VOCAB_KERNELS}
    _hold_vocab_levels(captured, held, "(b)", max_err, times)
    rows, group, centers = captured[("vocab_assign", 0)]
    idx, dist = vk.vocab_assign(rows, group, centers)
    mask = torch.ones((rows.shape[0], centers.shape[1]), dtype=torch.bool, device=dev)
    best_idx, best, _, _ = H.hamming_best2(rows, centers[0], mask)
    torch.cuda.synchronize()
    if not (torch.equal(idx, best_idx) and torch.equal(dist, best.int())):
        raise AssertionError("vocab_assign at level 0 disagrees with hamming_best2 under an open mask")
    log(f"phase 27 (c) levels {held} held; vocab_assign at level 0 ({rows.shape[0]} x {centers.shape[1]}) "
        f"== hamming_best2 under an all-open mask (indices and distances)")
    del captured, rows, group, centers, idx, dist, mask, best_idx, best

    words = np.random.default_rng(VOCAB_FULL_SEED).integers(0, 2 ** 32, (VOCAB_FULL, 8), dtype=np.uint32)
    runs, captured = [], {}
    for i in range(2):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        _zero_vocab_counts()
        st = {}
        # the second run keeps its kernels' inputs; the first gives the peak memory without them
        with _capture_vocab(st, captured) if i else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            tree = l6.train(words, dev, st)
            torch.cuda.synchronize()
        runs.append({"s": time.perf_counter() - t0, "launches": _vocab_counts(),
                     "peak_bytes": torch.cuda.max_memory_allocated(dev),
                     "passes": [r["passes"] for r in st["levels"]], "tree": tree,
                     "level_s": [round(r["seconds"], 3) for r in st["levels"]],
                     "picks": [(r["zero_sum_picks"], r["empty_picks"]) for r in st["levels"]]})
        log(f"phase 27 (d) k=10 L=6 over {VOCAB_FULL} random descriptors (default_rng"
            f"({VOCAB_FULL_SEED})) on the card{' (inputs kept)' if i else ''}: {runs[-1]['s']:.2f} s; "
            f"launches {runs[-1]['launches']}; peak device memory {runs[-1]['peak_bytes'] / 1e9:.2f} GB; "
            f"per level (nodes, large, passes, resumes, zero-sum, empty, s) {_level_rows(st['levels'])}")
    a, b = runs[0].pop("tree"), runs[1].pop("tree")
    if not (np.array_equal(a.node_desc, b.node_desc) and np.array_equal(a.word_idf, b.word_idf)):
        raise AssertionError("two full-size trainings on the card gave different trees")
    log("phase 27 (d) the two full-size trees are identical")
    _hold_vocab_levels(captured, VOCAB_FULL_HELD, "(d)", max_err, times)
    t0 = time.perf_counter()
    n_held = check_vocab_adversarial(dev, captured[("vocab_seed_draw", 0)])
    log(f"phase 27 (e) {n_held} calls on the adversarial inputs (seed draw: {', '.join(SEED_DRAW_CASES)}, "
        f"(d) level 0; majority: k = 1, 10, 16) == plain (tolerance 0), repeatable; "
        f"{time.perf_counter() - t0:.1f} s")
    del captured
    return {"corpus": corpus, "images": images, "kp": kp, "voc": voc, "levels": levels,
            "card_s": card_s, "launches": launches, "max_err": max_err, "times": times,
            "full": runs}


def check_vocab_cpu(card):
    """Phase 27's CPU half: world 0's frames through the CPU extraction
    (identical keypoint slots, at least VOCAB_DESC_RATE of descriptors
    identical), and (b)'s training through the CPU path: the card's tree,
    bit for bit, with the same RNG passes per level."""
    from orb_slam2_2021_tpu_torch.frontend.features import extract_orb_batched

    l6 = _vocab_twin()
    cfg = l6.config()
    kp, _ = extract_orb_batched(torch.from_numpy(np.stack(card["images"])), cfg.orb)
    xy, octave, valid, desc = card["kp"]
    slots = torch.equal(valid, kp.valid) and torch.equal(octave, kp.octave) and torch.equal(xy, kp.xy)
    same = (desc == kp.desc).all(dim=-1)[valid]
    rate = float(same.float().mean()) if same.numel() else 1.0
    log(f"phase 27 (a) world 0's {len(card['images'])} frames, card vs CPU extraction: keypoint slots "
        f"identical {slots}, descriptors identical {rate:.4%} of {same.numel()} (bound {VOCAB_DESC_RATE:.1%})")
    if not slots or rate < VOCAB_DESC_RATE:
        raise AssertionError(f"world 0's extraction on the card parts from the CPU's: slots {slots}, "
                             f"descriptors {rate}")
    stats = {}
    t0 = time.perf_counter()
    voc = l6.train(card["corpus"], "cpu", stats)
    cpu_s = time.perf_counter() - t0
    same_tree = (np.array_equal(voc.node_desc, card["voc"].node_desc)
                 and np.array_equal(voc.word_idf, card["voc"].word_idf))
    passes = ([r["passes"] for r in card["levels"]], [r["passes"] for r in stats["levels"]])
    log(f"phase 27 (b) the CPU path over the same {len(card['corpus'])} descriptors: {cpu_s:.2f} s "
        f"(card {card['card_s']:.2f} s); trees identical {same_tree}; RNG passes per level card "
        f"{passes[0]}, CPU {passes[1]}")
    if not same_tree or passes[0] != passes[1]:
        raise AssertionError("the card's vocabulary differs from the CPU path's")


def _best2_by_thread():
    from orb_slam2_2021_tpu_torch.ops.hamming import HAMMING_BEST2_KERNEL

    return HAMMING_BEST2_KERNEL.launches_by_thread


def main():
    import tempfile

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        run(work)


def run(work):
    """Every phase, in the order the module's docstring gives; `work` holds
    the files phases hand on (phase 11's map, the outputs of phases 23 and
    24)."""
    sys.path.insert(0, REPO)
    torch.set_num_threads(max(1, min(8, os.cpu_count() or 1)))
    dev = torch.device("cuda:0")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, python {sys.version.split()[0]}")
    info = card_info()
    log(info)
    frames, gt = render_orbit()  # forks: before the first CUDA call
    tum_frames, tum_gt = render_tum()
    close_frames, close_gt = render_close()

    from orb_slam2_2021_tpu_torch.ops.cuda_build import build_all
    from orb_slam2_2021_tpu_torch.ops.hamming import HAMMING_BEST2_KERNEL, HAMMING_KERNEL
    from orb_slam2_2021_tpu_torch.ops.vocab_kernels import KERNELS as VOCAB_KERNEL_OBJECTS

    t0 = time.perf_counter()
    build_all([HAMMING_KERNEL, HAMMING_BEST2_KERNEL, *VOCAB_KERNEL_OBJECTS])
    log(f"built {HAMMING_KERNEL.source} and {VOCAB_KERNEL_OBJECTS[0].source} in "
        f"{time.perf_counter() - t0:.2f} s")

    max_err, times = check_hamming(dev)
    lane = drive_kitti(dev)
    err, mapping_times = check_hamming_mapping_shapes(dev)
    max_err = max(max_err, err)
    times.update(mapping_times)
    mapping = drive_kitti_mapping(dev, frames, gt, publish=True,
                                  viz_dir=os.path.join(work, "viz_mapping"))
    unit_ms = check_loop_numerics(dev)
    map_path = os.path.join(work, "orbit_map.npz")
    loop = drive_kitti_default(dev, frames, gt, map_path)
    err, loop_times = check_hamming_loop_shapes(dev, loop["shapes"])
    max_err = max(max_err, err)
    times.update(loop_times)

    sensor_shapes = set()
    rgbd_sys, rgbd = drive_tum_rgbd(dev, tum_frames, tum_gt, sensor_shapes)
    loc = drive_localization(dev, rgbd_sys, tum_frames, tum_gt, rgbd)
    del rgbd_sys
    mono = drive_tum_mono(dev, tum_frames, tum_gt, sensor_shapes)
    unit_ms["two_view_init_256x2000"] = check_two_view(dev)
    err, sensor_times = check_hamming_sensor_shapes(dev, sensor_shapes, loop["shapes"])
    max_err = max(max_err, err)
    times.update(sensor_times)
    bench = drive_async_bench(dev, frames, gt, loop["ms"])
    close = drive_tum_close(dev, close_frames, close_gt)
    async_sensors = drive_async_sensors(dev, close_frames, tum_frames, os.path.join(work, "viz_async"))
    dense_unit = check_dense_ba_unit(dev, mapping.pop("system"))
    dense = drive_kitti_mapping(dev, frames, gt, dense=True)
    dense.pop("system")
    log(f"phase 20 dense local BA ms per solve {[round(x, 2) for x in dense['ba_ms']]} beside phase 8's "
        f"CG solves {[round(x, 2) for x in mapping['ba_ms']]}; phase 19 unit: {dense_unit}")
    scale = check_dist_gba(dev)
    corridor = scale.pop("points")
    log(f"phase 21: {scale}")
    # phase 23 on the card (its pub/sub ran on the drives of phases 8 and 17)
    t23 = time.perf_counter()
    rectify = check_rectify(dev, frames[0], work)
    mproc = check_map_processor(dev, map_path, os.path.join(work, "map_card"))
    sor = check_sor(dev, corridor)
    log(f"phase 23 on the card: {time.perf_counter() - t23:.1f} s")
    t24 = time.perf_counter()
    calib = check_calibration(dev, work)
    log(f"phase 24 on the card: {time.perf_counter() - t24:.1f} s")
    t25 = time.perf_counter()
    twin = check_scale_twin(dev)
    log(f"phase 25: {time.perf_counter() - t25:.1f} s")
    t26 = time.perf_counter()
    frontend = check_frontend_microloop(dev)
    max_err = max(max_err, frontend["max_err"])
    times.update(frontend["times"])
    log(f"phase 26 on the card: {time.perf_counter() - t26:.1f} s")
    t27 = time.perf_counter()
    vocab = check_vocab_card(dev)
    log(f"phase 27 on the card: {time.perf_counter() - t27:.1f} s")
    # phase 22's two ranks run in processes of their own while this one
    # holds the CUDA drives of phases 4, 7, 10 and 14 against the CPU path,
    # which report no times, on half of the CPU threads
    started = start_dist_live(frames, gt)
    threads = torch.get_num_threads()
    torch.set_num_threads(max(1, threads // 2))
    try:
        check_small_against_cpu(dev)
        check_mapping_small_against_cpu(dev)
        check_reloc_small_against_cpu(dev)
        check_sensors_small_against_cpu(dev)
        t23 = time.perf_counter()
        check_map_processor_cpu(mproc, map_path, os.path.join(work, "map_cpu"))
        check_sor_cpu(sor)
        log(f"phase 23, the CPU halves: {time.perf_counter() - t23:.1f} s")
        t24 = time.perf_counter()
        check_calibration_cpu(calib)
        log(f"phase 24, the CPU half: {time.perf_counter() - t24:.1f} s")
        t26 = time.perf_counter()
        check_frontend_microloop_cpu(frontend)
        log(f"phase 26, the CPU half: {time.perf_counter() - t26:.1f} s")
        t27 = time.perf_counter()
        check_vocab_cpu(vocab)
        log(f"phase 27, the CPU half: {time.perf_counter() - t27:.1f} s")
        live = finish_dist_live(started, loop["ms"])
    finally:
        stop_dist_live(started)
        torch.set_num_threads(threads)
    profile_async_stretch(dev, frames)

    log(f"plain PyTorch loop-closing units on the card (ms): {json.dumps(unit_ms)}")
    print(f"card: {info}", flush=True)
    common = {"route": "cuda", "source": "orb_slam2_2021_tpu_torch/csrc/hamming.cu",
              "replaces": "orb_slam2_2021_tpu/ops/hamming_pallas.py:37", "max_abs_err": max_err}
    kernels = []
    for name, launches in (("hamming_best2", {
            "launches": loop["launches"],
            "launches_mapping_units": loop["mapping_launches"],
            "launches_loop_closing": loop["loop_launches"],
            "launches_mapping_drive": mapping["launches"],
            "launches_lane_drive": lane["launches"],
            "launches_rgbd_drive": rgbd["launches"],
            "launches_localization": loc["launches"],
            "launches_mono_drive": mono["launches"],
            "launches_async_bench_by_thread": bench["launches_by_thread"],
            "launches_close_rgbd_drive": close["launches"],
            "launches_async_rgbd_drive": async_sensors["rgbd"]["launches"],
            "launches_async_mono_drive": async_sensors["mono"]["launches"],
            "launches_dense_mapping_drive": dense["launches"],
            "launches_dist_live_drive": live["launches"],
            "launches_frontend_microloop": frontend["launches"]}),
            ("hamming_matrix", {  # no main-path caller is left: each drive asserts 0
                "launches": loop["matrix_launches"],
                "launches_mapping_drive": mapping["matrix_launches"],
                "launches_lane_drive": lane["matrix_launches"],
                "launches_rgbd_drive": rgbd["matrix_launches"],
                "launches_localization": loc["matrix_launches"],
                "launches_mono_drive": mono["matrix_launches"],
                "launches_async_bench_drive": bench["matrix_launches"],
                "launches_close_rgbd_drive": close["matrix_launches"],
                "launches_async_rgbd_drive": async_sensors["rgbd"]["matrix_launches"],
                "launches_async_mono_drive": async_sensors["mono"]["matrix_launches"],
                "launches_dense_mapping_drive": dense["matrix_launches"],
                "launches_dist_live_drive": live["matrix_launches"],
                "launches_frontend_microloop": frontend["matrix_launches"],
                "launches_scale_twin": twin["matrix_launches"]})):
        head = times["lane"][name]  # the local-point search's shape, 4096 x 2000
        kernels.append({"name": name, **common, **launches,
                        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                        "shape": head["shape"],
                        "shapes": [{"at": where, **row[name]} for where, row in times.items()]})
    for name in VOCAB_KERNELS:
        head = vocab["times"][name][0]  # level 0 of (b): the whole corpus in one node
        kernels.append({"name": name, "route": "cuda",
                        "source": "orb_slam2_2021_tpu_torch/csrc/vocab.cu",
                        "replaces": VOCAB_REPLACES[name], "launches": vocab["launches"][name],
                        "launches_full_size": [run["launches"][name] for run in vocab["full"]],
                        "max_abs_err": vocab["max_err"][name],
                        **{k: head[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                        "shape": head["shape"], "shapes": vocab["times"][name]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
