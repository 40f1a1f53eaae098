"""The port's own copy of orb_slam2_2021_tpu/config.py: plain Python and
numpy, the same behaviour.

One typed configuration for the whole engine.

The reference scatters settings across OpenCV YAML parses and hard-coded
literals (Tracking.cc:60-153, ORBmatcher.cc:37-39, KeyFrame covisibility
th=15, LoopClosing consistency th=3, GridMapping.cpp:77-98 ...). Here every
threshold lives in one frozen dataclass tree with the reference values as
defaults; static capacities (feature counts, local-window sizes) are part of
the config because they fix the jit shapes.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class OrbConfig:
    """ORB extraction (reference: ORBextractor.cc, arducam.yaml ORBextractor.*)."""
    n_features: int = 2000          # ORBextractor.nFeatures
    scale_factor: float = 1.2       # ORBextractor.scaleFactor
    n_levels: int = 8               # ORBextractor.nLevels
    ini_fast_th: int = 12           # ORBextractor.iniThFAST (arducam.yaml uses 12)
    min_fast_th: int = 7            # ORBextractor.minThFAST
    cell_size: int = 32             # FAST evaluated per cell (ref uses 30px cells,
                                    # ORBextractor.cc:789; 32 keeps tiles aligned)
    patch_size: int = 31            # ORBextractor.cc:71
    half_patch: int = 15            # ORBextractor.cc:72
    edge_threshold: int = 19        # ORBextractor.cc:73
    desc_bytes: int = 32            # 256-bit descriptors packed as uint8[32]


@dataclass(frozen=True)
class MatcherConfig:
    """Descriptor matching (reference: ORBmatcher.cc:37-39, 1627-1668)."""
    th_low: int = 50
    th_high: int = 100
    nn_ratio_track: float = 0.9     # TrackWithMotionModel / local map search
    nn_ratio_bow: float = 0.75      # SearchByBoW (Tracking.cc:787)
    histo_bins: int = 30            # rotation-consistency histogram
    histo_keep: int = 3             # keep top-3 bins
    check_orientation: bool = True


@dataclass(frozen=True)
class StereoConfig:
    """Stereo matching (reference: Frame.cc:522-700)."""
    min_disparity: float = 0.0
    sad_window: int = 5             # w=5 SAD block half-size (Frame.cc:607)
    search_range: int = 5           # +-L subpixel search (Frame.cc:622)
    median_gate: float = 2.1        # 1.5*1.4*median outlier cut (Frame.cc:686-699)
    row_slack_levels: float = 2.0   # r = 2*scale row tolerance (Frame.cc:536)


@dataclass(frozen=True)
class TrackingConfig:
    """Front-end (reference: Tracking.cc)."""
    th_depth_factor: float = 20.0   # ThDepth: close/far split = bf/fx * factor (arducam.yaml ThDepth=20)
    min_frames_between_kf: int = 0
    max_frames_between_kf: int = 10  # = fps in the reference (Tracking.cc:132)
    local_window_kf: int = 80       # local-map KF cap (Tracking.cc:1310-1312)
    min_inliers_track: int = 10     # TrackWithMotionModel acceptance (Tracking.cc:946)
    min_inliers_localmap: int = 30  # TrackLocalMap acceptance (Tracking.cc:988)
    min_inliers_localmap_recent: int = 50  # within 1s of reloc (Tracking.cc:984)
    motion_search_radius: float = 7.0      # th=7 stereo SearchByProjection (Tracking.cc:905); widened 2x on retry (Tracking.cc:914)
    reloc_search_radius: float = 10.0
    local_points_cap: int = 4096           # static local-map snapshot size


@dataclass(frozen=True)
class MappingConfig:
    """Local mapping (reference: LocalMapping.cc)."""
    cull_found_ratio: float = 0.25        # MapPointCulling (LocalMapping.cc:188)
    cull_min_obs: int = 3                 # nObs threshold for stereo (cnThObs)
    triangulation_neighbors: int = 10     # CreateNewMapPoints nn=10 stereo (LocalMapping.cc:219)
    triangulation_neighbors_mono: int = 20
    kf_cull_redundancy: float = 0.9       # KeyFrameCulling 90% (LocalMapping.cc:699)
    kf_cull_min_obs: int = 3


@dataclass(frozen=True)
class OptimConfig:
    """Bundle adjustment / pose optimization (reference: Optimizer.cc)."""
    chi2_mono: float = 5.991        # Huber delta^2 (Optimizer.cc:87)
    chi2_stereo: float = 7.815      # Optimizer.cc:88
    pose_rounds: int = 4            # PoseOptimization: 4 rounds x 10 its (Optimizer.cc:368)
    pose_iters: int = 10
    local_ba_iters1: int = 5        # LocalBundleAdjustment 5 + 10 (Optimizer.cc:662-712)
    local_ba_iters2: int = 10
    global_ba_iters: int = 10       # RunGlobalBundleAdjustment (LoopClosing.cc:54)
    global_ba_obs_per_point: int = 16  # Q cap for the PQ/RCS global-BA path
    #   (observations beyond this per point are dropped from GBA only; the
    #   reference uses all edges, Optimizer.cc:51-240 — divergence documented
    #   in loop_closing._run_global_ba)
    essential_iters: int = 20       # OptimizeEssentialGraph (Optimizer.cc:992)
    sim3_iters: int = 5             # OptimizeSim3 rounds (Optimizer.cc:1202: 5 then 10)
    lm_lambda_init: float = 1e-4    # g2o computes from diag; fixed init works with our scaling
    # static capacities for the jitted local-BA problem
    local_ba_max_cams: int = 64
    local_ba_max_fixed: int = 64
    local_ba_max_points: int = 4096
    local_ba_max_obs_per_point: int = 8   # Q cap: bounds PQ padding AND jit-bucket variety (each (P,Q) bucket costs ~10s XLA compile); observations beyond 8 per point are dropped from local BA only
    local_ba_max_obs: int = 32768
    # matrix-free Schur PCG (optim/ba_cg.py): inner CG iterations per LM step
    cg_iters: int = 24
    # CG-based local BA (no [P,Q,Q,6,6] Schur pair tensor, no per-point obs
    # cap); the dense reduced-system path remains for comparison
    use_cg_local_ba: bool = True


@dataclass(frozen=True)
class PlaceConfig:
    """Place recognition (reference: KeyFrameDatabase.cc, LoopClosing.cc)."""
    vocab_branching: int = 10       # k (DBoW2 default vocab k=10)
    vocab_levels: int = 4           # L (ORBvoc uses 6; 10^4 words suffices for our scale)
    covis_consistency_th: int = 3   # LoopClosing.cc:54
    loop_min_kf_gap: int = 10       # DetectLoop gate (LoopClosing.cc:123)
    common_words_frac: float = 0.8  # prefilter (KeyFrameDatabase.cc:126)
    score_frac: float = 0.75        # accumulated-score cut (KeyFrameDatabase.cc:162)
    sim3_min_inliers: int = 20      # OptimizeSim3 acceptance (LoopClosing.cc:389)
    loop_min_matches: int = 40      # final acceptance (LoopClosing.cc:411)
    essential_min_weight: int = 100 # covisibility edges in essential graph (Optimizer.cc:809)


@dataclass(frozen=True)
class GridMapConfig:
    """Occupancy grid (reference: GridMapping.cpp:72-107)."""
    size_x: int = 1024              # ref uses 6000x6300 @ scale 3; we default smaller
    size_z: int = 1024
    scale: float = 3.0              # cells per meter
    visit_th: float = 0.0
    free_th: float = 0.7
    occ_th: float = 0.5
    max_points_per_kf: int = 2048


@dataclass(frozen=True)
class CovisConfig:
    """Covisibility graph (reference: KeyFrame.cc:304-395)."""
    weight_th: int = 15             # min shared MPs for an edge
    max_covis_kf: int = 64          # static cap for per-KF neighbor lists


@dataclass(frozen=True)
class SlamConfig:
    """Top-level engine configuration."""
    # camera (arducam.yaml Camera.*); set per dataset
    fx: float = 718.856
    fy: float = 718.856
    cx: float = 607.1928
    cy: float = 185.2157
    bf: float = 386.1448            # baseline*fx (KITTI ~0.537m * fx)
    fps: float = 10.0
    width: int = 1241
    height: int = 376
    depth_th: float = 0.0           # computed: bf/fx * th_depth_factor if 0
    # radial-tangential distortion (k1, k2, p1, p2, k3), Camera.k1.. in the
    # settings YAML (Tracking.cc:75-93). Non-zero => keypoint coordinates are
    # undistorted at frame build (Frame.cc:456-486). Stereo input is assumed
    # rectified (the reference rectifies images before Frame, so stereo
    # frames always see zero coefficients, Frame.cc:235).
    dist_coef: Tuple[float, float, float, float, float] = (0.0, 0.0, 0.0, 0.0, 0.0)
    # RGB-D depth map scale divisor (DepthMapFactor, Tracking.cc:147-153)
    depth_map_factor: float = 1.0

    orb: OrbConfig = field(default_factory=OrbConfig)
    matcher: MatcherConfig = field(default_factory=MatcherConfig)
    stereo: StereoConfig = field(default_factory=StereoConfig)
    tracking: TrackingConfig = field(default_factory=TrackingConfig)
    mapping: MappingConfig = field(default_factory=MappingConfig)
    optim: OptimConfig = field(default_factory=OptimConfig)
    place: PlaceConfig = field(default_factory=PlaceConfig)
    gridmap: GridMapConfig = field(default_factory=GridMapConfig)
    covis: CovisConfig = field(default_factory=CovisConfig)

    # map store capacities (grow-by-doubling on host; static per jit trace)
    max_keyframes: int = 2048
    max_map_points: int = 1 << 17

    def resolved_depth_th(self) -> float:
        if self.depth_th > 0:
            return self.depth_th
        return self.bf / self.fx * self.tracking.th_depth_factor

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)


def _parse_opencv_yaml(path: str):
    """Tolerant parser for the reference's OpenCV-FileStorage YAML
    (Examples/Stereo/arducam.yaml): flat `A.b: value` scalars plus
    `!!opencv-matrix` blocks (rows/cols/dt/data). Returns (scalars: dict,
    matrices: dict of numpy arrays)."""
    import re

    import numpy as np

    scalars, matrices = {}, {}
    text = open(path).read()
    # matrix blocks
    mat_re = re.compile(
        r"^(\S+):\s*!!opencv-matrix\s*\n\s*rows:\s*(\d+)\s*\n\s*cols:\s*(\d+)"
        r"\s*\n\s*dt:\s*\S+\s*\n\s*data:\s*\[([^\]]*)\]",
        re.MULTILINE,
    )
    for m in mat_re.finditer(text):
        name, rows, cols, data = m.group(1), int(m.group(2)), int(m.group(3)), m.group(4)
        vals = np.asarray([float(v) for v in data.replace("\n", " ").split(",") if v.strip()])
        matrices[name] = vals.reshape(rows, cols)
    # scalar lines
    for line in text.splitlines():
        line = line.split("#")[0].strip()
        if not line or line.startswith("%") or "!!opencv-matrix" in line:
            continue
        m = re.match(r"^([\w.]+):\s*(.+)$", line)
        if not m or m.group(1) in matrices:
            continue
        key, val = m.group(1), m.group(2).strip()
        if key in ("rows", "cols", "dt", "data") or val.startswith("["):
            continue
        try:
            scalars[key] = float(val) if "." in val or "e" in val.lower() else int(val)
        except ValueError:
            scalars[key] = val.strip("'\"")
    return scalars, matrices


def config_from_yaml(path: str, **overrides) -> SlamConfig:
    """Build a SlamConfig from a reference-format settings YAML.

    Consumes the same keys the reference parses in the Tracking ctor
    (Tracking.cc:60-153) and ORB block (arducam.yaml ORBextractor.*).
    Rectification blocks (LEFT./RIGHT. K, D, R, P) are available through
    io.rectify.rectification_from_yaml.
    """
    s, _ = _parse_opencv_yaml(path)
    orb = OrbConfig(
        n_features=int(s.get("ORBextractor.nFeatures", 2000)),
        scale_factor=float(s.get("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(s.get("ORBextractor.nLevels", 8)),
        ini_fast_th=int(s.get("ORBextractor.iniThFAST", 12)),
        min_fast_th=int(s.get("ORBextractor.minThFAST", 7)),
    )
    fps = float(s.get("Camera.fps", 10.0))
    cfg = SlamConfig(
        fx=float(s.get("Camera.fx", 718.856)),
        fy=float(s.get("Camera.fy", 718.856)),
        cx=float(s.get("Camera.cx", 607.1928)),
        cy=float(s.get("Camera.cy", 185.2157)),
        bf=float(s.get("Camera.bf", 386.1448)),
        fps=fps,
        width=int(s.get("Camera.width", 1241)),
        height=int(s.get("Camera.height", 376)),
        dist_coef=(
            float(s.get("Camera.k1", 0.0)), float(s.get("Camera.k2", 0.0)),
            float(s.get("Camera.p1", 0.0)), float(s.get("Camera.p2", 0.0)),
            float(s.get("Camera.k3", 0.0)),
        ),
        depth_map_factor=float(s.get("DepthMapFactor", 1.0)),
        orb=orb,
        tracking=TrackingConfig(
            th_depth_factor=float(s.get("ThDepth", 20.0)),
            max_frames_between_kf=int(fps),
        ),
    )
    return cfg.replace(**overrides) if overrides else cfg


def tum_rgbd_config(preset: str = "freiburg1", **overrides) -> SlamConfig:
    """TUM RGB-D intrinsics (published freiburg camera calibrations, as used
    by the upstream ORB-SLAM2 TUM{1,2,3}.yaml settings). freiburg1/2 carry
    strong radial distortion — keypoints are undistorted at frame build;
    freiburg3 ships pre-undistorted imagery (zero coefficients)."""
    presets = {
        "freiburg1": dict(
            fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
            dist_coef=(0.262383, -0.953104, -0.005358, 0.002628, 1.163314),
            depth_map_factor=5000.0,
        ),
        "freiburg2": dict(
            fx=520.908620, fy=521.007327, cx=325.141442, cy=249.701764,
            dist_coef=(0.231222, -0.784899, -0.003257, -0.000105, 0.917205),
            depth_map_factor=5208.0,
        ),
        "freiburg3": dict(
            fx=535.4, fy=539.2, cx=320.1, cy=247.6,
            dist_coef=(0.0, 0.0, 0.0, 0.0, 0.0),
            depth_map_factor=5000.0,
        ),
    }
    p = presets[preset]
    cfg = SlamConfig(
        fx=p["fx"], fy=p["fy"], cx=p["cx"], cy=p["cy"],
        bf=40.0, fps=30.0, width=640, height=480,
        dist_coef=p["dist_coef"], depth_map_factor=p["depth_map_factor"],
        tracking=TrackingConfig(th_depth_factor=40.0, max_frames_between_kf=30),
    )
    return cfg.replace(**overrides) if overrides else cfg


def kitti_stereo_config(**overrides) -> SlamConfig:
    """KITTI 00-02 intrinsics (the reference's eval suite, scripts/*.sh)."""
    cfg = SlamConfig(
        fx=718.856, fy=718.856, cx=607.1928, cy=185.2157,
        bf=386.1448, fps=10.0, width=1241, height=376,
    )
    return cfg.replace(**overrides) if overrides else cfg


def synthetic_config(width=640, height=480, **overrides) -> SlamConfig:
    """Small config for synthetic-sequence tests (fast CPU jit).

    Wide FOV (~63 deg) — with a narrow FOV and a shallow depth range the
    yaw/lateral-translation mode is weakly observable and texture-correlated
    matching noise turns into trajectory drift (real datasets break this with
    depth diversity; the synthetic world does it with FOV + deep scenes).
    """
    fx = width * 0.8125
    cfg = SlamConfig(
        fx=fx, fy=fx, cx=width / 2.0, cy=height / 2.0,
        bf=fx * 0.2, fps=10.0, width=width, height=height,
        orb=OrbConfig(n_features=512, n_levels=4),
        # depth_th ~ 10 m: the world spans 4-28 m, so the close-point KF
        # trigger stays live as on KITTI (ThDepth=35*baseline ~ 19 m there)
        tracking=TrackingConfig(th_depth_factor=50.0),
        max_keyframes=256, max_map_points=1 << 14,
    )
    return cfg.replace(**overrides) if overrides else cfg
