"""The settings the reference computes with, read without the program.

`Settings` holds what the plain frame build needs: the camera and ORB
values of an upstream ORB-SLAM2 settings file (read by `read_opencv_yaml`,
a plain parser of its `Key: value` lines) and the extractor's and stereo
matcher's fixed constants, which upstream keeps in code (ORBextractor.cc,
Frame.cc) and not in the settings file.
"""

from __future__ import annotations

import re
from types import SimpleNamespace

# upstream ORBextractor.cc / Frame.cc constants, as the frame build uses them
ORB_CONSTANTS = dict(cell_size=32, patch_size=31, half_patch=15, edge_threshold=19)
STEREO_CONSTANTS = dict(min_disparity=0.0, sad_window=5, search_range=5, median_gate=2.1,
                        row_slack_levels=2.0)


def read_opencv_yaml(path: str) -> dict:
    """Flat `Key: value` scalars of an OpenCV FileStorage settings file
    (numbers as int or float, anything else as a string)."""
    out = {}
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            m = re.match(r"^([\w.]+):\s*(\S.*)$", line)
            if not m or line.startswith("%"):
                continue
            key, val = m.group(1), m.group(2).strip()
            try:
                out[key] = float(val) if any(c in val for c in ".eE") else int(val)
            except ValueError:
                out[key] = val.strip("'\"")
    return out


def settings_from_yaml(path: str) -> SimpleNamespace:
    """The reference's view of a settings file: camera, lens, depth factor
    and ORB values, plus the fixed constants."""
    s = read_opencv_yaml(path)
    orb = SimpleNamespace(
        n_features=int(s["ORBextractor.nFeatures"]), scale_factor=float(s["ORBextractor.scaleFactor"]),
        n_levels=int(s["ORBextractor.nLevels"]), ini_fast_th=int(s["ORBextractor.iniThFAST"]),
        min_fast_th=int(s["ORBextractor.minThFAST"]), **ORB_CONSTANTS)
    factor = float(s.get("DepthMapFactor", 1.0))
    return SimpleNamespace(
        fx=float(s["Camera.fx"]), fy=float(s["Camera.fy"]), cx=float(s["Camera.cx"]),
        cy=float(s["Camera.cy"]), bf=float(s["Camera.bf"]), fps=float(s["Camera.fps"]),
        width=int(s["Camera.width"]), height=int(s["Camera.height"]),
        dist_coef=tuple(float(s.get(f"Camera.{k}", 0.0)) for k in ("k1", "k2", "p1", "p2", "k3")),
        depth_map_factor=factor,
        depth_scale=1.0 if abs(factor) < 1e-5 or factor == 1.0 else 1.0 / factor,
        orb=orb, stereo=SimpleNamespace(**STEREO_CONSTANTS))
