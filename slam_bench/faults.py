"""Faults planted under the timed path, for the tests and `control.py` that
show the comparison catches them. The benchmark's own runs plant none.

Each is a `fault(kind, value)` that `tracing.Probes` calls: with kind
"frame" on every frame the build produced (it returns the frame the System
goes on with), and with kind "track" before each tracker call of the window
(True leaves the tracker's state unchanged: the call returns the last pose
and tracks nothing).
"""

from __future__ import annotations

import torch

DEPTH_FACTOR = 1.10   # `depth_scaled`: every stereo or RGB-D depth 10% too far (as a baseline 10% off would)


def unchanged(kind, value):
    """A step that returns its state unchanged: the tracker's pose."""
    return True if kind == "track" else value if kind == "frame" else False


def half(kind, value):
    """Half of the batch left out: the second half of each frame's features
    dropped, tracking and mapping going on with the rest."""
    if kind != "frame":
        return False
    valid = value.kp.valid.clone()
    valid[valid.shape[0] // 2:] = False
    return value._replace(kp=value.kp._replace(valid=valid))


def altered(kind, value):
    """An answer altered where it is produced: one bit of every descriptor."""
    if kind != "frame":
        return False
    desc = value.kp.desc.clone()
    desc[:, 0] ^= 1
    return value._replace(kp=value.kp._replace(desc=desc))


def depth_scaled(kind, value):
    """An answer altered where it is produced: each feature's depth, and the
    right-eye coordinate that goes with it, DEPTH_FACTOR too far."""
    if kind != "frame":
        return False
    ok = value.depth > 0
    x = value.kp.xy[:, 0]
    disparity = torch.where(ok, (x - value.u_right) / DEPTH_FACTOR, torch.zeros_like(x))
    return value._replace(depth=torch.where(ok, value.depth * DEPTH_FACTOR, value.depth),
                          u_right=torch.where(ok, x - disparity, value.u_right))


def half_size_yaml(src, dst, scale=0.5, n_features=1000):
    """An upstream settings file at `scale` of its resolution."""
    keys = {"Camera.fx", "Camera.fy", "Camera.cx", "Camera.cy", "Camera.bf"}
    out = []
    for line in open(src):
        key = line.split(":")[0].strip()
        if key in keys:
            line = f"{key}: {float(line.split(':')[1]) * scale!r}\n"
        elif key in ("Camera.width", "Camera.height"):
            line = f"{key}: {int(int(line.split(':')[1]) * scale)}\n"
        elif key == "ORBextractor.nFeatures":
            line = f"{key}: {n_features}\n"
        out.append(line)
    with open(dst, "w") as f:
        f.writelines(out)


FAULTS = {"unchanged": unchanged, "half": half, "altered": altered, "depth_scaled": depth_scaled}
