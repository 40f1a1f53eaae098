"""Carry the reference's per-frame state into the port.

The slice has no learned weights: its state is what a frame or a tracking
step carries. These helpers turn the JAX package's arrays (anything
`np.asarray` accepts, so this module imports no JAX) into the port's tensors
on a given device. Descriptors travel as int32 tensors holding the same 32
bits as the reference's uint32 words.
"""

from __future__ import annotations

import numpy as np
import torch

from .frontend.features import Keypoints
from .frontend.frame import Frame
from .geometry.camera import PinholeCamera


def tensor(a, device, dtype=None) -> torch.Tensor:
    """numpy-convertible array -> tensor on `device` (dtype kept unless given)."""
    return torch.from_numpy(_host(a)).to(device=device, dtype=dtype)


def _host(a, dtype=None) -> np.ndarray:
    """A contiguous, writable numpy copy torch can wrap (jax arrays convert
    to read-only views)."""
    a = np.ascontiguousarray(np.asarray(a, dtype=dtype))
    return a if a.flags.writeable else a.copy()


def desc_from_numpy(desc, device) -> torch.Tensor:
    """[..., 8] uint32 descriptor words -> int32 tensor with the same bits."""
    return torch.from_numpy(_host(desc, np.uint32).view(np.int32)).to(device)


def desc_to_numpy(desc) -> np.ndarray:
    """int32 descriptor tensor or array -> [..., 8] uint32 words."""
    if isinstance(desc, torch.Tensor):
        desc = desc.cpu().numpy()
    return np.ascontiguousarray(np.asarray(desc, dtype=np.int32)).view(np.uint32)


def keypoints_from_reference(kp, device) -> Keypoints:
    """The reference's Keypoints (features.py) -> the port's Keypoints."""
    return Keypoints(
        xy=tensor(kp.xy, device, torch.float32),
        response=tensor(kp.response, device, torch.float32),
        octave=tensor(kp.octave, device, torch.int32),
        angle=tensor(kp.angle, device, torch.float32),
        desc=desc_from_numpy(kp.desc, device),
        valid=tensor(kp.valid, device, torch.bool),
    )


def frame_from_reference(frame, device) -> Frame:
    """The reference's Frame (frame.py) -> the port's Frame."""
    return Frame(
        kp=keypoints_from_reference(frame.kp, device),
        u_right=tensor(frame.u_right, device, torch.float32),
        depth=tensor(frame.depth, device, torch.float32),
        sad_dist=tensor(frame.sad_dist, device, torch.float32),
    )


def camera_from_config(cfg) -> PinholeCamera:
    """A SlamConfig's intrinsics as the port's camera (float32-rounded)."""
    return PinholeCamera.create(cfg.fx, cfg.fy, cfg.cx, cfg.cy, cfg.bf, cfg.width, cfg.height)


def track_inputs_from_reference(last_geom, last_slot, pose_pack,
                                snap_geom, snap_desc, snap_valid, device):
    """The host-packed inputs of `fused_track_step` (last-frame geometry and
    snapshot slots, the pose pack, the local-map snapshot) as tensors."""
    return (
        tensor(last_geom, device, torch.float32),
        tensor(last_slot, device, torch.int32),
        tensor(pose_pack, device, torch.float32),
        tensor(snap_geom, device, torch.float32),
        desc_from_numpy(snap_desc, device),
        tensor(snap_valid, device, torch.bool),
    )
