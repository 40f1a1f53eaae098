"""Carry the reference's per-frame state into the port.

The engine has no learned weights: its state is what a frame, a tracking
step, a keyframe view or a BA problem carries. These helpers turn the JAX
package's arrays (anything `np.asarray` accepts, so this module imports no
JAX) into the port's tensors on a given device. Descriptors travel as int32
tensors holding the same 32 bits as the reference's uint32 words. `to_host`
brings several device results back in one copy. `config_from_reference` and
`map_store_from_reference` rebuild a reference config or map store as the
port's own types, reading the objects duck-typed.
"""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from . import config as port_config
from .frontend.features import Keypoints
from .frontend.frame import Frame
from .geometry.camera import PinholeCamera
from .mapping.map_store import MapStore
from .optim.assemble import upload_problem
from .optim.ba import BAProblem
from .optim.sim3_opt import PoseGraph
from .pipeline.mapping_steps import KFView
from .place.vocab import BinaryVocabulary
from .tools.calibration import MonoCalibration, StereoCalibration


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


def kfview_from_reference(view, device) -> KFView:
    """The reference's KFView (mapping_steps.py), single or stacked
    [T, ...], -> the port's KFView."""
    return KFView(
        xy=tensor(view.xy, device, torch.float32),
        ur=tensor(view.ur, device, torch.float32),
        depth=tensor(view.depth, device, torch.float32),
        octave=tensor(view.octave, device, torch.int32),
        desc=desc_from_numpy(view.desc, device),
        valid=tensor(view.valid, device, torch.bool),
        R=tensor(view.R, device, torch.float32),
        t=tensor(view.t, device, torch.float32),
    )


def ba_problem_from_reference(prob, device) -> BAProblem:
    """The reference's BAProblem (optim/ba.py) -> the port's, index fields
    as int64."""
    return upload_problem(BAProblem(*(_host(v) for v in prob)), device)


def to_host(*tensors):
    """Several device tensors -> numpy arrays in ONE device -> host copy
    (one sync): each is flattened to 32-bit words, concatenated, pulled,
    and split back into its own dtype and shape."""
    words = []
    for x in tensors:
        if x.dtype in (torch.float32, torch.int32):
            words.append(x.reshape(-1).view(torch.int32))
        else:  # bool, int16, int64 indices below 2^31
            words.append(x.reshape(-1).to(torch.int32))
    flat = torch.cat(words).cpu().numpy()
    out, i = [], 0
    for x in tensors:
        n = x.numel()
        w = flat[i:i + n]
        i += n
        if x.dtype == torch.float32:
            w = w.view(np.float32)
        elif x.dtype == torch.bool:
            w = w != 0
        out.append(w.reshape(tuple(x.shape)))
    return out


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


def pose_graph_from_reference(g, device) -> PoseGraph:
    """The reference's PoseGraph (optim/sim3_opt.py) -> the port's, edge
    indices as int64."""
    f32 = torch.float32
    return PoseGraph(
        s=tensor(g.s, device, f32), R=tensor(g.R, device, f32), t=tensor(g.t, device, f32),
        edge_i=tensor(g.edge_i, device, torch.int64), edge_j=tensor(g.edge_j, device, torch.int64),
        m_s=tensor(g.m_s, device, f32), m_R=tensor(g.m_R, device, f32),
        m_t=tensor(g.m_t, device, f32), weight=tensor(g.weight, device, f32),
        fixed=tensor(g.fixed, device, torch.bool),
    )


def vocab_tree_from_numpy(node_desc, device) -> torch.Tensor:
    """[n_nodes, 8] uint32 vocabulary tree -> int32 tensor with the same bits."""
    return desc_from_numpy(node_desc, device)


def samples_from_reference(idx, device) -> torch.Tensor:
    """RANSAC minimal sets drawn by the reference ([n_hyps, m] indices, from
    `jax.random.choice` under its keys) -> int64 index tensor."""
    return tensor(idx, device, torch.int64)


def config_from_reference(cfg) -> port_config.SlamConfig:
    """A reference SlamConfig (or any object with its fields) -> the port's
    SlamConfig, field by field; nested configs become the port's dataclass
    of the same name."""
    def rebuild(obj):
        cls = getattr(port_config, type(obj).__name__)
        return cls(**{f.name: rebuild(v) if dataclasses.is_dataclass(v) else v
                      for f in dataclasses.fields(cls)
                      for v in (getattr(obj, f.name),)})
    return rebuild(cfg)


def map_store_from_reference(store) -> MapStore:
    """A reference MapStore -> the port's, with copies of its arrays,
    counters and graph dictionaries (not its lock or callbacks)."""
    out = MapStore(config_from_reference(store.cfg))
    for name, value in vars(store).items():
        if name in ("cfg", "lock", "on_kf_erased"):
            continue
        setattr(out, name, value.copy() if isinstance(value, np.ndarray) else copy.deepcopy(value))
    return out


def vocabulary_from_reference(voc) -> BinaryVocabulary:
    """A reference BinaryVocabulary -> the port's, with copies of its tree
    and idf."""
    return BinaryVocabulary(int(voc.k), int(voc.L), _host(voc.node_desc, np.uint32),
                            _host(voc.word_idf, np.float32))


def calibration_from_reference(calib):
    """A reference MonoCalibration or StereoCalibration -> the port's, field
    by field (arrays copied; a stereo result's eyes converted too)."""
    def rebuild(cls, obj):
        return cls(**{f.name: (rebuild(MonoCalibration, v) if f.name in ("left", "right")
                               else v.copy() if isinstance(v, np.ndarray) else copy.deepcopy(v))
                      for f in dataclasses.fields(cls) for v in (getattr(obj, f.name),)})
    return rebuild(StereoCalibration if hasattr(calib, "left") else MonoCalibration, calib)
