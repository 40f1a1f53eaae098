"""The port's own copy of orb_slam2_2021_tpu/io/persistence.py: plain Python and
numpy, the same behaviour.

Map checkpoint/restore.

Replaces the reference's Boost binary serialization of the pointer graph
(System::SaveMap/LoadMap, /root/reference/src/System.cc:550-596;
BoostArchiver.h; KeyFrame.cc:695-766; MapPoint.cc:456-488). Our map is
already flat arrays, so a checkpoint is one compressed npz of the live
prefixes plus small metadata. Like the reference, BoW vectors are NOT
stored: they are recomputed from descriptors against the loaded vocabulary
(System.cc:567-596 re-runs ComputeBoW per keyframe), and the tracker starts
LOST for relocalization against the loaded map (Tracking.cc:154-155).
"""

from __future__ import annotations

import json
from typing import Optional

import numpy as np

from ..config import SlamConfig
from ..mapping.map_store import MapStore, OBS_CAP


_KF_FIELDS = [
    "kf_valid", "kf_R", "kf_t", "kf_xy", "kf_ur", "kf_depth", "kf_octave",
    "kf_angle", "kf_desc", "kf_feat_valid", "kf_mp", "kf_frame_id",
    "kf_timestamp", "covis", "parent", "kf_not_erase", "kf_to_be_erased",
]
_MP_FIELDS = [
    "mp_valid", "mp_pos", "mp_desc", "mp_normal", "mp_min_dist", "mp_max_dist",
    "mp_n_obs", "mp_visible", "mp_found", "mp_first_kf", "mp_obs_kf",
    "mp_obs_feat", "mp_obs_n", "mp_replaced_by",
]


def save_map(path: str, m: MapStore, next_frame_id: int = 0):
    arrays = {}
    K, M = m.next_kf, m.next_mp
    for f in _KF_FIELDS:
        arrays[f] = getattr(m, f)[:K]
    # covis is [K_cap, K_cap]
    arrays["covis"] = m.covis[:K, :K]
    for f in _MP_FIELDS:
        arrays[f] = getattr(m, f)[:M]
    children = {str(k): sorted(v) for k, v in m.children.items() if v}
    # essential-graph loop constraints survive reload (the reference
    # serializes mspLoopEdges, KeyFrame.cc:695-766)
    loop_edges = {str(k): sorted(int(x) for x in v)
                  for k, v in m.loop_edges.items() if v}
    meta = {
        "next_kf": K,
        "next_mp": M,
        "n_kf": m.n_kf,
        "next_frame_id": int(next_frame_id),
        "children": children,
        "loop_edges": loop_edges,
        "big_change_idx": m.big_change_idx,
    }
    arrays["_meta"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def load_map(path: str, cfg: SlamConfig) -> tuple[MapStore, int]:
    """Returns (map_store, next_frame_id)."""
    z = np.load(path, allow_pickle=False)
    meta = json.loads(bytes(z["_meta"]).decode())
    m = MapStore(cfg)
    K, M = meta["next_kf"], meta["next_mp"]
    m.ensure_kf_capacity(K)
    m.ensure_mp_capacity(M)
    # match the checkpoint's observation fan-in width
    saved_cap = z["mp_obs_kf"].shape[1]
    while m.obs_cap < saved_cap:
        m._grow_obs_cap()
    for f in _KF_FIELDS:
        if f == "covis":
            m.covis[:K, :K] = z["covis"]
        else:
            getattr(m, f)[:K] = z[f]
    for f in _MP_FIELDS:
        if f in ("mp_obs_kf", "mp_obs_feat"):
            getattr(m, f)[:M, :saved_cap] = z[f]
        else:
            getattr(m, f)[:M] = z[f]
    m.next_kf = K
    m.next_mp = M
    m.n_kf = meta["n_kf"]
    m.big_change_idx = meta.get("big_change_idx", 0)
    m.children = {int(k): set(v) for k, v in meta["children"].items()}
    m.loop_edges = {
        int(k): set(v) for k, v in meta.get("loop_edges", {}).items()
    }
    return m, meta["next_frame_id"]
