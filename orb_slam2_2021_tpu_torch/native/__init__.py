"""Native (C++) map-store kernels, loaded via ctypes: the port's own copy of
orb_slam2_2021_tpu/native.

Host-side bookkeeping the reference implements in C++ (KeyFrame/MapPoint
member functions), not a device kernel. `map_core.cpp` is built with g++ at
first import into orb_slam2_2021_tpu_torch/_build/ (named by the source's
and flags' content hash; written to a temporary name and renamed, so
parallel processes do not race) and loaded from there. Without a compiler
everything degrades to the numpy implementations (`HAVE_NATIVE` is False).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "map_core.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC")

_lib = None


def _lib_path() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(_BUILD_DIR, f"libmapcore_{digest}.so")


def _build(path: str):
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], check=True, capture_output=True)
    os.replace(tmp, path)


def _load():
    global _lib
    if _lib is not None:
        return _lib
    try:
        path = _lib_path()
        if not os.path.exists(path):
            _build(path)
        lib = ctypes.CDLL(path)
    except (OSError, subprocess.CalledProcessError):
        return None

    i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
    u32p = np.ctypeslib.ndpointer(np.uint32, flags="C")

    lib.batch_add_observations.restype = ctypes.c_int64
    lib.batch_add_observations.argtypes = [
        ctypes.c_int64, i64p, f32p, ctypes.c_int64,
        i64p, i32p, i32p, i32p, ctypes.c_int64,
    ]
    lib.update_point_stats.restype = None
    lib.update_point_stats.argtypes = [
        i64p, ctypes.c_int64,
        f32p, i64p, i32p, i32p, ctypes.c_int64,
        f32p, f32p, u32p, i32p, ctypes.c_int64,
        f32p, ctypes.c_int32,
        f32p, f32p, f32p, u32p,
    ]
    lib.covis_counts.restype = None
    lib.covis_counts.argtypes = [
        ctypes.c_int64, i64p, ctypes.c_int64,
        i64p, i32p, ctypes.c_int64, i32p,
    ]
    _lib = lib
    return lib


try:
    _load()
except Exception:
    _lib = None

HAVE_NATIVE = _lib is not None


def batch_add_observations(kf, mp_bind, kf_ur, mp_obs_kf, mp_obs_feat, mp_obs_n, mp_n_obs, obs_cap):
    return _lib.batch_add_observations(
        kf, np.ascontiguousarray(mp_bind), np.ascontiguousarray(kf_ur, np.float32),
        len(mp_bind), mp_obs_kf, mp_obs_feat, mp_obs_n, mp_n_obs, obs_cap,
    )


def update_point_stats(ids, mp_pos, mp_obs_kf, mp_obs_feat, mp_obs_n, obs_cap,
                       kf_R, kf_t, kf_desc, kf_octave, n_feats,
                       scale_factors, mp_normal, mp_min_dist, mp_max_dist, mp_desc):
    ids = np.ascontiguousarray(ids, np.int64)
    _lib.update_point_stats(
        ids, len(ids), mp_pos, mp_obs_kf, mp_obs_feat, mp_obs_n, obs_cap,
        kf_R, kf_t, kf_desc, kf_octave, n_feats,
        np.ascontiguousarray(scale_factors, np.float32), len(scale_factors),
        mp_normal, mp_min_dist, mp_max_dist, mp_desc,
    )


def covis_counts(kf, kf_mp, mp_obs_kf, mp_obs_n, obs_cap, counts):
    _lib.covis_counts(
        kf, np.ascontiguousarray(kf_mp, np.int64), len(kf_mp),
        mp_obs_kf, mp_obs_n, obs_cap, counts,
    )
