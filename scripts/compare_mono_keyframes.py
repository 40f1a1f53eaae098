"""Monocular keyframe decisions, the JAX reference System against the port's
CPU path, at tum_rgbd_config("freiburg1") (640x480, 2000 features, the
freiburg1 lens), at the defaults (packaged vocabulary, mapping and loop
closing on, synchronous), over the images of chip_smoke.py's TUM drive:
SyntheticStereoWorld(seed 4) rendered through the lens on
forward_trajectory(60, step 0.12).

One run per System, each in its own process (about 4 s a frame on a CPU):

    python scripts/compare_mono_keyframes.py jax      out/jax.json
    python scripts/compare_mono_keyframes.py port-ref out/port_ref.json
    python scripts/compare_mono_keyframes.py port-own out/port_own.json
    python scripts/compare_mono_keyframes.py compare out/jax.json out/port_ref.json

`port-ref` gives the port the reference's own two-view and EPnP minimal
sets (drawn with JAX's PRNG, as the parity tests do); `port-own` keeps the
port's default host generator, which is what the port draws on the card.
Each run writes, per frame, the tracked flag, the state, the keyframe flag,
the live and created keyframe counts, and the inputs and verdict of every
`_need_new_keyframe` call; `compare` prints the first frame whose keyframe
decision differs and the gate inputs there.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES, STEP, SEED = 60, 0.12, 4


def _images(cfg_mod, syn_mod, n):
    cfg = cfg_mod.tum_rgbd_config("freiburg1")
    world = syn_mod.SyntheticStereoWorld(cfg, seed=SEED)
    out = [world.render_rgbd(R, t, dist_coef=cfg.dist_coef)[0]
           for R, t in syn_mod.forward_trajectory(n, step=STEP)]
    return cfg, out


def _wrap_gate(tracker, log):
    """Record _need_new_keyframe's inputs (NeedNewKeyFrame's nRefMatches,
    tracked inliers, frames since the last keyframe) and its verdict."""
    orig = tracker._need_new_keyframe

    def gate(frame, frame_id):
        m = tracker.map
        rec = {"frame": int(frame_id), "n_kf": int(m.n_kf), "ref_kf": int(tracker.ref_kf),
               "inliers": int(tracker.n_inliers_last),
               "frames_since": int(frame_id - tracker.last_kf_frame_id)}
        if tracker.ref_kf >= 0:
            min_obs = 3 if m.n_kf > 2 else 2
            ref_mp = m.kf_mp[tracker.ref_kf]
            sel = np.clip(ref_mp, 0, None)
            rec["n_ref"] = int(((ref_mp >= 0) & m.mp_valid[sel] & (m.mp_n_obs[sel] >= min_obs)).sum())
            rec["ratio"] = rec["inliers"] / max(rec["n_ref"], 1)
        rec["verdict"] = bool(orig(frame, frame_id))
        log.append(rec)
        return rec["verdict"]

    tracker._need_new_keyframe = gate


def run(which: str, out_path: str, n: int):
    sys.path.insert(0, REPO)
    if which == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_default_matmul_precision", "highest")
        from orb_slam2_2021_tpu import config as cfg_mod
        from orb_slam2_2021_tpu.io import synthetic as syn_mod
        from orb_slam2_2021_tpu.pipeline.system import System

        cfg, images = _images(cfg_mod, syn_mod, n)
        sys_ = System(cfg, sensor="mono")
    else:
        import torch

        torch.set_num_threads(2)
        from orb_slam2_2021_tpu_torch import config as cfg_mod
        from orb_slam2_2021_tpu_torch.io import synthetic as syn_mod
        from orb_slam2_2021_tpu_torch.pipeline.system import System

        cfg, images = _images(cfg_mod, syn_mod, n)
        sys_ = System(cfg, sensor="mono", device="cpu")
        if which == "port-ref":
            import jax
            import jax.numpy as jnp

            jax.config.update("jax_platforms", "cpu")
            from orb_slam2_2021_tpu_torch.convert import samples_from_reference

            def choice(key, valid, m):
                probs = jnp.asarray(valid, jnp.float32)
                probs = probs / jnp.maximum(jnp.sum(probs), 1.0)
                return jax.random.choice(key, len(valid), shape=(m,), replace=False, p=probs)

            def init_sampler(valid, frame_id):
                keys = jax.random.split(jax.random.PRNGKey(frame_id), 256)
                idx = jax.vmap(lambda k: choice(k, valid, 8))(keys)
                return torch.from_numpy(np.asarray(idx).astype(np.int64))

            def reloc_sampler(valid, m, n_hyps, seed):
                keys = jax.random.split(jax.random.PRNGKey(seed), n_hyps)
                idx = jax.vmap(lambda k: choice(k, valid, m))(keys)
                return samples_from_reference(np.asarray(idx), "cpu")

            sys_.tracker.init_sampler = init_sampler
            sys_.tracker.reloc_sampler = reloc_sampler
    gates: list = []
    _wrap_gate(sys_.tracker, gates)
    frames = []
    t0 = time.perf_counter()
    for i, img in enumerate(images):
        pose = sys_.track_monocular(img, timestamp=0.1 * i)
        rec = sys_.metrics[-1] if sys_.metrics else {}
        frames.append({"frame": i, "tracked": pose is not None, "state": rec.get("state"),
                       "keyframe": bool(rec.get("keyframe", False)), "n_kf": int(sys_.map.n_kf),
                       "next_kf": int(sys_.map.next_kf), "n_mp": int(sys_.map.mp_valid.sum())})
        print(f"{which} frame {i}: {frames[-1]} ({time.perf_counter() - t0:.0f} s)", flush=True)
    sys_.shutdown()
    with open(out_path, "w") as f:
        json.dump({"system": which, "frames": frames, "gates": gates}, f)


def compare(path_a: str, path_b: str):
    a, b = (json.load(open(p)) for p in (path_a, path_b))
    for key in ("system",):
        print(f"{a[key]} against {b[key]}")
    for fa, fb in zip(a["frames"], b["frames"]):
        if fa["keyframe"] != fb["keyframe"] or fa["tracked"] != fb["tracked"]:
            i = fa["frame"]
            print(f"first differing frame {i}: {fa} / {fb}")
            ga = [g for g in a["gates"] if g["frame"] == i]
            gb = [g for g in b["gates"] if g["frame"] == i]
            print(f"  gate {a['system']}: {ga}\n  gate {b['system']}: {gb}")
            break
    else:
        print("no frame differs in its keyframe decision or tracked flag")
    for d in (a, b):
        kfs = [f["frame"] for f in d["frames"] if f["keyframe"]]
        last = d["frames"][-1]
        print(f"{d['system']}: {sum(f['tracked'] for f in d['frames'])} tracked, keyframes at "
              f"frames {kfs} ({len(kfs)} keyframe frames), live {last['n_kf']}, created {last['next_kf']}")


if __name__ == "__main__":
    if sys.argv[1] == "compare":
        compare(sys.argv[2], sys.argv[3])
    else:
        run(sys.argv[1], sys.argv[2], int(sys.argv[3]) if len(sys.argv) > 3 else N_FRAMES)
