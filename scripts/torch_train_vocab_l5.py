"""Train a 10^5-word ORB vocabulary (k=10, L=5) on a diverse corpus on the
card: the twin of scripts/train_vocab_l5.py on the port's types.

    python scripts/torch_train_vocab_l5.py [target_descs] [--device cuda|cpu] [--out PATH]

The reference's recipe (default 600,000 descriptors): worlds seeded 200,
201, ... alternate between a flat SyntheticStereoWorld (8 forward frames,
0.9 m a step) and a SyntheticCylinderWorld of random radius (an 8-frame
orbit arc); the texture family cycles through the worlds' own value noise,
Voronoi cells, turbulence and box collages; every view is augmented
(gamma, noise, contrast, mirror) from the world's own generator
(default_rng(1000 + seed)). Frames are 480x360, 1,200 features over 4
levels. Harvesting stops after the world that reaches the target, and the
corpus is cut to it; hierarchical binary k-medians at k=10, L=5 from seed
0. Extraction (a world's frames at once) and training run on the card by
default and raise without one; `--device cpu` runs both on the CPU. The
tree is written to PATH (default chiprun_out/vocab_k10_L5.npz), never into
the reference package. Nothing of the JAX package is imported.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_train_vocab import OUT_DIR, extract_descriptors, output_path, rendered_worlds  # noqa: E402

from orb_slam2_2021_tpu_torch import resolve_device  # noqa: E402
from orb_slam2_2021_tpu_torch.config import OrbConfig, synthetic_config  # noqa: E402
from orb_slam2_2021_tpu_torch.io.synthetic import (  # noqa: E402
    SyntheticCylinderWorld,
    SyntheticStereoWorld,
    forward_trajectory,
    orbit_trajectory,
)
from orb_slam2_2021_tpu_torch.place.vocab import train_vocabulary  # noqa: E402


# texture generators structurally unlike the worlds' smooth value noise
def voronoi_texture(rng, h, w, n_sites=220):
    """Hard-edged random cells: step edges and corners at all orientations."""
    sy = rng.uniform(0, h, n_sites)
    sx = rng.uniform(0, w, n_sites)
    sv = rng.uniform(30, 225, n_sites).astype(np.float32)
    ys, xs = np.mgrid[0:h, 0:w]
    best = np.full((h, w), np.inf, np.float32)
    out = np.zeros((h, w), np.float32)
    for i in range(n_sites):
        d = (ys - sy[i]) ** 2 + (xs - sx[i]) ** 2
        m = d < best
        best[m] = d[m]
        out[m] = sv[i]
    return out


def turbulence_texture(rng, h, w, octaves=5):
    """Multi-octave |noise| turbulence: fractal detail at every scale."""
    out = np.zeros((h, w), np.float32)
    amp = 1.0
    for o in range(octaves):
        gh, gw = 4 * 2 ** o + 1, 4 * 2 ** o + 1
        g = rng.standard_normal((gh, gw)).astype(np.float32)
        ys = np.linspace(0, gh - 1.001, h)
        xs = np.linspace(0, gw - 1.001, w)
        y0 = ys.astype(int)[:, None]
        x0 = xs.astype(int)[None, :]
        fy = (ys[:, None] - y0)
        fx = (xs[None, :] - x0)
        v = (g[y0, x0] * (1 - fy) * (1 - fx) + g[y0, x0 + 1] * (1 - fy) * fx
             + g[y0 + 1, x0] * fy * (1 - fx) + g[y0 + 1, x0 + 1] * fy * fx)
        out += np.abs(v) * amp
        amp *= 0.55
    out -= out.min()
    return 255.0 * out / max(out.max(), 1e-6)


def collage_texture(rng, h, w, n_boxes=420):
    """Random overlapping boxes and bars: man-made scene statistics
    (axis-aligned edges, uniform regions, high-contrast corners)."""
    out = np.full((h, w), float(rng.uniform(60, 190)), np.float32)
    for _ in range(n_boxes):
        bw = int(rng.uniform(3, w // 6))
        bh = int(rng.uniform(3, h // 6))
        x = rng.integers(0, max(w - bw, 1))
        y = rng.integers(0, max(h - bh, 1))
        out[y: y + bh, x: x + bw] = rng.uniform(10, 245)
    return out


def augment(img, rng):
    """Photometric and mirror augmentations of a rendered view."""
    mode = rng.integers(0, 6)
    x = img.astype(np.float32)
    if mode == 1:
        x = 255.0 * (x / 255.0) ** 0.5
    elif mode == 2:
        x = 255.0 * (x / 255.0) ** 2.0
    elif mode == 3:
        x = np.clip(x + rng.normal(0, 8, x.shape), 0, 255)
    elif mode == 4:
        x = np.clip((x - 127.5) * 1.6 + 127.5, 0, 255)
    elif mode == 5:
        x = x[:, ::-1]
    return np.ascontiguousarray(x, np.float32)


TEXTURES = [None, voronoi_texture, turbulence_texture, collage_texture]


def config():
    return synthetic_config(width=480, height=360).replace(orb=OrbConfig(n_features=1200, n_levels=4))


def world_images(cfg, seed: int):
    """World `seed` of the recipe: its augmented views, in order."""
    fam = TEXTURES[seed % len(TEXTURES)]
    wrng = np.random.default_rng(1000 + seed)
    if seed % 2 == 0:
        world = SyntheticStereoWorld(cfg, seed=200 + seed)
        if fam is not None:
            th, tw = world.texture.shape
            world.texture = fam(wrng, th, tw).astype(np.float32)
        views = list(forward_trajectory(8, step=0.9))
    else:
        world = SyntheticCylinderWorld(cfg, seed=200 + seed, radius=float(wrng.uniform(5.0, 12.0)))
        if fam is not None:
            th, tw = world.texture.shape
            world.texture = fam(wrng, th, tw).astype(np.float32)
        views = orbit_trajectory(8, total_deg=float(wrng.uniform(30, 120)),
                                 r_orbit=float(wrng.uniform(0.5, 2.5)))
    return [augment(world.render(R, t)[0], wrng) for R, t in views]


def harvest(target: int, device, workers: int = 1, log=print):
    """The reference's corpus, cut to `target`; returns (corpus, worlds)."""
    cfg = config()
    descs, total, worlds, t0 = [], 0, 0, time.perf_counter()
    for _, images in rendered_worlds(world_images, cfg, workers):
        got = extract_descriptors(images, cfg.orb, device)
        descs += got
        total += sum(len(d) for d in got)
        worlds += 1
        if worlds % 16 == 0:
            log(f"{worlds} worlds, {total} descriptors, {time.perf_counter() - t0:.0f}s")
        if total >= target:
            break
    return np.concatenate(descs, axis=0)[:target], worlds


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("target", nargs="?", type=int, default=600_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1,
                    help="processes that render the worlds")
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "vocab_k10_L5.npz"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = output_path(args.out)
    corpus, worlds = harvest(args.target, dev, args.workers, log=lambda m: print(m, flush=True))
    print(f"training k=10 L=5 on {len(corpus)} descriptors ({worlds} worlds, 4 texture families)",
          flush=True)
    t1 = time.perf_counter()
    stats = {}
    voc = train_vocabulary(corpus, k=10, L=5, seed=0, device=dev, stats=stats)
    print(f"trained in {time.perf_counter() - t1:.1f} s on {dev}; passes per level "
          f"{[r['passes'] for r in stats['levels']]}", flush=True)
    voc.save(out)
    print("saved", out, flush=True)
    words = voc.transform_np(corpus[:50000])
    print("unique words in 50k sample:", len(np.unique(words)), flush=True)


if __name__ == "__main__":
    main()
