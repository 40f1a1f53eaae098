"""Train the production 10^6-word ORB vocabulary (k=10, L=6) on the card: the
twin of scripts/train_vocab_l6.py on the port's types.

    python scripts/torch_train_vocab_l6.py harvest [target_descs] [--device cuda|cpu] [--corpus PATH]
    python scripts/torch_train_vocab_l6.py train [--device cuda|cpu] [--corpus PATH] [--out PATH]

The reference's recipe (default 4,000,000 descriptors): every texture family
of torch_train_vocab_l5.py plus Gaussian blob fields and ridged
multifractals (six in turn; the curved-grating family stays out, the
held-out probe of the reference's tests), over flat worlds (10 forward
frames, 0.8 m a step) and cylinder worlds of random radius (a 10-frame
orbit arc) seeded 900, 901, ..., each view augmented from
default_rng(5000 + seed); frames are 560x420, 1,600 features over 4 levels.
A family's texture is generated at most 640x960 and upscaled. `harvest`
extracts on the card (a world's frames at once) and saves the corpus to
PATH (default chiprun_out/vocab_corpus_l6.npy); `train` runs hierarchical
binary k-medians at k=10, L=6 from seed 0 on the card over the saved corpus
and writes the tree (default chiprun_out/vocab_k10_L6.npz), never into the
reference package. Both raise without a card unless `--device cpu`.
Nothing of the JAX package is imported.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from torch_train_vocab import OUT_DIR, extract_descriptors, output_path, rendered_worlds  # noqa: E402
from torch_train_vocab_l5 import (  # noqa: E402  texture generators and augmentation (4 families)
    augment,
    collage_texture,
    turbulence_texture,
    voronoi_texture,
)

from orb_slam2_2021_tpu_torch import resolve_device  # noqa: E402
from orb_slam2_2021_tpu_torch.config import OrbConfig, synthetic_config  # noqa: E402
from orb_slam2_2021_tpu_torch.io.synthetic import (  # noqa: E402
    SyntheticCylinderWorld,
    SyntheticStereoWorld,
    forward_trajectory,
    orbit_trajectory,
)
from orb_slam2_2021_tpu_torch.place.vocab import train_vocabulary  # noqa: E402


def blob_texture(rng, h, w, n_blobs=140):
    """Soft Gaussian blob field: smooth round features, no straight edges."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    out = np.full((h, w), 80.0, np.float32)
    for _ in range(n_blobs):
        cy, cx = rng.uniform(0, h), rng.uniform(0, w)
        s = rng.uniform(3, 18)
        a = rng.uniform(-120, 120)
        out += a * np.exp(-((ys - cy) ** 2 + (xs - cx) ** 2) / (2 * s * s))
    out -= out.min()
    return 255.0 * out / max(out.max(), 1e-6)


def ridged_texture(rng, h, w, octaves=5):
    """Ridged multifractal (1 - |noise|)^2: sharp ridge lines at all
    orientations, unlike turbulence's soft creases."""
    out = np.zeros((h, w), np.float32)
    amp = 1.0
    for o in range(octaves):
        gh, gw = 3 * 2 ** o + 1, 3 * 2 ** o + 1
        g = rng.standard_normal((gh, gw)).astype(np.float32)
        ys = np.linspace(0, gh - 1.001, h)
        xs = np.linspace(0, gw - 1.001, w)
        y0 = ys.astype(int)[:, None]
        x0 = xs.astype(int)[None, :]
        fy = ys[:, None] - y0
        fx = xs[None, :] - x0
        v = (g[y0, x0] * (1 - fy) * (1 - fx) + g[y0, x0 + 1] * (1 - fy) * fx
             + g[y0 + 1, x0] * fy * (1 - fx) + g[y0 + 1, x0 + 1] * fy * fx)
        r = (1.0 - np.abs(np.tanh(v))) ** 2
        out += r * amp
        amp *= 0.5
    out -= out.min()
    return 255.0 * out / max(out.max(), 1e-6)


def _bilinear_resize(img, h, w):
    """Numpy bilinear upscale."""
    ih, iw = img.shape
    ys = np.linspace(0, ih - 1.001, h)
    xs = np.linspace(0, iw - 1.001, w)
    y0 = ys.astype(int)[:, None]
    x0 = xs.astype(int)[None, :]
    fy = ys[:, None] - y0
    fx = xs[None, :] - x0
    return (img[y0, x0] * (1 - fy) * (1 - fx)
            + img[y0, x0 + 1] * (1 - fy) * fx
            + img[y0 + 1, x0] * fy * (1 - fx)
            + img[y0 + 1, x0 + 1] * fy * fx).astype(np.float32)


def _make_texture(fam, rng, th, tw):
    """The family's texture at most 640x960, upscaled to the world's: the
    cylinder worlds carry multi-megapixel textures, and the descriptors need
    only the local structure, which survives a 2-4x upscale."""
    gh, gw = min(th, 640), min(tw, 960)
    tex = fam(rng, gh, gw)
    if (gh, gw) != (th, tw):
        tex = _bilinear_resize(tex, th, tw)
    return tex.astype(np.float32)


TEXTURES = [None, voronoi_texture, turbulence_texture, collage_texture, blob_texture, ridged_texture]


def config():
    return synthetic_config(width=560, height=420).replace(orb=OrbConfig(n_features=1600, n_levels=4))


def world_images(cfg, seed: int):
    """World `seed` of the recipe: its augmented views, in order."""
    fam = TEXTURES[seed % len(TEXTURES)]
    wrng = np.random.default_rng(5000 + seed)
    if seed % 2 == 0:
        world = SyntheticStereoWorld(cfg, seed=900 + seed)
        if fam is not None:
            th, tw = world.texture.shape
            world.texture = _make_texture(fam, wrng, th, tw)
        views = list(forward_trajectory(10, step=0.8))
    else:
        world = SyntheticCylinderWorld(cfg, seed=900 + seed, radius=float(wrng.uniform(4.0, 14.0)))
        if fam is not None:
            th, tw = world.texture.shape
            world.texture = _make_texture(fam, wrng, th, tw)
        views = orbit_trajectory(10, total_deg=float(wrng.uniform(30, 150)),
                                 r_orbit=float(wrng.uniform(0.5, 3.0)))
    return [augment(world.render(R, t)[0], wrng) for R, t in views]


def harvest(target: int, device, max_worlds=None, workers: int = 1, log=print):
    """The reference's corpus, cut to `target`, from at most `max_worlds`
    worlds; returns (corpus, per world the descriptor arrays of its views)."""
    cfg = config()
    worlds, total, t0 = [], 0, time.perf_counter()
    for _, images in rendered_worlds(world_images, cfg, workers, limit=max_worlds):
        got = extract_descriptors(images, cfg.orb, device)
        worlds.append(got)
        total += sum(len(d) for d in got)
        if len(worlds) % 16 == 0:
            log(f"{len(worlds)} worlds, {total} descriptors, {time.perf_counter() - t0:.0f}s")
        if total >= target:
            break
    corpus = np.concatenate([d for got in worlds for d in got], axis=0)[:target]
    return corpus, worlds


def train(corpus, device, stats=None):
    """k=10, L=6 from seed 0 over `corpus`."""
    return train_vocabulary(corpus, k=10, L=6, seed=0, device=device, stats=stats)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("harvest", "train"), nargs="?", default="harvest")
    ap.add_argument("target", nargs="?", type=int, default=4_000_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1,
                    help="processes that render the worlds")
    ap.add_argument("--corpus", default=os.path.join(OUT_DIR, "vocab_corpus_l6.npy"))
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "vocab_k10_L6.npz"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.mode == "harvest":
        path = output_path(args.corpus)
        corpus, worlds = harvest(args.target, dev, workers=args.workers, log=lambda m: print(m, flush=True))
        np.save(path, corpus)
        print(f"harvested {len(corpus)} descriptors ({len(worlds)} worlds, 6 texture families) -> {path}",
              flush=True)
        return
    out = output_path(args.out)
    corpus = np.load(args.corpus)
    print(f"training k=10 L=6 on {len(corpus)} descriptors", flush=True)
    t1 = time.perf_counter()
    stats = {}
    voc = train(corpus, dev, stats)
    print(f"trained in {time.perf_counter() - t1:.1f} s on {dev}; passes per level "
          f"{[r['passes'] for r in stats['levels']]}", flush=True)
    voc.save(out)
    print("saved", out, flush=True)
    words = voc.transform_np(corpus[:200000])
    print("unique words in 200k sample:", len(np.unique(words)), flush=True)


if __name__ == "__main__":
    main()
