"""Train a 10^4-word ORB vocabulary (k=10, L=4) on the card: the twin of
scripts/train_vocab.py on the port's types.

    python scripts/torch_train_vocab.py [n_worlds] [--device cuda|cpu] [--out PATH]

The reference's recipe: 24 SyntheticStereoWorld seeds (100, 101, ...), 3
frames of a forward track (1.5 m a step) each, rendered at 480x360 and
extracted with 1,024 features over 4 levels; the descriptors of every valid
keypoint, in order, are the corpus; hierarchical binary k-medians at k=10,
L=4 from seed 0. Extraction (frontend/features.extract_orb_batched, a
world's frames at once) and training (place/vocab.train_vocabulary) run on
the card by default and raise without one; `--device cpu` runs both on the
CPU. The tree is written to PATH (default chiprun_out/vocab_k10_L4.npz),
never into the reference package's data folder, whose vocabularies the
reference's scripts wrote. Nothing of the JAX package is imported.
"""

from __future__ import annotations

import argparse
import itertools
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from orb_slam2_2021_tpu_torch import resolve_device  # noqa: E402
from orb_slam2_2021_tpu_torch.config import OrbConfig, synthetic_config  # noqa: E402
from orb_slam2_2021_tpu_torch.frontend.features import extract_orb_batched  # noqa: E402
from orb_slam2_2021_tpu_torch.io.synthetic import SyntheticStereoWorld, forward_trajectory  # noqa: E402
from orb_slam2_2021_tpu_torch.place.vocab import train_vocabulary  # noqa: E402

OUT_DIR = os.path.join(REPO, "chiprun_out")
REFERENCE_PACKAGE = os.path.join(REPO, "orb_slam2_2021_tpu")


def output_path(path: str) -> str:
    """`path` as an absolute path; refuses one inside the reference package."""
    path = os.path.abspath(path)
    if os.path.commonpath([path, REFERENCE_PACKAGE]) == REFERENCE_PACKAGE:
        raise ValueError(f"{path}: the reference package's files are not written by the port")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    return path


def extract_descriptors(images, orb, device):
    """Float32 images [H, W] (one batch) -> per image, the [n, 8] uint32
    descriptors of its valid keypoints, in slot order."""
    x = torch.from_numpy(np.stack(images).astype(np.float32)).to(device)
    kp, _ = extract_orb_batched(x, orb)
    desc = kp.desc.cpu().numpy().view(np.uint32)
    valid = kp.valid.cpu().numpy()
    return [desc[b][valid[b]] for b in range(len(images))]


def rendered_worlds(render, cfg, workers: int, limit=None):
    """Yield (seed, render(cfg, seed)) for seeds 0, 1, ... (below `limit` if
    given), rendering `workers` worlds at once in spawned processes (the
    rendering is host numpy; the caller extracts)."""
    seeds = range(limit) if limit is not None else itertools.count()
    if workers <= 1:
        for seed in seeds:
            yield seed, render(cfg, seed)
        return
    seeds = iter(seeds)
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        while True:
            wave = list(itertools.islice(seeds, workers))
            if not wave:
                return
            for seed, fut in zip(wave, [pool.submit(render, cfg, s) for s in wave]):
                yield seed, fut.result()


def config():
    return synthetic_config(width=480, height=360).replace(orb=OrbConfig(n_features=1024, n_levels=4))


def world_images(cfg, seed: int):
    """World `seed` of the recipe: its 3 forward frames."""
    world = SyntheticStereoWorld(cfg, seed=seed + 100)
    return [world.render(R, t)[0] for R, t in forward_trajectory(3, step=1.5)]


def harvest(n_worlds: int, device, workers: int = 1, log=print) -> np.ndarray:
    """The reference's corpus: 3 forward frames of each of `n_worlds` worlds."""
    cfg = config()
    descs = []
    for seed, frames in rendered_worlds(world_images, cfg, workers, limit=n_worlds):
        descs += extract_descriptors(frames, cfg.orb, device)
        log(f"world {seed}: total descriptors {sum(len(d) for d in descs)}")
    return np.concatenate(descs, axis=0)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("n_worlds", nargs="?", type=int, default=24)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "vocab_k10_L4.npz"))
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1,
                    help="processes that render the worlds")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out = output_path(args.out)
    t0 = time.perf_counter()
    corpus = harvest(args.n_worlds, dev, args.workers)
    t1 = time.perf_counter()
    print(f"training on {len(corpus)} descriptors (harvested in {t1 - t0:.1f} s on {dev})", flush=True)
    stats = {}
    voc = train_vocabulary(corpus, k=10, L=4, seed=0, device=dev, stats=stats)
    print(f"trained in {time.perf_counter() - t1:.1f} s; passes per level "
          f"{[r['passes'] for r in stats['levels']]}", flush=True)
    voc.save(out)
    print("saved", out)
    words = voc.transform_np(corpus[:5000])
    print("unique words in 5k sample:", len(np.unique(words)))


if __name__ == "__main__":
    main()
