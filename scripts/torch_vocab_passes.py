"""How the vocabulary builder's RNG passes and seconds grow with a harvested
corpus: the first worlds of the L6 recipe (scripts/torch_train_vocab_l6.py)
harvested once, then k=10, L=6 trained from seed 0 over the descriptors of
the first n worlds, for each n of --worlds.

    python scripts/torch_vocab_passes.py harvest N [--device cuda|cpu] [--corpus PATH]
    python scripts/torch_vocab_passes.py train [--worlds 8,32,128] [--device cuda|cpu] [--corpus PATH]

`harvest` saves the corpus of the first N worlds and each world's
descriptor count to PATH (default chiprun_out/vocab_passes_corpus.npz);
`train` prints a JSON line for each n: the descriptors, the seconds, the
SHA-256 of the tree (node_desc and word_idf), and per level the nodes, the
nodes of more than k rows, the passes, the resumes, the zero-sum and
empty-cluster picks and the seconds. Both run on the card unless
`--device cpu`. Nothing of the JAX package is imported.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch_train_vocab_l6 as l6  # noqa: E402
from torch_train_vocab import OUT_DIR, output_path  # noqa: E402

from orb_slam2_2021_tpu_torch import resolve_device  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("harvest", "train"))
    ap.add_argument("n_worlds", nargs="?", type=int, default=128)
    ap.add_argument("--worlds", default="8,32,128")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    ap.add_argument("--corpus", default=os.path.join(OUT_DIR, "vocab_passes_corpus.npz"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    if args.mode == "harvest":
        t0 = time.perf_counter()
        corpus, worlds = l6.harvest(1 << 62, dev, max_worlds=args.n_worlds, workers=args.workers,
                                    log=lambda m: print(m, flush=True))
        sizes = np.array([sum(len(d) for d in got) for got in worlds], np.int64)
        np.savez(output_path(args.corpus), corpus=corpus, world_sizes=sizes)
        print(f"harvested {len(corpus)} descriptors from {len(worlds)} worlds in "
              f"{time.perf_counter() - t0:.1f} s -> {args.corpus}", flush=True)
        return
    z = np.load(args.corpus)
    corpus, ends = z["corpus"], np.cumsum(z["world_sizes"])
    for n in (int(w) for w in args.worlds.split(",")):
        sub = corpus[: ends[min(n, len(ends)) - 1]]
        stats = {}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        voc = l6.train(sub, dev, stats)
        seconds = time.perf_counter() - t0
        digest = hashlib.sha256(voc.node_desc.tobytes() + voc.word_idf.tobytes()).hexdigest()
        levels = [{key: r.get(key) for key in ("nodes", "large", "passes", "resumes", "zero_sum_picks",
                                               "empty_picks", "seconds")} for r in stats["levels"]]
        print(json.dumps({"worlds": min(n, len(ends)), "descriptors": len(sub), "seconds": seconds,
                          "tree_sha256": digest, "levels": levels}), flush=True)


if __name__ == "__main__":
    main()
