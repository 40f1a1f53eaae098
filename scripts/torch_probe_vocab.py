"""Device times of the vocabulary builder's seed-draw and majority kernels on
one CUDA card.

    python3 scripts/torch_probe_vocab.py [--before PATH/TO/vocab.cu] [--tree DIR [--tree-cpu]] [--out F]

Prints the card's name and power limit, then nvcc's register and spill
report for csrc/vocab.cu. At the shapes of levels 0 and 5 of chip_smoke.py
phase 27 (d) (one node of 4,000,000 rows; 99,907 nodes of 1-79 rows, about
4 M in all; k = 10) and of levels 2 and 5 of (b) (100 nodes of 651 rows;
657 nodes of 1-40), on random inputs made from a seed, it holds
vocab_seed_draw and vocab_majority against their plain versions
(tolerance 0) and times them by chip_smoke.device_ms (CUDA events around
calls queued behind a sleep), beside the bound (chip_smoke.vocab_bound)
and, for the seed draw, torch.cumsum of the same float64 p as a yardstick.

`--before` names an earlier vocab.cu with the earlier launchers
(`vocab_seed_draw_launch(d2, offsets, u, groups, cdf, pick, zero, stream)`,
`vocab_majority_launch` over chunks of 1,024 rows of every node), for
instance unpacked with `git archive <commit>
orb_slam2_2021_tpu_torch/csrc/vocab.cu | tar -x -C _archive/parent`. Its two
kernels are held against the same plain versions and timed in turns with
the package's (before, package, package, before; the better of two each).
`--tree DIR` also times chip_smoke.py phase 27's (d) tree (k=10, L=6, seed
0 over VOCAB_FULL random descriptors from default_rng(VOCAB_FULL_SEED)) with
the package under DIR (an earlier commit's orb_slam2_2021_tpu_torch
unpacked there) and with this one, each in a process of its own, in turns
(before, package, package, before), two trees a process; it prints the
seconds and each tree's SHA-256, and with `--tree-cpu` trains the same tree
once more through the CPU path (the plain versions, several minutes): every
SHA-256 must agree. Last, each is profiled: torch.profiler's device time
of each kernel it launches. `--out` writes the numbers as JSON (default chiprun_out/probe_vocab.json).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from orb_slam2_2021_tpu_torch.ops import cuda_build  # noqa: E402
from orb_slam2_2021_tpu_torch.ops import vocab_kernels as vk  # noqa: E402

_P, _I = ctypes.c_void_p, ctypes.c_int
OLD_CHUNK = 1024  # the earlier majority's rows a block


def ptxas_report(src):
    cmd = [cuda_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-Xptxas", "-v", "-cubin", "-o", os.devnull, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    name = ""
    for line in (res.stdout + res.stderr).splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1][:70] if "'" in line else line
        elif "registers" in line or "spill" in line or "error" in line:
            print(f"  {name}: {line.strip()[:120]}", flush=True)


def old_majority_plan(offsets):
    n = offsets[1:] - offsets[:-1]
    n_chunks = torch.clamp_min((n + OLD_CHUNK - 1) // OLD_CHUNK, 1)
    first = torch.cumsum(n_chunks, 0) - n_chunks
    total = int(n_chunks.sum())
    node = torch.repeat_interleave(torch.arange(n.shape[0], device=offsets.device), n_chunks, output_size=total)
    local = torch.arange(total, device=offsets.device) - first[node]
    row0 = (offsets[:-1][node] + local * OLD_CHUNK).contiguous()
    rows = torch.clamp(n[node] - local * OLD_CHUNK, 0, OLD_CHUNK).to(torch.int32)
    multi = n_chunks > 1
    slot = torch.where(multi, torch.cumsum(multi.to(torch.int64), 0) - 1, torch.full_like(n, -1))
    return row0, rows, node.to(torch.int32), slot.to(torch.int32), torch.nonzero(multi)[:, 0].to(torch.int32)


class Before:
    """The earlier launchers of another vocab.cu."""

    def __init__(self, path):
        self.seed = cuda_build.CudaKernel(path, "vocab_seed_draw_launch", [_P, _P, _P, _I, _P, _P, _P, _P])
        self.maj = cuda_build.CudaKernel(path, "vocab_majority_launch",
                                         [_P] * 6 + [_I, _I] + [_P] * 5 + [_I, _P])
        self.seed.build()
        self.maj.build()

    def seed_draw(self, d2, offsets, u):
        g = u.shape[0]
        cdf = torch.empty(d2.shape[0], dtype=torch.float64, device=d2.device)
        pick = torch.empty(g, dtype=torch.int64, device=d2.device)
        zero = torch.empty(g, dtype=torch.int32, device=d2.device)
        err = self.seed.build()(d2.data_ptr(), offsets.data_ptr(), u.data_ptr(), g, cdf.data_ptr(),
                                pick.data_ptr(), zero.data_ptr(), torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return pick, zero.bool()

    def majority(self, rows, assign, offsets, k, plan):
        row0, nrows, node, slot, slot_node = plan
        g = offsets.shape[0] - 1
        centers = torch.empty((g, k, 8), dtype=torch.int32, device=rows.device)
        sizes = torch.empty((g, k), dtype=torch.int32, device=rows.device)
        counts = torch.zeros((slot_node.shape[0], k, 256), dtype=torch.int32, device=rows.device)
        ssz = torch.zeros((slot_node.shape[0], k), dtype=torch.int32, device=rows.device)
        err = self.maj.build()(rows.data_ptr(), assign.data_ptr(), row0.data_ptr(), nrows.data_ptr(),
                               node.data_ptr(), slot.data_ptr(), row0.shape[0], k, centers.data_ptr(),
                               sizes.data_ptr(), counts.data_ptr(), ssz.data_ptr(), slot_node.data_ptr(),
                               slot_node.shape[0], torch.cuda.current_stream().cuda_stream)
        assert err == 0, err
        return centers, sizes


def profiled(fn, iters=10):
    """Device time per call of each CUDA kernel `fn` launches (torch.profiler)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return {ev.key[:60]: round(ev.device_time_total / iters / 1e3, 4)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA and ev.count}


def best(fn):
    return min(cs.device_ms(fn, iters=20), cs.device_ms(fn, iters=20))


def in_turns(new, old):
    """(new ms, old ms): before, package, package, before."""
    if old is None:
        return best(new), None
    a = cs.device_ms(old, iters=20)
    b = cs.device_ms(new, iters=20)
    c = cs.device_ms(new, iters=20)
    d = cs.device_ms(old, iters=20)
    return min(b, c), min(a, d)


def same(a, b, what):
    for x, y in zip(a, b):
        if not torch.equal(x, y):
            raise AssertionError(f"{what} disagrees with the plain version")


def probe(label, sizes, dev, rng, before):
    offsets = torch.from_numpy(np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)).to(dev)
    n = int(offsets[-1])
    d2 = torch.from_numpy(rng.binomial(256, 0.45, n).astype(np.int32)).to(dev)
    u = torch.from_numpy(rng.random(len(sizes))).to(dev)
    out = {"at": label, "rows": n, "nodes": len(sizes)}

    max_rows = int(max(sizes))  # as place/vocab._large_pass passes it: no read-back a call
    ref = vk.vocab_seed_draw_plain(d2, offsets, u)
    same(vk.vocab_seed_draw(d2, offsets, u, max_rows), ref, "vocab_seed_draw")
    if before:
        same(before.seed_draw(d2, offsets, u), ref, "the earlier vocab_seed_draw")
    ms, old = in_turns(lambda: vk.vocab_seed_draw(d2, offsets, u, max_rows),
                       (lambda: before.seed_draw(d2, offsets, u)) if before else None)
    p = d2.double() / float(d2.sum())
    lib = best(lambda: torch.cumsum(p, 0))
    bound, by = cs.vocab_bound("vocab_seed_draw", (d2, offsets, u))
    out["vocab_seed_draw"] = {"ms": ms, "before_ms": old, "bound_ms": bound, "bound_by": by,
                              "library_ms": lib, "library": "torch.cumsum(float64 p)"}
    print(f"{label}: vocab_seed_draw {ms:.4f} ms (before {old}), bound {bound:.4f} ms by {by} "
          f"({100 * bound / ms:.1f}%), torch.cumsum {lib:.4f} ms", flush=True)
    profile = [("vocab_seed_draw", lambda: vk.vocab_seed_draw(d2, offsets, u, max_rows))]

    rows = torch.from_numpy(rng.integers(0, 2 ** 32, (n, 8), dtype=np.uint32).view(np.int32)).to(dev)
    assign = torch.from_numpy(rng.integers(0, 10, n)).to(dev)
    ref = vk.vocab_majority_plain(rows, assign, offsets, 10)
    plan = vk.majority_plan(offsets)
    bound, by = cs.vocab_bound("vocab_majority", (rows, assign, offsets, 10))
    old_plan = old_majority_plan(offsets) if before else None
    if before:
        same(before.majority(rows, assign, offsets, 10, old_plan), ref, "the earlier vocab_majority")
    same(vk.vocab_majority(rows, assign, offsets, 10, plan), ref, "vocab_majority")
    ms, old = in_turns(lambda: vk.vocab_majority(rows, assign, offsets, 10, plan),
                       (lambda: before.majority(rows, assign, offsets, 10, old_plan)) if before else None)
    print(f"{label}: vocab_majority {ms:.4f} ms (before {old}), bound {bound:.4f} ms by {by} "
          f"({100 * bound / ms:.1f}%)", flush=True)
    out["vocab_majority"] = {"ms": ms, "before_ms": old, "bound_ms": bound, "bound_by": by}
    profile.append(("vocab_majority", lambda: vk.vocab_majority(rows, assign, offsets, 10, plan)))
    return out, profile


TREE_CHILD = """
import hashlib, time, numpy as np, torch
from orb_slam2_2021_tpu_torch.ops import cuda_build, vocab_kernels as vk
from orb_slam2_2021_tpu_torch.place.vocab import train_vocabulary
if "{device}" == "cuda":
    cuda_build.build_all(list(vk.KERNELS))
words = np.random.default_rng({seed}).integers(0, 2 ** 32, ({n}, 8), dtype=np.uint32)
for _ in range({runs}):
    torch.cuda.synchronize() if "{device}" == "cuda" else None
    t0 = time.perf_counter()
    voc = train_vocabulary(words, k=10, L=6, seed=0, device="{device}")
    torch.cuda.synchronize() if "{device}" == "cuda" else None
    digest = hashlib.sha256(voc.node_desc.tobytes() + voc.word_idf.tobytes()).hexdigest()
    print("TREE", time.perf_counter() - t0, digest, flush=True)
"""


def tree_turns(before_dir, cpu):
    """(d)'s tree with the package under before_dir and with this one, in
    turns (and through this one's CPU path); per run the trees' seconds and
    SHA-256."""
    runs = []
    turns = [("before", before_dir, "cuda"), ("package", cs.REPO, "cuda"), ("package", cs.REPO, "cuda"),
             ("before", before_dir, "cuda")] + ([("package, CPU path", cs.REPO, "cpu")] if cpu else [])
    for label, root, device in turns:
        code = TREE_CHILD.format(seed=cs.VOCAB_FULL_SEED, n=cs.VOCAB_FULL, device=device,
                                 runs=2 if device == "cuda" else 1)
        res = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                             timeout=1800, env={**os.environ, "PYTHONPATH": root})
        if res.returncode != 0:
            raise RuntimeError(f"the {label} tree failed:\n{res.stderr[-3000:]}")
        trees = [line.split()[1:] for line in res.stdout.splitlines() if line.startswith("TREE ")]
        runs.append({"what": label, "s": [float(x[0]) for x in trees], "sha256": [x[1] for x in trees]})
        print(f"(d) tree, {label}: {runs[-1]['s']} s, sha256 {set(runs[-1]['sha256'])}", flush=True)
    if len({d for r in runs for d in r["sha256"]}) != 1:
        raise AssertionError("the trees differ")
    return runs


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--before", default=None)
    ap.add_argument("--tree", default=None)
    ap.add_argument("--tree-cpu", action="store_true")
    ap.add_argument("--out", default=os.path.join(cs.REPO, "chiprun_out", "probe_vocab.json"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_probe_vocab: no CUDA device")
    info = cs.card_info()
    print(f"card: {info}", flush=True)
    src = os.path.join(cuda_build.CSRC_DIR, "vocab.cu")
    ptxas_report(src)
    dev = torch.device("cuda:0")
    cuda_build.build_all(list(vk.KERNELS))
    before = Before(os.path.abspath(args.before)) if args.before else None
    rng = np.random.default_rng(15)
    res, profiles = {"card": info, "shapes": []}, []
    for label, sizes in (("level 0 of (d)", [4_000_000]), ("level 5 of (d)", rng.integers(1, 80, 99_907)),
                         ("level 2 of (b)", [651] * 100), ("level 5 of (b)", rng.integers(1, 41, 657))):
        out, profile = probe(label, sizes, dev, rng, before)
        res["shapes"].append(out)
        profiles.append((label, profile))
    if args.tree:
        res["tree"] = tree_turns(os.path.abspath(args.tree), args.tree_cpu)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)
    print(json.dumps(res), flush=True)
    for (label, profile), out in zip(profiles, res["shapes"]):
        for name, fn in profile:
            out[name]["kernels_ms"] = profiled(fn)
            print(f"{label}: {name} ms a kernel (torch.profiler) {out[name]['kernels_ms']}", flush=True)
    with open(args.out, "w") as f:
        json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
