"""Device times of the two Hamming launchers on one CUDA card.

    python3 scripts/torch_probe_hamming.py [--before PATH/TO/hamming.cu]

Prints nvcc's register and spill report for csrc/hamming.cu. Then, at the
local-point search's shape (4096 x 2000) and triangulation's (one keyframe's
2000 features against T = 10 keyframes of 2000), times hamming_matrix and
hamming_best2 by chip_smoke.device_ms (CUDA events around calls queued
behind a sleep, so the host's launch cost is hidden) and by torch.profiler's
per-kernel device times, beside the bound (chip_smoke.matrix_bound /
best2_bound), and times hamming_best2 at several column-slicing targets.

`--before` names another hamming.cu with the same `hamming_matrix_launch`
(for instance an earlier commit's, unpacked with `git archive` into a
directory that .gitignore lists). Its matrix launcher is held against the
plain version and timed by the same device_ms beside the package's, in turns
(before, package, package, before; better of two each), at 4096 x 2000 and
2000 x 20000. Prints the card's name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

import chip_smoke as cs  # noqa: E402
from orb_slam2_2021_tpu_torch.ops import cuda_build  # noqa: E402
from orb_slam2_2021_tpu_torch.ops import hamming as H  # noqa: E402


def ptxas_report():
    src = os.path.join(cuda_build.CSRC_DIR, "hamming.cu")
    cmd = [cuda_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
           "-Xptxas", "-v", "-cubin", "-o", os.devnull, src]
    res = subprocess.run(cmd, capture_output=True, text=True)
    for line in (res.stdout + res.stderr).splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"  {line.strip()[:150]}", flush=True)


def profiled(fn, iters=20):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return [(ev.key[:48], ev.count, ev.device_time_total / ev.count)
            for ev in prof.key_averages()
            if ev.device_type == torch.autograd.DeviceType.CUDA and ev.count]


def report(label, fn, bound):
    ms = cs.device_ms(fn, iters=50)
    b, by = bound
    kernels = ", ".join(f"{k} {c}x {us:.2f} us" for k, c, us in profiled(fn))
    print(f"{label}: {ms * 1e3:.2f} us device; bound {b * 1e3:.2f} us by {by} "
          f"({100 * b / ms:.0f}% of bound); profiler: {kernels}", flush=True)


def compare_before(source, dev):
    """The matrix launcher of `source` against the package's, by device_ms in
    turns, at the two shapes of the kernel table."""
    before = cuda_build.CudaKernel(os.path.abspath(source), "hamming_matrix_launch",
                                   H.HAMMING_KERNEL.argtypes)
    now = H.HAMMING_KERNEL
    rng = np.random.default_rng(3)
    for n, m in ((4096, 2000), (2000, 20000)):
        a, b, _ = cs.hamming_inputs(rng, n, m, None, cs.LANE_MASK_DENSITY, dev)
        ref = H.hamming_matrix_plain(a, b)

        def timed(kernel):
            H.HAMMING_KERNEL = kernel
            try:
                if not torch.equal(H.hamming_matrix(a, b), ref):
                    raise AssertionError(f"{kernel.source} disagrees with the plain version at {n}x{m}")
                return cs.device_ms(lambda: H.hamming_matrix(a, b), iters=50)
            finally:
                H.HAMMING_KERNEL = now

        t = [timed(k) for k in (before, now, now, before)]
        bound, by = cs.matrix_bound(n, m)
        t_before, t_now = min(t[0], t[3]), min(t[1], t[2])
        print(f"matrix {n}x{m}: before ({source}) {t_before * 1e3:.2f} us "
              f"({100 * bound / t_before:.0f}% of bound), package {t_now * 1e3:.2f} us "
              f"({100 * bound / t_now:.0f}% of bound); bound {bound * 1e3:.2f} us by {by}; "
              f"all runs {[round(x * 1e3, 2) for x in t]} us; both == plain", flush=True)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--before", help="another hamming.cu whose matrix launcher is timed beside")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    dev = torch.device("cuda:0")
    print(cs.card_info(), flush=True)
    ptxas_report()

    rng = np.random.default_rng(0)
    cases = [("4096x2000", cs.hamming_inputs(rng, 4096, 2000, None, cs.LANE_MASK_DENSITY, dev)),
             ("T=10 2000x2000", cs.hamming_inputs(rng, 2000, 2000, 10, cs.MAPPING_MASK_DENSITY, dev))]
    for label, (a, b, mask) in cases:
        bf = b.reshape(-1, 8)
        T, m = (1, b.shape[0]) if b.dim() == 2 else (b.shape[0], b.shape[1])
        n = a.shape[0]
        mb, bb = cs.matrix_bound(n, T * m), cs.best2_bound(n, m, T)
        mat, ref = H.hamming_matrix(a, bf), H.hamming_matrix_plain(a, bf)
        got, want = H.hamming_best2(a, b, mask), H.hamming_best2_plain(a, b, mask)
        same = torch.equal(mat, ref) and all(torch.equal(x, y) for x, y in zip(got, want))
        print(f"{label}: both launchers == plain: {same}", flush=True)
        if not same:
            raise SystemExit(f"a launcher disagrees with its plain version at {label}")
        report(f"{label} matrix {n}x{T * m}", lambda: H.hamming_matrix(a, bf), mb)
        for per_sm in (2, 4, 8, 16):
            H._BEST2_BLOCKS_PER_SM = per_sm
            report(f"{label} best2, {per_sm} blocks per SM aimed at "
                   f"({H._best2_slices(n, m, T, dev)} slices)", lambda: H.hamming_best2(a, b, mask), bb)
        H._BEST2_BLOCKS_PER_SM = 4
    if args.before:
        compare_before(args.before, dev)


if __name__ == "__main__":
    main()
