"""Readings of the comparison's control and planted faults, on the card at
the cell's own size, with the sound runs' readings beside them. The
benchmark's runs do not run this; its readings set the limits in
limits/<cell>.json (PERF.md gives them).

    python3 slam_bench/control.py --workload <cell> --seeds 11,12,13 --seconds 10 \
        --what sound,tf32,unchanged,half,altered,depth_scaled [--out FILE]

`tf32` is the control: the program with the TF32 path switched on, the
nearest precision below the float32 (TF32 off) its configuration states;
the reference it is compared with still computes in float32. The others
are faults.py's. One process runs them all, one System after another, and
prints one JSON line each (also appended to --out).
"""

import time

T_PROCESS0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description="control and fault readings of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--what", default="sound,tf32,unchanged,half,altered,depth_scaled")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from slam_bench import env

    env.set_process_env()
    from slam_bench import faults, harness

    cell = harness.resolve_cell(args.workload, ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        for what in args.what.split(","):
            t0 = time.time()
            res = harness.run_cell(cell, seed, args.seconds, False, "cuda:0", t0,
                                   fault=faults.FAULTS.get(what), tf32=what == "tf32")
            line = {"workload": cell.name, "seed": seed, "what": what, "correct": res["correct"],
                    "numbers": {k: c["value"] for k, c in res["check"].items()},
                    "attempted": res["attempted"], "failed": res["failed"], "e2e": res["e2e"],
                    "wall_s": time.time() - t0}
            print(json.dumps(line), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(line) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
