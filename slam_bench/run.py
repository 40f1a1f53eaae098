"""The benchmark of orb_slam2_2021_tpu_torch: one run of one cell.

    python3 slam_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cards the cell asks for.
It renders the cell's traffic on the card from the seed, builds the System
of the cell's configuration, drives the warm-up frames, then measures for
`--seconds` seconds (see harness.py) and checks what the window produced
against the plain reference under slam_bench/reference/.

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer ones), `device`, with `--trace 1` `breakdown`,
and last `checks`, each compared number beside its limit. The facts that
define the cell's run come on standard error first, and each compared
number with its limit as the last lines there.

Exits non-zero without a result when no card (or too few) is present, and
when jax, jaxlib, flax or the JAX package is loaded once the window has
closed.
"""

import time

T_PROCESS0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description="one run of one cell of the SLAM benchmark")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    sys.path.insert(0, ROOT)
    from slam_bench import env

    env.set_process_env()
    from slam_bench import harness

    bench = harness.load_json(os.path.join(ROOT, "BENCHMARK.json"))
    chips = next((w["chips"] for w in bench["workloads"] if w["name"] == args.workload), None)
    if chips is None:
        harness.log(f"unknown workload {args.workload!r}")
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        harness.log(f"needs {chips} CUDA card(s); torch.cuda.is_available()={torch.cuda.is_available()}, "
                    f"device_count()={torch.cuda.device_count()}")
        return 2
    cell = harness.resolve_cell(args.workload, ROOT)
    card = harness.card_facts()
    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_PROCESS0)

    bad = harness.forbidden_modules()
    if bad:
        harness.log(f"loaded after the window: {', '.join(bad)}; no result")
        return 3

    facts = res["facts"]
    harness.log(f"cell {cell.name} seed {args.seed} seconds {args.seconds:g} trace {args.trace}")
    harness.log(f"card {card}")
    for k, v in facts.items():
        harness.log(f"fact {k} {v}")
    if res["trace"] is not None:
        harness.log(f"fact launches_by_thread {res['trace']['launches_by_thread']}")

    if args.trace:
        metrics = {k: {"value": v, "unit": cell.units[k]} for k, v in res["per_layer"].items()}
    else:
        metrics = {k: {"value": v, "unit": cell.units[k]} for k, v in res["e2e"].items()}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
              "memory_peak_bytes": int(res["memory_peak"])}
    out = {"correct": res["correct"], "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": device}
    if res["trace"] is not None:
        t = res["trace"]
        device["busy_s"], device["window_s"] = t["busy_s"], t["window_s"]
        out["breakdown"] = {"device_ops": t["device_ops"], "idle_gaps": t["idle_gaps"]}
    out["checks"] = res["check"]
    for k, c in res["check"].items():
        harness.log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
