"""One run of a benchmark cell with the port's span recorder on or off.

    python3 scripts/torch_trace_stages.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> --recorder <0|1> [--out stages.jsonl]

From the root of a checkout, on a machine with a CUDA card. It runs the
cell through `slam_bench.harness.run_cell`, as `slam_bench/run.py` does with
the same arguments, and with `--recorder 1` turns on
orb_slam2_2021_tpu_torch/io/trace.py's recorder: over the traced window with
`--trace 1` (beside the harness's torch.profiler), over the whole run
without. It prints one JSON line (appended to `--out` if given): the cell's
end-to-end metrics (untraced) or per-layer metrics (traced), `correct`, and
with a traced recorder `program`: the lane's and the worker's launches, host
ms and idle share by stage (innermost span), the lane's launch share inside
its spans, the clock offset's error bound, the longest idle gaps with the
harness's label refined by the program's spans, and the six readings of
`slam_bench/program_spans.readings`.

`--recorder 0 --trace 0` is a benchmark run; the recorder's cost is the
difference from `--recorder 1 --trace 0` on the same seed.
"""

from __future__ import annotations

import time

T_PROCESS0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOP_GAPS = 10


def main():
    ap = argparse.ArgumentParser(description="a benchmark cell with the span recorder on or off")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--recorder", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", help="a file to append the line to")
    args = ap.parse_args()

    sys.path.insert(0, REPO)
    from slam_bench import env

    env.set_process_env()
    import torch

    from orb_slam2_2021_tpu_torch.io import trace
    from slam_bench import harness, tracing

    if not torch.cuda.is_available():
        harness.log("needs a CUDA card")
        return 2
    cell = harness.resolve_cell(args.workload, REPO)
    program = {}

    if args.recorder and args.trace:
        start, stop, reduce = tracing.DeviceTrace.start, tracing.DeviceTrace.stop, tracing.DeviceTrace.reduce

        def traced_start(self):
            start(self)
            trace.start()

        def traced_stop(self):
            program["records"] = trace.stop()
            stop(self)

        def traced_reduce(self, probes):
            program.update(join(self, probes, program.pop("records")))
            return reduce(self, probes)

        tracing.DeviceTrace.start, tracing.DeviceTrace.stop = traced_start, traced_stop
        tracing.DeviceTrace.reduce = traced_reduce
    elif args.recorder:
        trace.start()
    res = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0", T_PROCESS0)
    rec = trace.stop()
    metrics = res["per_layer"] if args.trace else res["e2e"]
    out = {"workload": args.workload, "seed": args.seed, "trace": args.trace, "recorder": args.recorder,
           "card": harness.card_facts(), "correct": res["correct"], "metrics": metrics,
           "failed": res["failed"], "attempted": res["attempted"],
           "keyframes_inserted_in_window": res["facts"]["keyframes_inserted_in_window"]}
    if res["trace"] is not None:
        out["idle_share"] = 1.0 - res["trace"]["busy_s"] / res["trace"]["window_s"]
        out["idle_gaps"] = res["trace"]["idle_gaps"]
    if rec is not None:
        out["recorded_spans"] = len(rec.spans)
        out["untraced_stages"] = host_stages(rec, cell.traffic.warmup_frames)
    out["program"] = program
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


def host_stages(records, first_frame: int) -> dict:
    """Without the profiler: the lane's host ms a frame by innermost span
    over the frames from `first_frame` on, and the lane's lock wait a
    frame."""
    from slam_bench import program_spans

    lane = {t for t, _ in program_spans.thread_roles(records.spans)["lane"]}
    spans = [s for s in records.spans if s.tid in lane]
    frames = [s for s in spans if s.name == "frame" and s.key is not None and s.key >= first_frame]
    if not frames:
        return {}
    lo, hi = min(s.t0 for s in frames), max(s.t1 for s in frames)
    host = program_spans.Timeline(spans).time_by_innermost(lo, hi)
    n = len(frames)
    waits = [s for s in spans if s.name == "lock.wait" and lo <= s.t0 < hi]
    return {"frames": n, "frame_ms": 1e-6 * sum(s.t1 - s.t0 for s in frames) / n,
            "lock_wait_ms": 1e-6 * sum(s.t1 - s.t0 for s in waits) / n,
            "host_ms": {k: round(1e-6 * v / n, 3) for k, v in sorted(host.items(), key=lambda kv: -kv[1])}}


def join(dtrace, probes, records) -> dict:
    """The recorder's spans joined with the profiler's raw events of the
    traced window (slam_bench/program_spans.py)."""
    import torch

    from slam_bench import program_spans, tracing

    events = dtrace.prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    rows = [(e.name(), e.device_type() == cuda, e.start_ns(), e.duration_ns(), e.device_resource_id())
            for e in events]
    spans = program_spans.on_profiler_clock(records)
    lo, hi = dtrace.w0, dtrace.w1
    out = program_spans.analyse(spans, rows, lo, hi)
    off = dtrace.w0 - dtrace.t0            # the harness's own clock join
    gaps = sorted(out["gaps"], key=lambda g: g[0] - g[1])[:TOP_GAPS]
    lane, worker = out["lane"]["timeline"], out["worker"]["timeline"]
    roles = program_spans.thread_roles(spans)
    role_of = {t: r for r, pairs in roles.items() for pair in pairs for t in pair}
    labelled = []
    for a, b in gaps:
        mid = (a + b) // 2
        label = tracing.host_state(probes, mid - off)
        # the runtime calls in flight on the lane and the worker over the gap
        calls = sorted({(role_of[tid], name, round(d * 1e-6, 3)) for name, dev, t, d, tid in rows
                        if not dev and tid in role_of and t < b and t + d > a and d > 0.2 * (b - a)})
        labelled.append([program_spans.refine_label(label, lane.path_at(mid), worker.path_at(mid)),
                         (b - a) * 1e-9, calls])
    frames = max(out["frames"], 1)
    return {
        "frames": out["frames"], "keyframes": out["keyframes"],
        "readings": out["readings"],
        "lane_launch_share_in_spans": out["lane_launch_share_in_spans"],
        "lane_launches_in_spans_per_frame": (out["lane"]["n_launches"] - out["lane"]["launches"].get("-", 0))
        / frames,
        "offset_err_ns": records.offset_err_ns,
        "clock_offset_vs_harness_ns": records.offset_ns - off,
        "idle_share": out["idle_ns_total"] / out["window_ns"],
        "stages": {r: [[n, round(l, 2), round(h, 3), round(i, 4)] for n, l, h, i in
                       program_spans.stage_table(out, r)] for r in ("lane", "worker")},
        "launch_groups_per_frame": {g: n / frames for g, n in out["lane"]["launch_groups"].items()},
        "worker_launches_per_kf": ({g: n / out["keyframes"] for g, n in out["worker"]["launches"].items()}
                                   if out["keyframes"] else {}),
        "idle_gaps": labelled,
    }


if __name__ == "__main__":
    sys.exit(main())
