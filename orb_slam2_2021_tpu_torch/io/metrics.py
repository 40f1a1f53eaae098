"""The port's own copy of orb_slam2_2021_tpu/io/metrics.py: plain Python and
numpy, the same behaviour.

Structured per-frame observability (SURVEY.md §5 metrics entry).

The reference's only metrics surface is std::cout prints plus per-run timing
medians (/root/reference/Examples/Stereo/arducam_images.cpp:144-187). This
module is the structured replacement: every tracked frame produces one flat
record — tracking state, match/inlier counts, map size, per-stage wall-clock
milliseconds — collected by System, publishable on the message bus
(`os2_metrics` topic, the analogue of the reference's ROS prints) and
dumpable as NDJSON for external analysis.

Schema is intentionally flat (one JSON object per line) so `jq`/pandas work
directly on the dump.
"""

from __future__ import annotations

import json
from typing import Iterable, List

# field -> type(s) accepted. This IS the schema; tests assert against it.
METRICS_SCHEMA = {
    "frame_id": int,
    "timestamp": float,
    "state": str,            # TrackState name: OK / LOST / NOT_INITIALIZED ...
    "n_matches": int,        # map-point bindings on the current frame
    "n_inliers": int,        # inliers of the final pose optimization
    "keyframe": bool,        # did this frame become a keyframe
    "n_keyframes": int,      # live KFs in the map after this frame
    "n_map_points": int,     # live map points after this frame
    "ms_extract": float,     # frame build (pyramid+FAST+BRIEF+stereo) dispatch
    "ms_track": float,       # tracking lane (motion/ref-KF/reloc + local map)
    "ms_mapping": float,     # inline mapping/grid work (0 in async mode)
    "ms_total": float,
}

STATE_NAMES = ("SYSTEM_NOT_READY", "NO_IMAGES_YET", "NOT_INITIALIZED", "OK", "LOST")


def validate_record(rec: dict) -> None:
    """Raise ValueError if `rec` does not conform to METRICS_SCHEMA."""
    missing = set(METRICS_SCHEMA) - set(rec)
    if missing:
        raise ValueError(f"metrics record missing fields: {sorted(missing)}")
    for key, typ in METRICS_SCHEMA.items():
        val = rec[key]
        if typ is float:
            if not isinstance(val, (int, float)) or isinstance(val, bool):
                raise ValueError(f"{key}: expected number, got {type(val).__name__}")
        elif not isinstance(val, typ):
            raise ValueError(f"{key}: expected {typ.__name__}, got {type(val).__name__}")
    if rec["state"] not in STATE_NAMES:
        raise ValueError(f"state: unknown value {rec['state']!r}")


def write_ndjson(path: str, records: Iterable[dict]) -> int:
    """Dump records one-JSON-object-per-line. Returns the record count."""
    n = 0
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec, sort_keys=True) + "\n")
            n += 1
    return n


def read_ndjson(path: str) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]
