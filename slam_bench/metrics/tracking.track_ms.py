"""Mean ms of the tracker's call (`Tracking.track_stereo_frame`) per frame,
a span the benchmark wraps around it; it ends in the pose's readback."""


def read(ctx):
    s = ctx.span_s.get("lane.track")
    return 1e3 * sum(s) / len(s) if s else None
