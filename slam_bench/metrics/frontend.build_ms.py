"""Mean ms of the frame build (`build_stereo_frame_from_u8` /
`build_rgbd_frame` as the System calls them), a span the benchmark wraps
around the call; in the traced run it ends after the lane's stream has
finished, so it is the build's device time plus its launches."""


def read(ctx):
    s = ctx.span_s.get("lane.build")
    return 1e3 * sum(s) / len(s) if s else None
