"""Keyframes the lane queued for local mapping, per frame tracked in the
traced window: the work count that sets how much mapping runs beside the
lane."""


def read(ctx):
    return ctx.kf_inserted / ctx.frames if ctx.frames else None
