"""Share of the traced window in which no operation ran on the card: 1 -
(union of the device's kernel, copy and set intervals / the window), in %."""


def read(ctx):
    t = ctx.trace
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
