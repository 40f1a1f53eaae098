"""Mean ms of local mapping's per-keyframe pipeline (`LocalMapping._process`
on the mapping worker: culling, triangulation and fusion, local BA,
keyframe culling, loop detection, the grid), over the keyframes it finished
in the traced window."""


def read(ctx):
    s = ctx.span_s.get("mapping.kf")
    return 1e3 * sum(s) / len(s) if s else None
