"""CUDA launch API calls (cudaLaunchKernel, cuLaunchKernel and their Ex
forms; a graph launch counts once) made on the lane's thread, per frame
tracked in the traced window. Profiler CPU events. A count: a graph replay
lowers it where a kernel count would not."""


def read(ctx):
    t = ctx.trace
    if not t or not ctx.frames or not t["lane_launches"]:
        return None
    return t["lane_launches"] / ctx.frames
