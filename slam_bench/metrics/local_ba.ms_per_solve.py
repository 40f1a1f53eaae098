"""Mean ms of the complete local-BA solves (both LM phases run) finished
in the window, from the port's own record (`LocalMapping.ba_solve_times`:
host seconds from the upload of the problem to the readback of its
result). Solves that a newly inserted keyframe cut short are left out;
each run counts them apart on standard error."""


def read(ctx):
    s = ctx.ba_solve_s
    return 1e3 * sum(s) / len(s) if s else None
