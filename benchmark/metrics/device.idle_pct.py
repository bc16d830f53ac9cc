"""device.idle_pct: the share of a call's wall time in which no kernel or
copy ran on rank 0's card: one minus the device's busy seconds a traced
call (the union of its kernels and copies in the trace) over the wall
seconds a call of the window (unprofiled: the profiler stretches the
traced calls' host side, above all each CUDA graph launch, so the traced
window itself reads idle high)."""


def read(ctx):
    s = ctx["summary"]
    if not s or s["busy_s"] <= 0:
        return None
    busy = s["busy_s"] / ctx["traced"]["calls"]
    return 100.0 * (1.0 - busy / (ctx["window_s"] / len(ctx["times"])))
