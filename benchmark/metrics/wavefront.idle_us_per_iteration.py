"""wavefront.idle_us_per_iteration: the device's idle time a call over the
wavefront's iterations a call, in microseconds: the median wall seconds
of a window call, less the device's busy seconds a traced call (the union
of its kernels and copies), over the traced calls' iterations a call
(Renderer.stats["iterations"]). The wall time is the unprofiled window's,
as in device.idle_pct: the profiler stretches each graph launch of the
traced calls. Nothing where no wavefront iteration ran."""
import numpy as np


def read(ctx):
    s, traced = ctx["summary"], ctx["traced"]
    if not s or s["busy_s"] <= 0 or not traced.get("iterations"):
        return None
    calls = traced["calls"]
    idle = float(np.median(ctx["times"])) - s["busy_s"] / calls
    return 1e6 * idle / (traced["iterations"] / calls)
