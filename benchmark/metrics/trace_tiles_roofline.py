"""trace_tiles_roofline: the least device time of a call's trace_tiles work (roofline.py,
the work counted by the reference on the check's pixels and scaled to a
rank's call) over the profiler's device time of trace_tiles a traced call, in
percent. Nothing where trace_tiles did not run."""
from benchmark import roofline, trace


def read(ctx):
    s, work = ctx["summary"], ctx["work"]
    if not s or work is None:
        return None
    secs, n = trace.kernel_s(s, "trace_tiles_kernel")
    bound = roofline.call_bound_s("trace_tiles", work, ctx["scene"])
    if not n or bound is None:
        return None
    return 100.0 * bound / (secs / ctx["traced"]["calls"])
