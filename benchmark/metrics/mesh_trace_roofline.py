"""mesh_trace_roofline: the least device time of a call's mesh_trace work (roofline.py,
the work counted by the reference on the check's pixels and scaled to a
rank's call) over the profiler's device time of mesh_trace a traced call, in
percent. Nothing where mesh_trace did not run."""
from benchmark import roofline, trace


def read(ctx):
    s, work = ctx["summary"], ctx["work"]
    if not s or work is None:
        return None
    secs, n = trace.kernel_s(s, "mesh_trace_kernel")
    bound = roofline.call_bound_s("mesh_trace", work, ctx["scene"])
    if not n or bound is None:
        return None
    return 100.0 * bound / (secs / ctx["traced"]["calls"])
