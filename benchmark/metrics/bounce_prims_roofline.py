"""bounce_prims_roofline: the least device time of a call's bounce_prims
work over the profiler's device time of bounce_prims a traced call, in
percent. Nothing where bounce_prims did not run.

The work is the reference's (reference/paths.py, on the check's pixels,
scaled to a rank's call): its lane-bounces, each the nearest hit over
every sphere of a live lane's ray. FP32 instructions, counted from
csrc/bounce_kernel.cu (built with -fmad=false, so each multiply and add is
one): a sphere's sphere_t, its guard and the running-best compare, 24 (oc
3, dirv 5, consts 7, disc 2, disc > 0 1, the square root 1, the two roots
2, the root's compares 1 along the shorter way, the guard 1, the best 1).
Bytes, each once: a lane-bounce reads its flag (1) and ray (24) and writes
the hit and the mesh seed (t, kind, idx, bu, bv, seed: 32); the sphere
columns (c, r: 16 B a sphere) once a call."""
from benchmark import roofline, trace

SPH_OPS = 24
LANE_BYTES = 1 + 24 + 32
SPH_BYTES = 16


def bound_s(work, scene):
    lb = work["lane_bounces"]
    return roofline.bound_s(lb * scene["n_sph"] * SPH_OPS,
                            lb * LANE_BYTES + scene["n_sph"] * SPH_BYTES)


def read(ctx):
    s, work = ctx["summary"], ctx["work"]
    if not s or work is None:
        return None
    secs, n = trace.kernel_s(s, "bounce_prims_kernel")
    if not n or not work["lane_bounces"]:
        return None
    return 100.0 * bound_s(work, ctx["scene"]) / (secs / ctx["traced"]["calls"])
