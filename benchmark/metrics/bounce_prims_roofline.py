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
columns (c, r: 16 B a sphere) once a call.

With direct-light sampling the launches in shadow mode, one an emitter
(scene["dls_emitters"]), need from a live lane only its pending flag (1,
read once); from a lane-bounce that carries a pending hit
(work["dls_pending"]) the hit (pos, norm, self: 32) and this bounce's
kind and idx (16), read once, and for each emitter the shadow ray, 21
(the direction 3, its normalize 12, light_dot 5, light_dot > 0 1),
written with its seed and flag (17); a ray that is cast
(work["shadow_rays"]) then tests every sphere as above. The kernel forms
a ray on every lane of the pool; the bound counts the lanes that need
one. Without direct-light sampling each of these counts is 0 (and absent
from a context built without them), so the bound is the plain one."""
from benchmark import roofline, trace

SPH_OPS = 24
LANE_BYTES = 1 + 24 + 32
SPH_BYTES = 16
SHADOW_OPS = 3 + 12 + 5 + 1
LIVE_FLAG_BYTES, PEND_BYTES, RAY_BYTES = 1, 32 + 16, 12 + 4 + 1


def bound_s(work, scene):
    lb, n_sph = work["lane_bounces"], scene["n_sph"]
    n_emit, pend = scene.get("dls_emitters", 0), work.get("dls_pending", 0)
    ops = (lb * n_sph * SPH_OPS + pend * n_emit * SHADOW_OPS
           + work.get("shadow_rays", 0) * n_sph * SPH_OPS)
    nbytes = (lb * LANE_BYTES + n_sph * SPH_BYTES + lb * min(n_emit, 1) * LIVE_FLAG_BYTES
              + pend * (PEND_BYTES + n_emit * RAY_BYTES))
    return roofline.bound_s(ops, nbytes)


def read(ctx):
    s, work = ctx["summary"], ctx["work"]
    if not s or work is None:
        return None
    secs, n = trace.kernel_s(s, "bounce_prims_kernel")
    if not n or not work["lane_bounces"]:
        return None
    return 100.0 * bound_s(work, ctx["scene"]) / (secs / ctx["traced"]["calls"])
