"""bounce_shade_roofline: the least device time of a call's bounce_shade
work over the profiler's device time of bounce_shade a traced call, in
percent. Nothing where bounce_shade did not run.

The work is the reference's (reference/paths.py, on the check's pixels,
scaled to a rank's call): its lane-bounces by branch, and its paths, each
of which retires once. FP32 instructions, counted from
csrc/bounce_kernel.cu's cpu-semantics shade of a meshless scene (built
with -fmad=false, so each multiply and add is one), each branch along its
shortest way: every live lane 22 (5 draws' scale, the isfinite test, the
point 6, the next origin 6, the DiffSpec compare, the radiance's 3 adds);
a sphere hit 18 more (its normal 15, the emission's 3 multiplies) and the
roulette's compare where it ends the path; a path that goes on 7 more
(weight / atten, ci's 6 multiplies) and its lobe: diffuse 56 (diff_dir),
mirror 23 (spec_dir), dielectric 46 (refract_dir along its total internal
reflection). Bytes, each once: a lane-bounce reads its flag (1), the hit
(t, kind, idx: 20) and the state (ro, rd, L, ci, inten, rng, bounce: 64),
and writes L, ci, inten, rng, active and bounce (41); a path that goes on
writes ro and rd (24); a retiring lane reads its unit and writes its slot
(20); the sphere columns (57 B a sphere) once a call."""
from benchmark import roofline, trace

LIVE, HIT, GOES_ON = 22, 18, 7
LOBE = {"diffuse": 56, "mirror": 23, "dielectric": 46}
OPS = {"miss": LIVE, "roulette": LIVE + HIT + 1,
       **{b: LIVE + HIT + GOES_ON + n for b, n in LOBE.items()}}
LANE_BYTES, GOES_ON_BYTES, RETIRE_BYTES, SPH_BYTES = 1 + 20 + 64 + 41, 24, 20, 57


def bound_s(work, scene):
    br = work["by_branch"]
    ops = sum(br[b] * n for b, n in OPS.items())
    nbytes = (work["lane_bounces"] * LANE_BYTES + sum(br[b] for b in LOBE) * GOES_ON_BYTES
              + work["paths"] * RETIRE_BYTES + scene["n_sph"] * SPH_BYTES)
    return roofline.bound_s(ops, nbytes)


def read(ctx):
    s, work = ctx["summary"], ctx["work"]
    if not s or work is None:
        return None
    secs, n = trace.kernel_s(s, "bounce_shade_kernel")
    if not n or not work["lane_bounces"]:
        return None
    return 100.0 * bound_s(work, ctx["scene"]) / (secs / ctx["traced"]["calls"])
