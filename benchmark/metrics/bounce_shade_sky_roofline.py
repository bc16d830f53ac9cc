"""bounce_shade_sky_roofline: the least device time of a call's bounce_shade
work in a scene with a sky over the profiler's device time of bounce_shade
a traced call, in percent. Nothing where bounce_shade did not run or the
work fetched no sky.

The work is the reference's (reference/paths.py, on the check's pixels,
scaled to a rank's call): its lane-bounces by branch (the mesh's among
them), its paths and its sky fetches. The meshless branches and bytes are
bounce_shade_roofline's (its constants). FP32 instructions added here,
counted from csrc/bounce_kernel.cu's cpu-semantics shade (built with
-fmad=false, so each multiply and add is one), each along its shortest
way:
- in a mesh scene (scene["table_bytes"] > 0) every live lane draws 8
  numbers, not 5: 3 more draws' scale;
- a mesh hit, counted as a path that goes on (the reference does not
  split the roulette's end from it): the live lane's 22, the attributes
  23 (mesh_common.cuh's mesh_attrs without a normal map or textures: b0
  2, the normal-map test 1, the base colour's and metal-rough's uv
  interpolations 10 each, before each fetch's width test), the emission's
  3 multiplies, the PBR divert 124 (spec_dir 23, diff_dir 56, r0 2, the
  Fresnel term 12, the lobe's compare 2, the scatter's normalize 12, its
  add 6, the normalize 11) and the throughput's 7;
- each sky fetch, roofline.SKY_INSTR.
Bytes, each once, added to the meshless ones: in a mesh scene every live
lane reads the mesh hit's gid (4) and a mesh hit its t, u, v (12) and
writes ro and rd where it goes on (24); the triangles' attribute rows and
descriptors are left out (read once a call, 7,300 x 228 B take 0.5 us);
every lane-bounce writes the miss record (miss_d, miss_w: 24), which each
fetch reads back (24); the faces' bytes are left out, as roofline.py
leaves them out. No direct-light sampling terms: the cells this reads
have none."""
from benchmark import roofline, trace
from benchmark.metrics import bounce_shade_roofline as plain

MESH_DRAW_OPS = 3
MESH_OPS = plain.LIVE + 23 + 3 + 124 + plain.GOES_ON
MGID_BYTES, MESH_HIT_BYTES, MISS_BYTES = 4, 12, 24


def bound_s(work, scene):
    br, lb = work["by_branch"], work["lane_bounces"]
    fetches = sum(work["sky_fetches"].values())
    mesh_scene = scene["table_bytes"] > 0
    ops = (sum(br[b] * n for b, n in plain.OPS.items()) + br["mesh"] * MESH_OPS
           + lb * MESH_DRAW_OPS * mesh_scene + fetches * roofline.SKY_INSTR)
    nbytes = (lb * (plain.LANE_BYTES + MISS_BYTES + MGID_BYTES * mesh_scene)
              + (sum(br[b] for b in plain.LOBE) + br["mesh"]) * plain.GOES_ON_BYTES
              + br["mesh"] * MESH_HIT_BYTES + work["paths"] * plain.RETIRE_BYTES
              + scene["n_sph"] * plain.SPH_BYTES + fetches * MISS_BYTES)
    return roofline.bound_s(ops, nbytes)


def read(ctx):
    s, work = ctx["summary"], ctx["work"]
    if not s or work is None or not sum(work.get("sky_fetches", {}).values()):
        return None
    secs, n = trace.kernel_s(s, "bounce_shade_kernel")
    if not n:
        return None
    return 100.0 * bound_s(work, ctx["scene"]) / (secs / ctx["traced"]["calls"])
