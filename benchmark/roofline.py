"""The yardstick of the kernels' rooflines: the H100's published peaks,
the FP32 instructions of each unit of work as counted from the kernels'
sources, and the bound of a call's work. The work itself is counted by
the reference (reference/paths.py: lane-bounces by hit kind, near sphere
roots, the mesh walk's slab and triangle tests), so that a change to a
kernel cannot change its own yardstick.

The bound is the larger of the FP32 instructions over 33.5 T/s (132 SMs
x 128 lanes x 1.98 GHz: 67 TFLOP/s with an FMA counted as two) and the
bytes (inputs read once, outputs written once) over 3.35 TB/s: NVIDIA's
data sheet for the H100 SXM at its 700 W limit. Loads, integer work and
branches are not counted, so each bound is low.
"""
from __future__ import annotations

FP32_INSTR = 33.5e12  # FP32 instructions/s
HBM = 3.35e12  # bytes/s

# a bounce of the mesh kernels (mesh_kernel.cu), in FP32 instructions
SLAB_OPS = 25  # slab_span (6 sub, 6 mul, 10 min/max) + 3 compares
TRI_OPS = 55  # tri_hit (53) + the t_min and running-best compares
SPH_OPS = 18  # one sphere: up to the disc > 0 test
SHADE_SPH_OPS = 93  # a sphere hit's shade, diffuse lobe (88) + 5 draws' conversion
SHADE_MESH_OPS = 204  # shade_mesh without a normal map (196) + 8 draws
# trace_tiles (trace_kernel.cu) under FMA contraction
SPH_INSTR = 13  # one sphere: oc 3, dirv 3, consts 4, disc 1, its two tests 2
ROOT_INSTR = 4  # a test that takes the near root: sqrt, -dirv - root, two compares
RAYGEN_INSTR = 20  # start_sample without a lens: 2 draws, jitter 4, direction 6, normalize 8
# shade by way (reference.paths.BRANCHES): a hit's point, normal, has_em and colour 18; a
# survivor's d.n, weight and next origin 7 and its lobe (diffuse 41, mirror 7, dielectric
# along its total internal reflection 10); the roulette's draw, test and add 8; a miss 3
SHADE_INSTR = {"miss": 3, "diffuse": 18 + 7 + 41, "mirror": 18 + 7 + 7,
               "dielectric": 18 + 7 + 10, "roulette": 18 + 2 + 6}
# the sky's fetch at a miss (csrc/cubemap.cuh sky_rgb, each operation an intrinsic rounded on
# its own) and its add, along the shortest way: the normalize 11 (3 FMUL, 2 FADD, the
# clamp's compare, the square root, 1 / n, 3 FMUL), the face 3 (|x| >= |y|, |x| >= |z|, the
# sign), su and sv 8 (FMUL, FDIV, the 0.5 FMUL and FADD each), the width and height to float
# 2, px and py 10 (FMUL, FMAX, FMIN, w - 1, its FMAX each), the texel's three components 6
# (to float, / 255), the add 6 (3 FMUL, 3 FADD); a missed path's record is SHADE_INSTR's.
# The faces' bytes are left out: read once, all 75.5 MB of a 2048^2 sky take 23 us, under 1% of
# the instructions' time of a call that fetches them
SKY_INSTR = 46


def bound_s(ops: float, nbytes: float) -> float:
    return max(ops / FP32_INSTR, nbytes / HBM)


def call_bound_s(kernel: str, work: dict, scene: dict) -> float | None:
    """The least seconds of a call's work for `kernel`: work from
    reference.paths (already scaled to the whole call; the shadow rays'
    walk tests are in `slab` and `tri`), scene: n_sph, pixels, table_bytes
    (the walk's tables and textures), dls_emitters (the spheres that
    direct-light sampling aims at; 0 without it). The fused kernels add
    SKY_INSTR for each of the sky's fetches (`sky_fetches`, by face); a
    scene without a sky has none, nor has a context built without the
    count (0 then)."""
    lb, br = work["lane_bounces"], work["by_branch"]
    walk = work["slab"] * SLAB_OPS + work["tri"] * TRI_OPS
    sky_ops = sum(work.get("sky_fetches", {}).values()) * SKY_INSTR
    if kernel == "trace_tiles":
        instr = (lb * scene["n_sph"] * SPH_INSTR + work["near_roots"] * ROOT_INSTR
                 + sum(br[b] * SHADE_INSTR[b] for b in SHADE_INSTR) + work["paths"] * RAYGEN_INSTR)
        return bound_s(instr + sky_ops, scene["n_sph"] * 60 + scene["pixels"] * 24)
    if kernel == "mesh_trace":
        sph_hits = sum(br[b] for b in ("diffuse", "mirror", "dielectric", "roulette"))
        ops = (lb * scene["n_sph"] * SPH_OPS + walk + br["mesh"] * SHADE_MESH_OPS
               + sph_hits * SHADE_SPH_OPS + br["miss"] * SHADE_INSTR["miss"]
               + work["paths"] * RAYGEN_INSTR)
        return bound_s(ops + sky_ops, scene["table_bytes"] + scene["pixels"] * 24)
    if kernel == "mesh_hit":
        return bound_s(walk, scene["table_bytes"] + lb * (7 * 4 + 4 * 4))
    return None
