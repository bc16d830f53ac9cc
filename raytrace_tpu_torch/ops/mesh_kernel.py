"""The path-tracing kernel for mesh scenes: the gpu-semantics path of
every lane over spheres, free triangles and one glTF mesh.

Port of `raytrace_tpu/ops/pallas/mesh_bounce_kernel.py::bounce_tiles`
(:698, body :94) together with the XLA half of its driver,
`raytrace_tpu/render/fused_mesh._mesh_shade` (:184-271): on the TPU the
kernel cannot gather a mesh hit's attributes and texels, so it leaves
mesh-hit lanes pending for fused_mesh.py; here one call finishes every
bounce of every lane itself. Per lane: counter-RNG seed, camera raygen,
closest hit over <= 64 spheres, <= 64 free triangles and the mesh,
shading of either kind, Russian roulette, and in place regeneration of
`samples_per_lane` consecutive sample ids. It returns the lane's
radiance sum. With a cube map (`MeshTables.sky`), a live lane that hits
nothing adds (throughput * inten) * sky(direction) there, the term the
JAX driver adds per bounce from the kernel's miss records
(fused_mesh.py:343-353); the entries then run their sky instantiations,
counted as `mesh_trace_sky` and `mesh_trace_brute_sky` in LAUNCHES. With
generator="pcg" they run their pcg instantiations (`<entry>_pcg`, with
the sky `<entry>_sky_pcg`), whose draws are the reference's generator
(ops/rng.py), in the same count and order. The
pend protocol, the lane queue, fast2 and the `RTPU_*` knobs are not
ported (ROADMAP, "Not to port").

The mesh nearest hit has two routes, each its own CUDA entry point in
`csrc/mesh_kernel.cu`; in both a path stays with its thread and the
nearest hits of a warp's live rays are found by groups of its threads:
- "walk" (`mesh_trace`, replacing the cluster walk `mesh_walk`,
  :375-479): a 3-level slab walk (supergroup, supercluster, cluster)
  over the tables of `pack_mesh_tables`, pruned by `entry < t_best`,
  exact-t ties to the least scan position;
- "brute" (`mesh_trace_brute`, replacing `woop.mxu_mesh_hit`,
  woop.py:268): every triangle of the brute table, in f32
  Moller-Trumbore, ties to the least row, the table resident in shared
  memory. MeshTables takes it for meshes of at most MAX_BRUTE_TRIS
  triangles;
- "instanced" (`mesh_trace_instanced`, replacing bounce_tiles'
  two-level instancing, `inst_body` :500-544): for a scene of n_inst
  copies of one asset (models/scene.py builds the instance table and the
  asset's local clusters), each instance of the table in its front-to-back
  order: its world AABB's slab test under the running best, the ray moved
  into the instance's frame (o' = A (o - T), d' = A d, d' not normalized,
  so a local t is the world t), the walk over the asset's local tables
  seeded with the running best, the instance's gid base added. Exact-t
  ties go to the least scan position inside an instance and to the
  earlier instance across instances (the kernel visits the reached
  instances nearest entry first and keeps that result). Brute and instanced exclude each
  other, as in the JAX package: route "brute" on an instanced scene takes
  the flattened brute table. MeshTables takes it for every instanced
  scene when INSTANCED_ROUTE is set; its first design,
  `mesh_trace_instanced_first`, is chip_smoke.py's yardstick.

The gate, MAX_BRUTE_TRIS, is measured on the card, not copied from the
JAX package's 2,560 (woop.MAX_TRIS, where the MXU made the brute pass
cheap): `chip_smoke.py` times both routes on the whole 1216x608 frame at
16 samples per lane over cuts of the procedural surface (256, 512, 1,024,
2,097 and 2,560 triangles, a380 camera). On an NVIDIA H100 80GB HBM3 at
700 W the walk was faster at every cut, 9.6 ms against 11.1 at 256
triangles and 30.7 against 164.1 at 2,097 (PERF.md): an FP32 brute
pass tests all 2,112 rows of that table at every lane-bounce, and even
its bound (85 ms at 2,097 triangles) is above the walk's time. So the gate is 0 and every mesh takes the walk; the brute route
stays an entry point that a caller can ask for by `route="brute"`.

Draws: 8 uniforms per bounce for EVERY lane of a mesh scene, u0..u7
(integrator.py:862-869). Mesh hits use u0 (lobe), u1 u2 (diffuse),
u4 u5 u6 (roughness scatter), u7 (RR); u3 is drawn and unused.
Sphere / free-triangle hits use u0-u3 in `uniform_bsdf` and u7.

Two normalizes, as in the JAX package: raygen and regeneration use
rsqrt (`raygen.norm3`, fused_mesh._generate_rsqrt), the mesh shade uses
sqrt then divide with an eps of 1e-20 where the JAX code has one
(ops/vec.normalize).

- On a CUDA tensor, `mesh_trace` launches the CUDA kernel or raises.
- On a CPU tensor, it runs `mesh_trace_reference`, the plain torch
  version of the same function, which the CPU tests hold against the
  JAX package and `chip_smoke.py` holds the kernel against.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch
from torch import nn

from . import cubemap, raygen, rng
from .raygen import normalize
from .bsdf import uniform_bsdf
from .intersect import EPS, INF, closest_sph_ft, triangle_tuv
from .texture import pool_tensor, sample_nearest, take
from .trace_kernel import (CAM_LEN, FT_COLS, MAX_PRIMS, SPH_COLS, launch_key, make_cam_vec,
                           pack_scene_tables)

MAX_BRUTE_TRIS = 0  # brute route up to this many triangles: none (see the docstring)
# Instanced scenes take the per-instance walk when set: it measured faster
# than the flattened walk on both fleets (procedural.fleet_scheme, 1216x608,
# 16 spl; scripts/torch_instanced_variants.py --large on an NVIDIA H100 80GB
# HBM3, 700.00 W, in turns; chip_smoke.py phase 13 times the same three):
# the fleet 113.611 ms a launch, against 130.844 for its first design
# (mesh_trace_instanced_first) and 117.622 for the walk; the large fleet
# (FLEET_LARGE_ROWS, flattened tables 64 MB, over the L2) 145.016, 170.025
# and 246.002. The asset's size sets no limit.
INSTANCED_ROUTE = True
GROUP = 16  # clusters per supercluster
SGROUP = 8  # superclusters per supergroup
TRI_COLS = 12  # v0 xyz | e1 xyz | e2 xyz | 3 zero: three float4 loads a triangle
BRUTE_CHUNK = 64  # the brute table's rows are padded to a multiple of this
ROUTES = {"walk": "mesh_trace", "brute": "mesh_trace_brute", "instanced": "mesh_trace_instanced"}
INST_COLS = 24  # the instance table's row: A (9) | T (3) | world AABB lo, hi (6) | gid base | 0
# the first design of each route's entry, kept as the yardstick chip_smoke.py
# times it against (a thread walks its own ray in the camera's scan order;
# the block stages 64-row chunks in lockstep; the group's instance state and
# the lane's path state in registers); no render launches them
YARDSTICKS = {"walk": "mesh_trace_per_thread", "brute": "mesh_trace_brute_lockstep",
              "instanced": "mesh_trace_instanced_first"}
_NOHIT_LO, _NOHIT_HI = 3.0e38, -3.0e38  # inverted AABB of padding clusters (the
# JAX layout; the slab test does not retire it, the walks skip count-0 clusters)

# launches of each CUDA entry point in this process (read by chip_smoke.py)
LAUNCHES = {"mesh_trace": 0, "mesh_trace_brute": 0, "mesh_trace_sky": 0,
            "mesh_trace_brute_sky": 0, "mesh_trace_pcg": 0, "mesh_trace_brute_pcg": 0,
            "mesh_trace_sky_pcg": 0, "mesh_trace_brute_sky_pcg": 0, "mesh_trace_instanced": 0,
            "mesh_trace_instanced_sky": 0, "mesh_trace_instanced_pcg": 0,
            "mesh_trace_instanced_sky_pcg": 0, "mesh_hit": 0, "mesh_hit_per_thread": 0,
            "mesh_trace_per_thread": 0, "mesh_trace_brute_lockstep": 0,
            "mesh_trace_instanced_first": 0}


# --- host-side packing -----------------------------------------------------


def pack_mesh_tables(cl_idx, cl_lo, cl_hi, cl_v0, cl_e1, cl_e2, cam_o):
    """Cluster arrays -> the walk's tables, numpy, in the JAX packer's
    layout and order (`pack_mesh_tables_np`, mesh_hit_kernel.py:192-265):
    C padded to a GROUP * SGROUP multiple Cp, padding and empty clusters
    with inverted AABBs, and the camera-ordered front-to-back
    permutation (clusters within their supercluster, superclusters
    within their supergroup, supergroups globally, by distance from
    cam_o to the AABB). The permutation is the scan order, and exact-t
    ties go to the earlier triangle in it.

    Returns dict: bounds (Cp, 8), sbounds (Cp/GROUP, 8), sgbounds
    (Cp/GROUP/SGROUP, 8) f32 [lo xyz, hi xyz, 0, 0]; tri (Cp, W, 12)
    f32; gid (Cp, W) int32 mesh-triangle ids, -1 padding (ids stay
    integers: stored as f32 bit patterns they flushed to denormals once);
    count (Cp,) int32 valid rows, which lead each cluster's row."""
    cl_idx = np.asarray(cl_idx)
    C, W = cl_idx.shape
    if W % 8:
        raise ValueError(f"cluster width {W} is not a multiple of 8")
    valid = cl_idx >= 0
    count = valid.sum(axis=1)
    if not (valid == (np.arange(W)[None, :] < count[:, None])).all():
        raise ValueError("cluster rows must hold their triangles first, then -1 padding")
    granule = GROUP * SGROUP
    Cp = -(-max(C, 1) // granule) * granule
    lo = np.full((Cp, 3), _NOHIT_LO, np.float32)
    hi = np.full((Cp, 3), _NOHIT_HI, np.float32)
    nonempty = count > 0
    lo[:C][nonempty] = np.asarray(cl_lo)[nonempty]
    hi[:C][nonempty] = np.asarray(cl_hi)[nonempty]
    tri = np.zeros((Cp, W, TRI_COLS), np.float32)
    tri[:C, :, 0:3] = cl_v0
    tri[:C, :, 3:6] = cl_e1
    tri[:C, :, 6:9] = cl_e2
    gid = np.full((Cp, W), -1, np.int32)
    gid[:C] = cl_idx
    cnt = np.zeros((Cp,), np.int32)
    cnt[:C] = count

    if C:
        cam = np.asarray(cam_o, np.float32).reshape(1, 3)
        ok = lo[:, 0] <= hi[:, 0]
        d = np.full((Cp,), np.inf, np.float32)
        d[ok] = np.linalg.norm(np.clip(cam, lo[ok], hi[ok]) - cam, axis=1)
        S = Cp // GROUP
        dg = d.reshape(S, GROUP)
        within = np.argsort(dg, axis=1, kind="stable")
        dsg = dg.min(axis=1).reshape(S // SGROUP, SGROUP)
        within_s = np.argsort(dsg, axis=1, kind="stable")
        sg_order = np.argsort(dsg.min(axis=1), kind="stable")
        sperm = (sg_order[:, None] * SGROUP + within_s[sg_order]).reshape(-1)
        perm = (sperm[:, None] * GROUP + within[sperm]).reshape(-1)
        lo, hi, tri, gid, cnt = lo[perm], hi[perm], tri[perm], gid[perm], cnt[perm]

    def boxes(a, b):
        return np.concatenate([a, b, np.zeros((a.shape[0], 2), np.float32)], axis=1)

    S = Cp // GROUP
    slo, shi = lo.reshape(S, GROUP, 3).min(axis=1), hi.reshape(S, GROUP, 3).max(axis=1)
    sglo = slo.reshape(S // SGROUP, SGROUP, 3).min(axis=1)
    sghi = shi.reshape(S // SGROUP, SGROUP, 3).max(axis=1)
    return dict(bounds=boxes(lo, hi), sbounds=boxes(slo, shi), sgbounds=boxes(sglo, sghi),
                tri=tri, gid=gid, count=cnt)


def pack_brute_table(cl_idx, cl_v0, cl_e1, cl_e2):
    """The brute route's rows: every triangle once, in the clusters'
    (unpermuted) scan order, padded to a BRUTE_CHUNK multiple with gid
    -1. Returns (tri (Mb, 12) f32, gid (Mb,) int32)."""
    valid = np.asarray(cl_idx) >= 0
    M = int(valid.sum())
    Mb = -(-max(M, 1) // BRUTE_CHUNK) * BRUTE_CHUNK
    tri = np.zeros((Mb, TRI_COLS), np.float32)
    tri[:M, 0:3] = np.asarray(cl_v0)[valid]
    tri[:M, 3:6] = np.asarray(cl_e1)[valid]
    tri[:M, 6:9] = np.asarray(cl_e2)[valid]
    gid = np.full((Mb,), -1, np.int32)
    gid[:M] = np.asarray(cl_idx)[valid]
    return tri, gid


def supports(scene, params) -> bool:
    """The scenes the mesh path kernel takes: gpu semantics, a mesh with
    clusters, and <= 64 spheres and free triangles, with or without a
    cube map. The JAX package's fused_mesh.supports
    (:169-181) also refuses `dir_light_samp`; this gate does not, so a
    gpu-semantics mesh scene with direct-light sampling renders here
    through `mesh_trace`, where the JAX Renderer takes its wavefront.
    Both render the same image: direct-light sampling runs in cpu
    semantics only (integrator.uses_dls; the JAX integrator.py:920), and
    the mesh kernel is the faster driver
    (tests/test_torch_mesh_renderer.py holds the two under the tile
    gate). Either generator (the kernel has an instantiation of each).
    Not a differentiable render: the kernel has no backward."""
    return (
        params.mode == "gpu"
        and not params.debug_single_ray
        and not params.differentiable
        and scene.n_mesh_tris > 0
        and scene.n_clusters > 0
        and scene.n_spheres <= MAX_PRIMS
        and scene.n_free_tris <= MAX_PRIMS
    )


class WalkTables(nn.Module):
    """The walk's tables of `pack_mesh_tables` as buffers: sgbounds,
    sbounds, bounds, tri, gid, count."""

    def __init__(self, packed: dict):
        super().__init__()
        for k in ("sgbounds", "sbounds", "bounds", "tri", "gid", "count"):
            self.register_buffer(k, torch.from_numpy(np.ascontiguousarray(packed[k])))


class MeshTables(nn.Module):
    """A mesh scene's packed tables and camera as buffers, moved with
    `.to(device)`; `sky` the cube map's SkyTables (None without one).
    An instanced scene (scene.n_inst > 0) also has `inst`, its (n_inst,
    24) instance table ((0, 24) otherwise), and `asset`, the WalkTables
    of the asset's local clusters, packed in the camera's order as seen
    from instance 0's frame (None otherwise); the flattened tables stay
    beside them. `route` is the nearest-hit route the scene takes:
    instanced for an instanced scene (INSTANCED_ROUTE), else brute up to
    MAX_BRUTE_TRIS triangles and the walk above."""

    def __init__(self, scene, cam, max_thres: float):
        super().__init__()
        if not scene.n_mesh_tris:
            raise ValueError("MeshTables needs a scene with a mesh")
        self.sky = cubemap.SkyTables(scene) if scene.has_cubemap else None
        sph, ft = pack_scene_tables(scene)
        walk = pack_mesh_tables(scene.cl_idx, scene.cl_lo, scene.cl_hi, scene.cl_v0,
                                scene.cl_e1, scene.cl_e2, cam_o=cam.o)
        btri, bgid = pack_brute_table(scene.cl_idx, scene.cl_v0, scene.cl_e1, scene.cl_e2)
        pool, self.pool_kind = pool_tensor(scene.tex_pool)
        arrays = dict(sph=sph, ft=ft, cam_vec=make_cam_vec(cam, max_thres), **walk,
                      btri=btri, bgid=bgid, attr=scene.mt_attr, desc=scene.mt_desc)
        self.n_inst = int(scene.n_inst)
        inst = np.asarray(scene.mk_inst, np.float32)[:self.n_inst]
        for k, a in dict(arrays, inst=inst.reshape(-1, INST_COLS)).items():
            self.register_buffer(k, torch.from_numpy(np.ascontiguousarray(a)))
        self.register_buffer("pool", pool)
        self.asset = None
        if self.n_inst:
            # the camera in instance 0's frame (the row of gid base 0), so that
            # the local scan order is the camera's (scene.py:459-463)
            row = inst[int(np.argmin(inst[:, 18]))].astype(np.float64)
            cam_l = (np.asarray(cam.o, np.float64) - row[9:12]) @ row[0:9].reshape(3, 3).T
            self.asset = WalkTables(pack_mesh_tables(
                scene.inst_cl_idx, scene.inst_cl_lo, scene.inst_cl_hi, scene.inst_cl_v0,
                scene.inst_cl_e1, scene.inst_cl_e2, cam_o=cam_l.astype(np.float32)))
        self.n_sph = int(scene.n_spheres)
        self.n_ft = int(scene.n_free_tris)
        self.n_tris = int(scene.n_mesh_tris)
        self.has_lens = cam.lens_r is not None
        self.route = ("instanced" if self.n_inst and INSTANCED_ROUTE
                      else "brute" if self.n_tris <= MAX_BRUTE_TRIS else "walk")


# --- the plain torch version -----------------------------------------------

def _chunks(dev):
    """(slab or triangle tests per chunk, (lane, cluster) pairs per chunk
    of the walk's triangle tests): larger on the card, where a chunk's
    elementwise kernels are cheap and their launches dominate."""
    return (1 << 20, 1 << 14) if dev.type == "cpu" else (1 << 24, 1 << 18)


def _slab_clamp(d):
    """|d| < EPS -> +-EPS (the reference's aabb.rs:33-35)."""
    return torch.where(torch.abs(d) < EPS, torch.where(d < 0.0, -EPS, EPS), d)


def _reach(o, f, t_best, lane, box):
    """Slab test of the lanes `lane` against the (P, 8) boxes `box`:
    (entry <= exit) & (exit >= 0) & (entry < t_best)."""
    t0 = [(box[:, k] - o[k][lane]) * f[k][lane] for k in range(3)]
    t1 = [(box[:, 3 + k] - o[k][lane]) * f[k][lane] for k in range(3)]
    mn = [torch.minimum(a, b) for a, b in zip(t0, t1)]
    mx = [torch.maximum(a, b) for a, b in zip(t0, t1)]
    entry = torch.maximum(torch.maximum(mn[0], mn[1]), mn[2])
    exit_ = torch.minimum(torch.minimum(mx[0], mx[1]), mx[2])
    return (entry <= exit_) & (exit_ >= 0.0) & (entry < t_best[lane])


def _descend(o, f, t_best, lane, node, fanout, boxes):
    """(lane, parent) pairs -> the (lane, child) pairs whose slab test
    reaches the child, children parent * fanout + 0 .. fanout - 1."""
    out_l, out_n = [lane[:0]], [node[:0]]
    step = max(1, _chunks(node.device)[0] // fanout)
    kid = torch.arange(fanout, device=node.device)
    for s in range(0, lane.numel(), step):
        cl = lane[s:s + step].repeat_interleave(fanout)
        cn = (node[s:s + step, None] * fanout + kid).reshape(-1)
        keep = _reach(o, f, t_best, cl, boxes[cn])
        out_l.append(cl[keep])
        out_n.append(cn[keep])
    return torch.cat(out_l), torch.cat(out_n)


def _resolve(t_seed, lane, t, pos, gid, u, v):
    """Per lane, the candidate of least t, exact ties to the least scan
    position `pos`; candidates are (lane, t, pos, gid, u, v) with t <
    t_seed[lane]. Returns (t, gid, u, v) per lane, gid -1 without one."""
    n = t_seed.numel()
    t_out = t_seed.clone()
    gid_out = torch.full((n,), -1, dtype=torch.int64, device=t_seed.device)
    u_out, v_out = torch.zeros_like(t_seed), torch.zeros_like(t_seed)
    if lane.numel() == 0:
        return t_out, gid_out, u_out, v_out
    tmin = torch.full_like(t_seed, INF).scatter_reduce(0, lane, t, "amin")
    tie = t == tmin[lane]
    big = torch.iinfo(torch.int64).max
    pmin = torch.full((n,), big, dtype=torch.int64, device=t_seed.device)
    pmin = pmin.scatter_reduce(0, lane[tie], pos[tie], "amin")
    win = tie & (pos == pmin[lane])
    wl = lane[win]
    t_out[wl], gid_out[wl], u_out[wl], v_out[wl] = t[win], gid[win], u[win], v[win]
    return t_out, gid_out, u_out, v_out


def mesh_hit_walk(o, d, t_seed, tables, t_min: float = EPS):
    """Nearest mesh hit by the slab-culled cluster walk: a triangle is
    tested only for the lanes whose slab tests reach its supergroup,
    supercluster and cluster (pruned by entry < t_seed). o, d: 3-tuples
    of (N,) f32; t_seed (N,) f32; a hit counts only at t >= t_min,
    applied after the triangle test (EPS, which the test implies, or the
    cpu semantics' 20*EPS). Returns (t, gid (int64, -1 where no triangle
    beat t_seed), u, v), exact-t ties to the least scan position. The
    kernels prune by a running best instead of t_seed: `mesh_trace`'s
    thread walks in the camera's scan order, `mesh_hit`'s thread group
    visits each level's reached boxes nearest slab entry first, in the
    ray's own order. Any box that can hold the nearest hit has its entry
    at or below it (see `walk_work`), so both find the same nearest hit
    except where an exact-t tie straddles a box whose entry equals the
    running best."""
    n = t_seed.numel()
    f = [1.0 / _slab_clamp(dk) for dk in d]
    dev = t_seed.device
    n_sg = tables.sgbounds.shape[0]
    lane = torch.arange(n, device=dev).repeat_interleave(n_sg)
    node = torch.arange(n_sg, device=dev).repeat(n)
    keep = _reach(o, f, t_seed, lane, tables.sgbounds[node])
    lane, node = lane[keep], node[keep]
    lane, node = _descend(o, f, t_seed, lane, node, SGROUP, tables.sbounds)
    lane, node = _descend(o, f, t_seed, lane, node, GROUP, tables.bounds)
    # padding clusters' inverted AABBs pass the slab test (their slabs
    # span -inf..inf): skip them by count, as the kernel does
    full = tables.count[node] > 0
    lane, node = lane[full], node[full]
    W = tables.tri.shape[1]
    w_idx = torch.arange(W, device=dev)
    cand = [[] for _ in range(6)]
    step = _chunks(dev)[1]
    for s in range(0, lane.numel(), step):
        pl, pn = lane[s:s + step], node[s:s + step]
        rows = tables.tri[pn]  # (P, W, 12)
        ray = [c[pl, None] for c in (*o, *d)]
        t, u, v = triangle_tuv(*ray, (rows[..., 0], rows[..., 1], rows[..., 2]),
                               (rows[..., 3], rows[..., 4], rows[..., 5]),
                               (rows[..., 6], rows[..., 7], rows[..., 8]))
        ok = (w_idx[None, :] < tables.count[pn, None]) & (t >= t_min)
        t = torch.where(ok, t, torch.full_like(t, INF))
        tmin, arg = t.min(dim=1)  # the first of equal minima: scan order
        hit = tmin < t_seed[pl]
        a = arg[hit, None]
        for k, val in enumerate((pl[hit], tmin[hit], pn[hit] * W + arg[hit],
                                 tables.gid[pn[hit], arg[hit]].long(),
                                 u[hit].gather(1, a)[:, 0], v[hit].gather(1, a)[:, 0])):
            cand[k].append(val)
    if not cand[0]:
        return _resolve(t_seed, *(torch.zeros(0, dtype=dt, device=dev) for dt in
                                  (torch.int64, torch.float32, torch.int64, torch.int64,
                                   torch.float32, torch.float32)))
    return _resolve(t_seed, *(torch.cat(c) for c in cand))


def walk_work(o, d, t_best, tables, t_min: float = EPS):
    """The tests an exact walk of these rays must make: the walk of
    `mesh_hit_walk` with every box pruned by the ray's final nearest t
    t_best (the t that `mesh_hit` returns), a box reached when entry <=
    t_best. A box of larger entry holds no triangle that beats the
    nearest hit, and the box of the nearest hit has its entry at or below
    it, so every walk that returns the exact nearest hit makes at least
    these tests. A live ray tests every supergroup box; a reached
    supergroup its SGROUP supercluster boxes; a reached supercluster the
    boxes of its non-empty clusters; a reached non-empty cluster its
    `count` rows. Rays with t_best < t_min (dead lanes, seeded -INF) make
    none.

    Returns a dict of ints: rays (the live ones), slab (the slab tests
    at the supergroup, supercluster and cluster levels), tri (the
    triangle tests)."""
    live = (t_best >= t_min).nonzero()[:, 0]
    bound = torch.nextafter(t_best, torch.full_like(t_best, math.inf))  # entry < bound: <= t_best
    f = [1.0 / _slab_clamp(dk) for dk in d]
    n_sg = tables.sgbounds.shape[0]
    lane = live.repeat_interleave(n_sg)
    node = torch.arange(n_sg, device=t_best.device).repeat(live.numel())
    keep = _reach(o, f, bound, lane, tables.sgbounds[node])
    lane, node = lane[keep], node[keep]
    slab = [live.numel() * n_sg, SGROUP * lane.numel()]
    lane, node = _descend(o, f, bound, lane, node, SGROUP, tables.sbounds)
    slab.append(int((tables.count > 0).view(-1, GROUP).sum(dim=1)[node].sum()))
    lane, node = _descend(o, f, bound, lane, node, GROUP, tables.bounds)
    # a padding cluster's inverted box passes the slab test; its count is 0
    return dict(rays=live.numel(), slab=slab, tri=int(tables.count[node].sum()))


def _instance_spans(o, d, inst):
    """The world slab test of every ray against every instance's AABB (the
    (I, 24) table's columns 12:18), as `_reach` computes it: (entry (N, I),
    entry <= exit & exit >= 0 (N, I)); the pruning by a best t is left to
    the caller."""
    f = [1.0 / _slab_clamp(dk) for dk in d]
    t0 = [(inst[None, :, 12 + k] - o[k][:, None]) * f[k][:, None] for k in range(3)]
    t1 = [(inst[None, :, 15 + k] - o[k][:, None]) * f[k][:, None] for k in range(3)]
    mn = [torch.minimum(a, b) for a, b in zip(t0, t1)]
    mx = [torch.maximum(a, b) for a, b in zip(t0, t1)]
    entry = torch.maximum(torch.maximum(mn[0], mn[1]), mn[2])
    exit_ = torch.minimum(torch.minimum(mx[0], mx[1]), mx[2])
    return entry, (entry <= exit_) & (exit_ >= 0.0)


def _instance_rays(o, d, lane, row):
    """The rays of the lanes `lane` in the frame of the instance of table
    row `row` ((24,), or (len(lane), 24): each lane's own row): o' = A (o -
    T), d' = A d, in f32 and the JAX package's order of terms
    (mesh_bounce_kernel.py:532-540). Returns (o', d')."""
    c = [row[..., j] for j in range(12)]
    r = [o[k][lane] - c[9 + k] for k in range(3)]
    dl = [d[k][lane] for k in range(3)]
    ol = tuple(c[3 * j] * r[0] + c[3 * j + 1] * r[1] + c[3 * j + 2] * r[2] for j in range(3))
    dd = tuple(c[3 * j] * dl[0] + c[3 * j + 1] * dl[1] + c[3 * j + 2] * dl[2] for j in range(3))
    return ol, dd


def mesh_hit_instanced(o, d, t_seed, tables, t_min: float = EPS):
    """Nearest mesh hit of an instanced scene (bounce_tiles' `inst_body`,
    mesh_bounce_kernel.py:500-544): the least (t, instance table row,
    scan position) over the instances of tables.inst, hits with t_min <= t
    < t_seed. The (lane, instance) pairs are those whose world slab test
    reaches the instance's AABB below the lane's seed (`_instance_spans`),
    each walked by `mesh_hit_walk` over the asset's local tables
    (tables.asset) with the ray moved into the instance's frame
    (`_instance_rays`), in two batches: first every lane's pair of least
    slab entry, seeded with the lane's seed; then its other pairs whose
    entry is at most that hit's t, seeded one ulp above it (so an earlier
    row's exact-t tie is found). Per lane the least t wins, an exact-t tie
    to the earlier table row (`_resolve`), and the instance's gid base is
    added to the local id. That is the answer of walking the instances one
    after another in table order, each seeded with the running best (a
    later instance replaces a hit only at a smaller t), since a seed only
    prunes boxes whose slab entry lies above it; the tests and chip_smoke.py
    hold the two bitwise (tests/torch_instanced_loop.py). Same arguments
    and returns as mesh_hit_walk (gid global: the flattened tables' id)."""
    if tables.asset is None:
        raise ValueError("the instanced route needs a scene with instancing tables (n_inst > 0)")
    entry, ok = _instance_spans(o, d, tables.inst)
    ok &= entry < t_seed[:, None]
    lane = ok.any(1).nonzero()[:, 0]
    row = torch.where(ok, entry, torch.full_like(entry, INF))[lane].argmin(1)  # the first least
    cand = [[] for _ in range(6)]

    def walk(lane, row, seed):
        inst = tables.inst[row]
        t, gid, u, v = mesh_hit_walk(*_instance_rays(o, d, lane, inst), seed, tables.asset,
                                     t_min=t_min)
        hit = gid >= 0
        for k, val in enumerate((lane[hit], t[hit], row[hit], gid[hit] + inst[hit, 18].long(),
                                 u[hit], v[hit])):
            cand[k].append(val)
        return hit, t

    hit, t = walk(lane, row, t_seed[lane])
    below = t_seed.clone()
    below[lane[hit]] = torch.nextafter(t[hit], torch.full_like(t[hit], math.inf))
    ok[lane, row] = False
    ok &= entry < below[:, None]
    lane, row = ok.nonzero(as_tuple=True)
    walk(lane, row, below[lane])
    return _resolve(t_seed, *(torch.cat(c) for c in cand))


def instanced_walk_work(o, d, t_best, tables, t_min: float = EPS):
    """The tests an exact instanced walk of these rays must make, as
    `walk_work` counts them, with t_best the rays' final nearest t: every
    live ray tests every instance's AABB; an instance whose AABB it
    reaches with entry <= t_best (a box of larger entry holds no hit that
    beats the nearest) costs a transform and walk_work's tests on the
    asset's local tables with the ray in its frame.

    Returns a dict of ints: rays (the live ones), inst_slab (the instance
    AABB tests), transforms, slab (the local slab tests at the supergroup,
    supercluster and cluster levels), tri (the triangle tests)."""
    live = t_best >= t_min
    bound = torch.nextafter(t_best, torch.full_like(t_best, math.inf))  # entry < bound: <= t_best
    entry, ok = _instance_spans(o, d, tables.inst)
    ok &= live[:, None] & (entry < bound[:, None])
    out = dict(rays=int(live.sum()), inst_slab=int(live.sum()) * tables.n_inst,
               transforms=int(ok.sum()), slab=[0, 0, 0], tri=0)
    for k, row in enumerate(tables.inst):
        lane = ok[:, k].nonzero()[:, 0]
        work = walk_work(*_instance_rays(o, d, lane, row), t_best[lane], tables.asset,
                         t_min=t_min)
        out["slab"] = [a + b for a, b in zip(out["slab"], work["slab"])]
        out["tri"] += work["tri"]
    return out


def mesh_hit_brute(o, d, t_seed, tables):
    """Nearest mesh hit over every triangle of the brute table, in its
    row order (the function `woop.mxu_mesh_hit` computes, in plain f32
    Moller-Trumbore). Same arguments and returns as mesh_hit_walk."""
    tri, gid = tables.btri, tables.bgid
    n, Mb = t_seed.numel(), tri.shape[0]
    cols = [tri[None, :, k] for k in range(9)]
    valid = gid[None, :] >= 0
    out = [t_seed.clone(), torch.full((n,), -1, dtype=torch.int64, device=t_seed.device),
           torch.zeros_like(t_seed), torch.zeros_like(t_seed)]
    step = max(1, _chunks(t_seed.device)[0] // Mb)
    for s in range(0, n, step):
        sl = slice(s, s + step)
        ray = [c[sl, None] for c in (*o, *d)]
        t, u, v = triangle_tuv(*ray, cols[0:3], cols[3:6], cols[6:9])
        t = torch.where(valid, t, torch.full_like(t, INF))
        tmin, arg = t.min(dim=1)
        hit = tmin < t_seed[sl]
        a = arg[:, None]
        out[0][sl] = torch.where(hit, tmin, t_seed[sl])
        out[1][sl] = torch.where(hit, gid[arg].long(), out[1][sl])
        out[2][sl] = torch.where(hit, u.gather(1, a)[:, 0], out[2][sl])
        out[3][sl] = torch.where(hit, v.gather(1, a)[:, 0], out[3][sl])
    return tuple(out)


def mesh_attrs(attr, desc, pool, pool_kind: int, mi, bu, bv):
    """Shading attributes of mesh hits (integrator.mesh_attrs_dense,
    :546-630): shading normal (normal-mapped, the raw [0, 1] texel taken
    as the tangent-space vector, no 2x-1 remap), base colour times its
    texel, metal from the blue texel channel and rough from the green.
    attr (M, 48) f32, desc (M, 9) int32; mi (N,) triangle ids; bu, bv
    barycentrics. Returns (nx, ny, nz, r, g, b, metal, rough)."""
    a = take(attr, mi)
    dsc = desc[mi]
    col = lambda j: a[:, j]
    b0 = 1.0 - bu - bv

    def interp(base):
        return (b0 * col(base) + bu * col(base + 2) + bv * col(base + 4),
                b0 * col(base + 1) + bu * col(base + 3) + bv * col(base + 5))

    def fetch(k, base):
        return sample_nearest(pool, pool_kind, dsc[:, k], dsc[:, k + 1], dsc[:, k + 2],
                              *interp(base))

    _, tn = fetch(3, 25)
    mapped = normalize(*((col(r) * tn[0] + col(r + 1) * tn[1] + col(r + 2) * tn[2]) * col(12)
                      for r in (3, 6, 9)), eps=1e-20)
    has_nm = col(18) > 0.5
    n = [torch.where(has_nm, mapped[k], col(k)) for k in range(3)]
    has_rt, tr = fetch(0, 19)
    one = torch.ones_like(bu)
    rgb = [col(13 + k) * torch.where(has_rt, tr[k], one) for k in range(3)]
    has_mr, tm = fetch(6, 31)
    metal = col(16) * torch.where(has_mr, tm[2], one)
    rough = col(17) * torch.where(has_mr, tm[1], one)
    return (*n, *rgb, metal, rough)


def mesh_trace_reference(xs, ys, samp, tables, *, assured: int, max_bounces: int,
                         samples_per_lane: int = 1, route: str | None = None,
                         generator: str = "weyl", return_counts: bool = False):
    """Plain torch mirror of the kernel on flat lanes: masked
    `torch.where` updates and a Python loop bounded by max_bounces *
    samples_per_lane that stops once no lane is active. The mesh nearest
    hit runs on the active lanes only, on `route` (default tables.route);
    with tables.sky, a miss adds the sky's term. Returns the radiance
    (r, g, b), 3 f32 tensors shaped like xs.

    return_counts (measurement, like trace_tiles_reference's
    return_iters): also return (iters, misses), int32 shaped like xs: the
    loop iterations each lane was active in (its lane-bounces) and the
    times its paths left the scene (the sky fetches, with a sky)."""
    route = tables.route if route is None else route
    if route not in ROUTES:
        raise ValueError(f"route must be one of {tuple(ROUTES)}, not {route!r}")
    nearest = {"walk": mesh_hit_walk, "brute": mesh_hit_brute,
               "instanced": mesh_hit_instanced}[route]
    shape = xs.shape
    xs, ys, samp = xs.reshape(-1), ys.reshape(-1), samp.reshape(-1)
    spl = samples_per_lane
    cam = [float(v) for v in tables.cam_vec.reshape(-1).tolist()]
    max_thres = float(np.float32(cam[17]))
    inv_thres = float(np.float32(1.0) / np.float32(max_thres))
    bd = raygen.base_dir(xs, ys, cam)

    def start_sample(samp_id):
        return raygen.start(rng.init_state(xs, ys, samp_id), bd, cam, tables.has_lens, generator)

    samp0 = rng.as_u32(samp)
    state, o, d = start_sample(samp0)
    zero = torch.zeros_like(o[0])
    ci = [torch.ones_like(zero) for _ in range(3)]
    inten = torch.ones_like(zero)
    L = [zero] * 3
    active = torch.ones_like(zero, dtype=torch.bool)
    depth = torch.zeros_like(zero)
    sk = torch.zeros_like(samp0)
    where = torch.where
    iters, misses = torch.zeros_like(xs), torch.zeros_like(xs)

    for _ in range(max_bounces * spl):
        if not bool(active.any()):
            break
        h = closest_sph_ft(tables.sph, tables.ft, *o, *d, n_sph=tables.n_sph, n_ft=tables.n_ft)
        ai = active.nonzero()[:, 0]
        r = nearest(tuple(c[ai] for c in o), tuple(c[ai] for c in d), h["t_best"][ai], tables)
        t_m, gid, bu, bv = (full.index_put((ai,), part) for full, part in
                            zip((zero, torch.full_like(samp0, -1), zero, zero), r))
        mesh = active & (gid >= 0)
        sph_ft = active & ~mesh & (h["kind"] > 0.5)
        state, (u0, u1, u2, u3, u4, u5, u6, u7) = rng.next_f32_n(state, 8, generator)
        rr_kill = (depth >= float(assured)) & (u7 > max_thres)
        miss = active & ~mesh & ~(h["kind"] > 0.5)
        if return_counts:
            iters += active.to(iters.dtype)
            misses += miss.to(misses.dtype)
        if tables.sky is not None:  # a miss: L += (ci * inten) * sky(d), the path ends
            mi = miss.nonzero()[:, 0]
            rgb = tables.sky.sample(*(c[mi] for c in d))
            L = [L[k].index_put((mi,), L[k][mi] + ci[k][mi] * inten[mi] * rgb[k])
                 for k in range(3)]

        # ---- sphere / free-triangle hits: trace_tiles' shading ----
        t_safe = where(sph_ft, h["t_best"], zero)
        p = [o[k] + d[k] * t_safe for k in range(3)]
        n = [h["nxv"], h["nyv"], h["nzv"]]
        if tables.n_sph:
            is_sph = h["kind"] == 1.0
            sn = raygen.norm3(p[0] - h["scx"], p[1] - h["scy"], p[2] - h["scz"])
            n = [where(is_sph, sn[k], n[k]) for k in range(3)]
        pos_s = [p[k] + n[k] * EPS for k in range(3)]
        *nd_s, weight = uniform_bsdf(*d, *n, h["mkind"], h["diffp"], h["n_out"], h["n_in"],
                                     u0, u1, u2, u3)
        rgb = (h["rgb_r"], h["rgb_g"], h["rgb_b"])
        em = (h["em_r"], h["em_g"], h["em_b"])
        add_em = sph_ft & (h["has_em"] > 0.5)
        L = [L[k] + where(add_em, em[k] * (ci[k] * inten), zero) for k in range(3)]
        ci = [where(add_em, ci[k] * rgb[k], ci[k]) for k in range(3)]
        ci = [where(sph_ft, ci[k] * rgb[k], ci[k]) for k in range(3)]

        # ---- mesh hits: PBR divert (_mesh_shade), mesh emissive is zero ----
        mi = where(mesh, gid, torch.zeros_like(gid))
        *nm, mr, mg, mb, metal, rough = mesh_attrs(tables.attr, tables.desc, tables.pool,
                                                   tables.pool_kind, mi, bu, bv)
        t_safe = where(mesh, t_m, zero)
        pos_m = [o[k] + d[k] * t_safe + nm[k] * EPS for k in range(3)]
        dn = d[0] * nm[0] + d[1] * nm[1] + d[2] * nm[2]
        k2 = 2.0 * dn
        spec = normalize(*(d[k] - nm[k] * k2 for k in range(3)))
        xd = normalize(*(d[k] - nm[k] * dn for k in range(3)), eps=1e-20)
        yd = (nm[1] * xd[2] - nm[2] * xd[1], nm[2] * xd[0] - nm[0] * xd[2],
              nm[0] * xd[1] - nm[1] * xd[0])
        r_ = torch.sqrt(u1)
        th = raygen.TWO_PI * u2
        ca, sa = r_ * torch.cos(th), r_ * torch.sin(th)
        zz = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
        diff = [xd[k] * ca + yd[k] * sa + nm[k] * zz for k in range(3)]
        r0 = 0.04 + (1.0 - 0.04) * metal
        adn = torch.abs(dn)
        a2 = adn * adn
        refl = r0 + (1.0 - r0) * (1.0 - a2 * a2 * adn)
        pbr_diff = u0 < (1.0 - refl)
        sc = normalize(u4, u5, u6, eps=1e-20)
        nd_m = normalize(*(where(pbr_diff, diff[k], spec[k]) + sc[k] * rough for k in range(3)))
        mrgb = (mr, mg, mb)
        ci = [where(mesh, ci[k] * mrgb[k], ci[k]) for k in range(3)]

        # ---- Russian roulette and the next ray, both kinds ----
        hm = sph_ft | mesh
        term = hm & rr_kill
        L = [L[k] + where(term, ci[k] * inv_thres * inten, zero) for k in range(3)]
        ci = [where(term, ci[k] * inv_thres, ci[k]) for k in range(3)]
        surv_s, surv_m = sph_ft & ~rr_kill, mesh & ~rr_kill
        inten = where(surv_s, inten * weight, inten)
        o = [where(surv_s, pos_s[k], where(surv_m, pos_m[k], o[k])) for k in range(3)]
        d = [where(surv_s, nd_s[k], where(surv_m, nd_m[k], d[k])) for k in range(3)]
        survive = surv_s | surv_m
        depth = depth + survive.to(depth.dtype)

        if spl > 1:
            alive = survive & (depth < float(max_bounces))
            regen = ~alive & (sk + 1 < spl)
            sk = sk + regen.to(sk.dtype)
            st2, o2, d2 = start_sample(samp0 + sk)
            state = where(regen, st2, state)
            o = [where(regen, o2[k], o[k]) for k in range(3)]
            d = [where(regen, d2[k], d[k]) for k in range(3)]
            ci = [where(regen, 1.0, ci[k]) for k in range(3)]
            inten = where(regen, 1.0, inten)
            depth = where(regen, 0.0, depth)
            active = alive | regen
        else:
            active = survive

    out = tuple(v.reshape(shape) for v in L)
    return (out, (iters.reshape(shape), misses.reshape(shape))) if return_counts else out


# --- the dispatcher --------------------------------------------------------

_F32_BUFFERS = ("sph", "ft", "cam_vec", "sgbounds", "sbounds", "bounds", "tri", "btri", "attr",
                "inst")
_I32_BUFFERS = ("count", "gid", "bgid", "desc")
_WALK_BUFFERS = (("sgbounds", "sbounds", "bounds", "tri"), torch.float32), \
    (("count", "gid"), torch.int32)


def _check_walk(tables, dev, prefix="tables"):
    """The walk's buffers of `tables` contiguous, of their dtypes, on dev."""
    for names, dtype in _WALK_BUFFERS:
        for name in names:
            t = getattr(tables, name)
            if t.dtype != dtype or t.device != dev or not t.is_contiguous():
                raise ValueError(f"{prefix}.{name} must be contiguous {dtype} on {dev}")
    if tables.tri.shape[2] != TRI_COLS:
        raise ValueError(f"{prefix} do not have the packed column layout")


def _asset_args(tables, dev, instanced: bool):
    """The C entries' last ten arguments: the instance table, its rows and
    the asset's walk tables (instanced), or nulls."""
    if not instanced:
        return [None, 0] + [None] * 6 + [0, 0]
    if tables.asset is None or tables.n_inst < 1:
        raise ValueError("the instanced route needs a scene with instancing tables (n_inst > 0)")
    if tables.inst.shape != (tables.n_inst, INST_COLS):
        raise ValueError(f"tables.inst must be ({tables.n_inst}, {INST_COLS})")
    a = tables.asset
    _check_walk(a, dev, "tables.asset")
    return [tables.inst.data_ptr(), tables.n_inst,
            *(getattr(a, k).data_ptr() for k in ("sgbounds", "sbounds", "bounds", "count",
                                                  "tri", "gid")),
            a.sgbounds.shape[0], a.tri.shape[1]]


def _launch(xs, ys, samp, tables, *, route, assured, max_bounces, samples_per_lane,
            sky=None, generator="weyl", entry=None):
    from ..kernels import build

    dev = xs.device
    for name, t in (("xs", xs), ("ys", ys), ("samp", samp)):
        if t.shape != xs.shape or t.dtype != torch.int32 or t.device != dev:
            raise ValueError(f"{name} must be int32 on {dev} shaped {tuple(xs.shape)}")
    for names, dtype in ((_F32_BUFFERS, torch.float32), (_I32_BUFFERS, torch.int32)):
        for name in names:
            t = getattr(tables, name)
            if t.dtype != dtype or t.device != dev or not t.is_contiguous():
                raise ValueError(f"tables.{name} must be contiguous {dtype} on {dev}")
    if tables.pool.device != dev or not tables.pool.is_contiguous():
        raise ValueError(f"tables.pool must be contiguous on {dev}")
    if (tables.sph.shape[1] != SPH_COLS or tables.ft.shape[1] != FT_COLS
            or tables.cam_vec.numel() != CAM_LEN or tables.tri.shape[2] != TRI_COLS):
        raise ValueError("tables do not have the packed column layout")
    if samples_per_lane < 1 or max_bounces < 1:
        raise ValueError("samples_per_lane and max_bounces must be >= 1")
    if generator not in rng.GENERATORS:
        raise ValueError(f"generator must be one of {rng.GENERATORS}, not {generator!r}")

    entry = entry or ROUTES[route]
    sky_args = cubemap.launch_args(sky, dev)
    asset_args = _asset_args(tables, dev, route == "instanced")
    lib = build.build("mesh_kernel").lib
    fn = getattr(lib, f"{entry}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                   + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_longlong]
                   + [ctypes.c_void_p] * 3 + cubemap.ARGTYPES + [ctypes.c_int]
                   + [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2)
    xs_c, ys_c, samp_c = xs.contiguous(), ys.contiguous(), samp.contiguous()
    n = xs_c.numel()
    out = torch.empty((3, n), dtype=torch.float32, device=dev)
    # the persistent entries' warps (the routes' and the instanced yardstick's)
    # take their 32-lane tiles from this counter
    persistent = entry in ROUTES.values() or entry == YARDSTICKS["instanced"]
    work = torch.zeros(1, dtype=torch.int32, device=dev) if persistent else None
    tb = tables
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(xs_c.data_ptr(), ys_c.data_ptr(), samp_c.data_ptr(), n,
                tb.sph.data_ptr(), tb.ft.data_ptr(), tb.cam_vec.data_ptr(),
                tb.n_sph, tb.n_ft, int(tb.has_lens), assured, max_bounces, samples_per_lane,
                tb.sgbounds.data_ptr(), tb.sbounds.data_ptr(), tb.bounds.data_ptr(),
                tb.count.data_ptr(), tb.tri.data_ptr(), tb.gid.data_ptr(),
                tb.sgbounds.shape[0], tb.tri.shape[1],
                tb.btri.data_ptr(), tb.bgid.data_ptr(), tb.btri.shape[0],
                tb.attr.data_ptr(), tb.desc.data_ptr(), tb.pool.data_ptr(),
                tb.pool_kind, tb.pool.numel(),
                out.data_ptr(), None if work is None else work.data_ptr(), stream, *sky_args,
                int(generator == "pcg"), *asset_args)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    LAUNCHES[launch_key(entry, sky, generator)] += 1
    return tuple(out[k].view(xs.shape) for k in range(3))


def mesh_trace(xs, ys, samp, tables: MeshTables, *, assured: int, max_bounces: int,
               samples_per_lane: int = 1, route: str | None = None,
               generator: str = "weyl"):
    """xs, ys, samp: int32 lane tensors of any shape; tables: a
    MeshTables on the same device; route "walk", "brute" or "instanced"
    (a scene with instancing tables only), by default tables.route
    (INSTANCED_ROUTE and the MAX_BRUTE_TRIS gate; the tests and
    chip_smoke.py pass every route on one scene). Lane i covers sample ids samp[i] ..
    samp[i] + samples_per_lane - 1, its draws from `generator` ("weyl" or
    "pcg"). Returns the radiance sum (r, g, b):
    3 f32 tensors shaped like xs, with the sky's terms where tables.sky
    is set.

    CPU tensors run `mesh_trace_reference`; CUDA tensors launch the CUDA
    kernel's entry point of the route or raise (the brute entry, for
    one, when its table does not fit in a block's shared memory)."""
    route = tables.route if route is None else route
    if route not in ROUTES:
        raise ValueError(f"route must be one of {tuple(ROUTES)}, not {route!r}")
    if tables.n_sph > MAX_PRIMS or tables.n_ft > MAX_PRIMS:
        raise NotImplementedError(f"mesh_trace takes <= {MAX_PRIMS} spheres and free triangles")
    kw = dict(route=route, assured=assured, max_bounces=max_bounces,
              samples_per_lane=samples_per_lane, generator=generator)
    if xs.device.type == "cuda":
        return _launch(xs, ys, samp, tables, sky=tables.sky, **kw)
    if xs.device.type == "cpu":
        return mesh_trace_reference(xs, ys, samp, tables, **kw)
    raise ValueError(f"mesh_trace runs on cpu or cuda tensors, not {xs.device}")


def _mesh_trace_yardstick(xs, ys, samp, tables: MeshTables, *, assured: int, max_bounces: int,
                          samples_per_lane: int = 1, route: str | None = None):
    """`mesh_trace` by the route's yardstick entry (YARDSTICKS): the first
    design, which chip_smoke.py times the kernel against, without the
    cube map, `weyl` only. CUDA tensors only."""
    if xs.device.type != "cuda":
        raise ValueError(f"the mesh_trace yardsticks run on cuda tensors, not {xs.device}")
    route = tables.route if route is None else route
    return _launch(xs, ys, samp, tables, route=route, assured=assured, max_bounces=max_bounces,
                   samples_per_lane=samples_per_lane, entry=YARDSTICKS[route])


# --- the nearest hit alone: the integrator's mesh intersection -------------


def _launch_hit(o, d, t_seed, tables, t_min, entry="mesh_hit", gid_out=None):
    from ..kernels import build

    dev = t_seed.device
    n = t_seed.numel()
    rays = [c.contiguous() for c in (*o, *d, t_seed)]
    for name, t in zip(("ox", "oy", "oz", "dx", "dy", "dz", "t_seed"), rays):
        if t.dtype != torch.float32 or t.device != dev or t.shape != (n,):
            raise ValueError(f"{name} must be ({n},) float32 on {dev}")
    _check_walk(tables, dev)

    fn = getattr(build.build("mesh_kernel").lib, f"{entry}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_float]
                   + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 5)
    t_out, u_out, v_out = (torch.empty(n, dtype=torch.float32, device=dev) for _ in range(3))
    if gid_out is None:
        gid_out = torch.empty(n, dtype=torch.int32, device=dev)
    elif gid_out.dtype != torch.int32 or gid_out.device != dev or gid_out.shape != (n,) or \
            not gid_out.is_contiguous():
        raise ValueError(f"gid_out must be contiguous ({n},) int32 on {dev}")
    tb = tables
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(*(r.data_ptr() for r in rays), n, t_min,
                tb.sgbounds.data_ptr(), tb.sbounds.data_ptr(), tb.bounds.data_ptr(),
                tb.count.data_ptr(), tb.tri.data_ptr(), tb.gid.data_ptr(),
                tb.sgbounds.shape[0], tb.tri.shape[1],
                t_out.data_ptr(), gid_out.data_ptr(), u_out.data_ptr(), v_out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    LAUNCHES[entry] += 1
    return t_out, gid_out, u_out, v_out


def mesh_hit(o, d, t_seed, tables: MeshTables, *, t_min: float, gid_out=None):
    """The nearest mesh hit of each ray (the contract of the JAX
    `mesh_hit_tiles`, mesh_hit_kernel.py:268-276): o, d 3-tuples of (N,)
    f32 tensors, t_seed (N,) f32 the best t so far; a hit counts at
    t_min <= t < t_seed (t_min EPS in gpu semantics, 20*EPS in cpu
    semantics), exact-t ties to the least scan position of
    `pack_mesh_tables`' layout. Returns (t, gid int32, u, v): gid -1, t =
    t_seed and u = v = 0 where no triangle beat the seed. A lane seeded
    at or below t_min (a dead lane, seeded -INF) reaches no cluster.

    CPU tensors run `mesh_hit_walk`; CUDA tensors launch the `mesh_hit`
    entry of csrc/mesh_kernel.cu (a thread group per ray, nearest slab
    entry first, pruned by the group's running best) or raise."""
    t_min = float(np.float32(t_min))
    if t_seed.device.type == "cuda":
        return _launch_hit(o, d, t_seed, tables, t_min, gid_out=gid_out)
    if t_seed.device.type == "cpu":
        t, gid, u, v = mesh_hit_walk(o, d, t_seed, tables, t_min=t_min)
        gid = gid.to(torch.int32) if gid_out is None else gid_out.copy_(gid)
        return t, gid, u, v
    raise ValueError(f"mesh_hit runs on cpu or cuda tensors, not {t_seed.device}")


def _mesh_hit_per_thread(o, d, t_seed, tables: MeshTables, *, t_min: float):
    """`mesh_hit` by the entry `mesh_hit_per_thread` of csrc/mesh_kernel.cu
    (one thread per ray, the camera's scan order): the yardstick that
    chip_smoke.py times the kernel against. CUDA tensors only."""
    if t_seed.device.type != "cuda":
        raise ValueError(f"the per-thread mesh_hit runs on cuda tensors, not {t_seed.device}")
    return _launch_hit(o, d, t_seed, tables, float(np.float32(t_min)), "mesh_hit_per_thread")
