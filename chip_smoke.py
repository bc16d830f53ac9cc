#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives raytrace_tpu_torch's paths on the card and checks them:

1. environment: the card's name and power limit, CUDA and nvcc versions;
2. build: compiles csrc/trace_kernel.cu and csrc/mesh_kernel.cu with nvcc
   for sm_90a, with copies of mesh_kernel.cu at 8, 16 and 32 threads per
   ray for the group sweep of phase 5, all at once (timed), and prints
   ptxas's registers / shared memory / stack / spills of every kernel
   (both trace_tiles entries among them) and trace_kernel.cu's SASS
   instruction counts (cuobjdump, into raytrace_tpu_torch/_build/sass/);
3. kernel vs plain, both on the card: `trace_tiles` (the CUDA kernel) and
   its first design `trace_tiles_per_thread` (the yardstick) against
   `trace_tiles_reference` (plain torch) on the walled scene at 1200x600
   (samples per lane 1: all 9 outputs; 4: radiance) and on a mixed
   sphere / free-triangle / dielectric / emissive scene at 64x32 (1 and
   4), under the lane-fraction gate: under 1% of lanes may have
   |a - b| / (|b| + 1e-3) > 1e-3 (the worst fraction printed); the plain
   version's per-lane loop counts and branches on the main path's launch
   (walled 1200x600, 64 samples per lane: warp and 256-lane block
   efficiency, the branch mix); then the three timed with CUDA events at
   that launch, in turns plain, new, old, old, new, plain;
4. walled main path: Renderer(walled 1200x600, device="cuda").render(64
   spp) with the kernel's launch count reset just before and read just
   after; the image must be finite and agree with the CPU render of a
   small frame (scripts/hw_parity.py's tile gate), and a checkpoint
   resume must be bitwise exact on the card. Prints paths/s with the
   card's name and power limit, the render timed in turns against the
   same render with the yardstick in trace_tiles' place (each turn the
   median of RENDER_REPS renders), and (after phase 8, in a child process of
   its own) a torch.profiler table of one warm render(64): trace_tiles'
   share of device time and the device-to-host copy's;
5. mesh kernel vs plain, both on the card: `mesh_trace` (the walk)
   against `mesh_trace_reference` on the whole 1216x608 frame of the
   a380-class textured surface (127,749 triangles, 20 u8 1024x1024
   textures) at samples per lane 1, 4 and 16 (the main path's launch),
   and `mesh_trace_brute` on the whole frame of the 2,097-triangle
   surface at the same camera, likewise: the lanes that differ are
   printed and must be none; both routes on a 64x32 scene of textured,
   normal-mapped octahedra with an emissive sphere, a dielectric sphere
   and a DiffSpec triangle, under the lane gate. Each kernel is timed at
   the main path's launch against its yardstick (the entry's first
   design: `mesh_trace_per_thread`, `mesh_trace_brute_lockstep`) in turns
   new, old, old, new, beside its plain version's launch; both versions
   on a strided subset of 33,606 pixels in turns; the host set-up
   (build_scene, MeshTables) on the host clock. Then the gate sweep: both
   routes on the whole frame at 16 samples per lane over cuts of the
   surface (256, 512, 1,024, 2,097 and 2,560 triangles) in turns walk,
   brute, brute, walk, and the largest cut at which the brute route is
   faster beside MAX_BRUTE_TRIS; and the group sweep
   (scripts/torch_mesh_trace_groups.py): both entries at 8, 16 and 32
   threads per ray, bitwise against the committed kernel, in turns;
6. mesh main paths: Renderer(a380-class 1216x608, "cuda").render(16) (the
   walk) and Renderer(2,097-triangle surface, "cuda").render(16) on the
   brute route (set on its tables whatever the gate says), each with the
   launch counts reset just before and read just after; finite images,
   paths/s with the card's name and power limit, a small frame of the
   a380-class scene on the card against the CPU under the tile gate, a
   bitwise exact resume on the card, and a torch.profiler table of one
   warm a380-class render(16);
7. the integrator's mesh hit on the card: `mesh_hit` (the CUDA entry, a
   thread group per ray) and its per-thread yardstick
   (`mesh_hit_per_thread`) against `mesh_hit_walk` (plain torch) on the
   primary rays of the whole a380-class 1216x608 frame and the secondary
   rays of one bounce, a quarter of the lanes dead (seeded -inf), at
   t_min EPS (gpu semantics) and 20*EPS (cpu semantics), and on the
   in-render pool: the 131,072 rays of the 20th mesh_hit launch of the
   cpu-semantics render(16), captured as the wavefront hands them over.
   gid must agree on >= 99.9% of lanes and t, u, v pass the lane gate;
   the lanes that differ in gid, t, u and v are printed. Plain, kernel
   and yardstick are timed with CUDA events on a 131,072-ray pool cut
   from the frame and on the in-render pool, in turns plain, kernel,
   per-thread, per-thread, kernel, plain, beside the bound: the walk any
   exact traversal needs on those rays (`walk_work`) in FP32 operations,
   and the bytes of the tables and rays;
8. the integrator paths at full width, each render with the launch
   counts reset just before and read just after, with paths/s, the
   wavefront's iterations and lane-bounces, and the card's name and
   power limit: Renderer(a380-class 1216x608 in cpu semantics,
   "cuda").render(16), the slice's main path (the wavefront, mesh_hit
   launches > 0, no other kernel); the same with direct-light sampling
   (its shadow rays add mesh_hit launches); the a380-class frame and
   the 2,097-triangle surface in gpu semantics through the wavefront
   (use_mesh_fused=False) against mesh_trace's and mesh_trace_brute's
   images (the surface on the brute route whatever the gate says), and
   walled 1200x600 through the wavefront (use_fused=False)
   against trace_tiles' image, at 16 spp, under the tile gate (their
   lane-bounces per path set the fused kernels' bounds); a
   cpu-semantics 96x48 a380-class frame on the card against the CPU; a
   bitwise exact resume on the card in cpu semantics; and torch.profiler
   tables of one warm cpu-semantics render(16) with mesh_hit and with
   the per-thread yardstick in its place: mesh_hit's device ms per
   launch inside the render and its share of device time.

Each kernel's record has its bound (bound_ms, bound_by): the larger of
its bytes over 3.35 TB/s and its FP32 work, counted from the sources,
over 33.5 T FP32 instructions/s (see FP32_CEILING); trace_tiles' work is
counted in instructions under contraction on the plain version's counts
of the launch's lane-bounces by branch and of its near roots.

Any failure raises (exit code != 0). The line before the last is the
kernels' JSON record; the last line is the device JSON object. Without a
CUDA device, or without the repository around it, it fails before
printing either.
"""
import copy
import json
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.abspath(__file__))
W, H = 1200, 600  # the walled benchmark's size
MAIN_SPP = 64
TIMING_SPL = 64  # samples per lane of the main path's launch (MAIN_SPP <= samples_per_launch)
RENDER_REPS = 5  # warm walled renders a turn when the render is timed against the yardstick's
SMS = 132  # the H100 SXM's streaming multiprocessors


def lane_gate(ours, ref):
    """Fraction of lanes off by more than 1e-3 relative, and max |a - b|."""
    import torch

    mismatch = (ours - ref).abs() / (ref.abs() + 1e-3)
    assert bool(torch.isfinite(ours).all()), "non-finite kernel output"
    return float((mismatch > 1e-3).float().mean()), float((ours - ref).abs().max())


def tile_gate(img, ref, t=8):
    import numpy as np

    def tiles(a):
        h, w, _ = a.shape
        return a[: h - h % t, : w - w % t].reshape(h // t, t, w // t, t, 3).mean(axis=(1, 3))

    mean_d = float(np.abs(img.mean(axis=(0, 1)) - ref.mean(axis=(0, 1))).max())
    bad = float((np.abs(tiles(img) - tiles(ref)).max(axis=-1) > 0.06).mean())
    return mean_d, bad


def mixed_scheme(width, height):
    """Spheres + free triangles, two dielectrics with different n, two
    DiffSpecs with different diffp, emissive sphere and triangle
    (the scene of tests/test_pallas.py:203-218)."""
    from raytrace_tpu_torch.models.config import Tagged, parse_member
    from raytrace_tpu_torch.models.walled import walled_scheme

    def sphere(c, r, rgb, mat):
        return Tagged("Sphere", {"c": c, "r": r, "coloring": Tagged("Solid", rgb), "mat": mat})

    def tri(verts, norm, rgb, mat):
        return Tagged("FreeTriangle", {"verts": verts, "norm": norm, "rgb": rgb, "mat": mat})

    s = walled_scheme(width, height, assured=2)
    s.scene_members = [parse_member(m) for m in [
        sphere([0.0, 0.0, -6.0], 1.0, [0.9, 0.9, 0.9],
               {"divert_ray": Tagged("Dielectric", {"n_out": 1.0, "n_in": 1.5})}),
        sphere([2.5, 0.0, -7.0], 1.0, [0.9, 0.6, 0.6],
               {"divert_ray": Tagged("Dielectric", {"n_out": 1.0, "n_in": 1.2})}),
        sphere([0.0, 6.0, -8.0], 2.0, [0, 0, 0], {"divert_ray": "Diff", "emissive": [8, 8, 8]}),
        tri([[-4, -2, -9], [4, -2, -9], [0, -2, -1]], [0, 1, 0], [0.7, 0.7, 0.3],
            {"divert_ray": Tagged("DiffSpec", {"diffp": 0.4})}),
        tri([[-4, 2, -9], [4, 2, -9], [0, 3, -4]], [0, -1, 0], [0.3, 0.7, 0.7],
            {"divert_ray": Tagged("DiffSpec", {"diffp": 0.8})}),
        tri([[-1, -1, -3], [1, -1, -3], [0, 1, -3]], [0, 0, 1], [1, 1, 1],
            {"divert_ray": "Spec", "emissive": [2, 2, 2]}),
    ]]
    return s


MESH_W, MESH_H, MESH_SPP = 1216, 608, 16  # the a380-class cell (scripts/bench_mesh.py)
SUBSET_STRIDE = 22  # 739,328 / 22 -> 33,606 pixels for the timing in turns
GATE_SWEEP = (256, 512, 1024, 2097, 2560)  # triangles of the surface's cuts in the gate sweep
MESH_KERNELS = {  # entry point -> (route, the TPU kernel it replaces)
    "mesh_trace": ("walk", "raytrace_tpu/ops/pallas/mesh_bounce_kernel.py:698"),
    "mesh_trace_brute": ("brute", "raytrace_tpu/ops/pallas/woop.py:268"),
}


def variant(scheme, width=None, height=None, use_gpu=None, dir_light_samp=None):
    """The scheme at another frame size or in other semantics, sharing
    its (large) members."""
    s = copy.copy(scheme)
    info = s.render_info = copy.copy(scheme.render_info)
    info.rad_info = copy.copy(info.rad_info)
    if width is not None:
        info.width, info.height = width, height
    if use_gpu is not None:
        info.use_gpu = use_gpu
    if dir_light_samp is not None:
        info.rad_info.dir_light_samp = dir_light_samp
    return s


def octa_scheme(width, height):
    """Five textured, normal-mapped octahedra (u8 textures from a seed)
    beside an emissive sphere, a dielectric sphere and a DiffSpec free
    triangle: sphere / free-triangle shading inside a mesh scene."""
    import numpy as np
    from raytrace_tpu_torch.models.config import ModelMember, Tagged, parse_scheme
    from raytrace_tpu_torch.models.gltf import LoadedMesh, Primitive, TextureData

    g = np.random.default_rng(7)
    verts = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                     np.float32)
    idx = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                    [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)

    def tex(h, w):
        raw = g.integers(0, 256, (h, w, 3), dtype=np.uint8)
        return TextureData(pixels=raw.astype(np.float32) / 255.0,
                           coords=g.uniform(0, 1, (6, 2)).astype(np.float32), pixels_raw=raw)

    prims = []
    for i in range(5):
        rgb = tex(8, 16)
        prims.append(Primitive(
            poses=verts * (0.8 + 0.1 * (i % 3)) + np.array([-4.0 + 2.1 * i, 0.3 * (i % 2), 0.0],
                                                         np.float32),
            norms=verts, indices=idx, rgb_factor=np.array([0.8, 0.7, 0.6], np.float32),
            rgb_tex=rgb, norm_tex=TextureData(pixels=rgb.pixels, coords=rgb.coords,
                                              pixels_raw=rgb.pixels_raw) if i % 2 else None,
            norm_scale=0.9, metal_factor=0.3, rough_factor=0.5, mr_tex=tex(4, 4)))

    def sphere(c, r, rgb, mat):
        return Tagged("Sphere", {"c": c, "r": r, "coloring": Tagged("Solid", rgb), "mat": mat})

    s = parse_scheme({
        "render_info": {"width": width, "height": height, "samps_per_pix": 4,
                        "rad_info": {"russ_roull_info": {"assured_depth": 3, "max_thres": 0.5}},
                        "use_gpu": True},
        "cam": {"d": [0, 0, 6], "up": [0, 1, 0], "o": [0, 0, -14],
                "screen_width": 8.0, "screen_height": 4.0},
        "scene_members": [
            sphere([0, 60, -30], 40, [0, 0, 0], {"divert_ray": "Diff", "emissive": [2, 2, 2]}),
            sphere([2.5, -1.0, -3.0], 1.0, [0.9, 0.9, 0.9],
                   {"divert_ray": Tagged("Dielectric", {"n_out": 1.0, "n_in": 1.5})}),
            Tagged("FreeTriangle", {"verts": [[-9, -2, -6], [9, -2, -6], [0, -2, 6]],
                                    "norm": [0, 1, 0], "rgb": [0.7, 0.7, 0.3],
                                    "mat": {"divert_ray": Tagged("DiffSpec", {"diffp": 0.4})}}),
        ],
    })
    s.scene_members.append(ModelMember(path="<octahedra>", loaded=[
        LoadedMesh(primitives=prims, trans_mat=np.eye(4, dtype=np.float32))]))
    return s


def mesh_phases(dev, card, variants):
    """Phases 5 and 6 (variants: the group sweep's builds, {G: Built});
    returns the mesh kernels' JSON records and, for each, its scene's
    sphere, free-triangle and triangle counts and table bytes."""
    import numpy as np
    import torch

    from raytrace_tpu_torch.models import procedural
    from raytrace_tpu_torch.models.camera import build_camera
    from raytrace_tpu_torch.models.config import ModelMember
    from raytrace_tpu_torch.models.scene import build_scene
    from raytrace_tpu_torch.ops import mesh_kernel as mk
    from raytrace_tpu_torch.render.renderer import Renderer
    from raytrace_tpu_torch.utils import checkpoint as ckpt

    t0 = time.perf_counter()
    a380 = procedural.a380_scheme(MESH_W, MESH_H, MESH_SPP)
    surface = procedural.a380_cam_scheme(MESH_W, MESH_H, MESH_SPP)
    surface.scene_members.append(ModelMember(
        path="<2,097-triangle surface>", loaded=[procedural.make_mesh(2097, n_textures=0)]))
    print(f"[mesh] schemes and textures generated in {time.perf_counter() - t0:.3f} s",
          flush=True)

    def setup(label, scheme):
        w, h = scheme.render_info.width, scheme.render_info.height
        t0 = time.perf_counter()
        scene = build_scene(scheme)
        t1 = time.perf_counter()
        tables = mk.MeshTables(scene, build_camera(scheme.cam, w, h),
                               scheme.render_info.rad_info.russ_roull_info.max_thres).to(dev)
        torch.cuda.synchronize()
        print(f"[mesh] {label} host set-up: build_scene (clusters, texel pool) {t1 - t0:.3f} s, "
              f"MeshTables (packing, copy to the card) {time.perf_counter() - t1:.3f} s",
              flush=True)
        return scene, tables

    def lanes(w, h, stride):
        flat = torch.arange(0, w * h, stride, dtype=torch.int32, device=dev)
        return flat % w, flat // w

    def timed_run(fn, tables, xs, ys, base, spl, route, assured):
        """One launch, timed with CUDA events: (output, ms)."""
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn(xs, ys, torch.full_like(xs, base), tables, route=route, assured=assured,
                 max_bounces=24, samples_per_lane=spl)
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)

    def parity(label, name, tables, xs, ys, spl, route, assured, exact):
        """Kernel vs plain on the same lanes; returns the plain version's ms.
        exact: no lane may differ; else the lane gate."""
        ours, k_ms = timed_run(mk.mesh_trace, tables, xs, ys, 7, spl, route, assured)
        ref, p_ms = timed_run(mk.mesh_trace_reference, tables, xs, ys, 7, spl, route, assured)
        for k in range(3):
            bad, e = lane_gate(ours[k], ref[k])
            err[name] = max(err[name], e)
            print(f"[parity] {label} {name} {xs.numel()} lanes spl={spl} channel {k}: "
                  f"bad-lane fraction {bad:.6f} max|d| {e:.3e}", flush=True)
            assert bad < 0.01, f"{label} {name} spl={spl}: {bad:.4f} of lanes differ"
        differ = int((torch.stack(ours) != torch.stack(ref)).any(0).sum())
        print(f"[parity] {label} {name} {xs.numel()} lanes spl={spl}: {differ} lanes differ "
              f"from the plain version; radiance mean "
              f"{[round(float(o.mean()) / spl, 6) for o in ours]}; kernel {k_ms:.3f} ms, "
              f"plain {p_ms:.3f} ms (one launch each) [{card}]", flush=True)
        assert not (exact and differ), f"{label} {name} spl={spl}: {differ} lanes differ"
        return p_ms

    def timed(fn, tables, xs, ys, spl, route, reps):
        run_once = lambda: fn(xs, ys, torch.zeros_like(xs), tables, route=route, assured=5,
                              max_bounces=24, samples_per_lane=spl)
        run_once()  # warm-up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run_once()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    def turns(label, tables, xs, ys, spl, order, reps):
        """(kind, fn, route) of `order` timed in turns; mean ms per launch of
        each kind."""
        t = {}
        for kind, fn, route in order:
            t.setdefault(kind, []).append(timed(fn, tables, xs, ys, spl, route, reps))
            print(f"[timing] {kind} {label} {xs.numel()} lanes spl={spl}: {t[kind][-1]:.3f} "
                  f"ms/launch [{card}]", flush=True)
        return {k: sum(v) / len(v) for k, v in t.items()}

    # ---- 5. kernel vs plain on the card ----
    # the whole 1216x608 frame of each route at the main path's launch
    # shape (spl MESH_SPP) and at spl 1 and 4, no lane may differ; the
    # mixed octahedra on both routes under the lane gate
    err = {name: 0.0 for name in MESH_KERNELS}
    ms, plain_ms, yard_ms, shape, kept = {}, {}, {}, {}, {}
    fx, fy = lanes(MESH_W, MESH_H, 1)
    for label, scheme, name in (("a380-class", a380, "mesh_trace"),
                                ("surface-2097", surface, "mesh_trace_brute")):
        scene, tables = setup(label, scheme)
        route = MESH_KERNELS[name][0]
        tables.route = route  # whatever the gate says
        print(f"[parity] {label}: {scene.n_mesh_tris} triangles, {scene.n_clusters} clusters, "
              f"pool {scene.tex_pool.dtype} x {scene.tex_pool.size}, route {route}", flush=True)
        for spl in (1, 4, MESH_SPP):
            plain_ms[name] = parity(label, name, tables, fx, fy, spl, route, 5, exact=True)
        # the yardstick (the entry's first design) on the same launch
        zero = torch.zeros_like(fx)
        new = torch.stack(mk.mesh_trace(fx, fy, zero, tables, route=route, assured=5,
                                        max_bounces=24, samples_per_lane=MESH_SPP))
        old = torch.stack(mk._mesh_trace_yardstick(fx, fy, zero, tables, route=route, assured=5,
                                                   max_bounces=24, samples_per_lane=MESH_SPP))
        print(f"[parity] {label} {name} yardstick {mk.YARDSTICKS[route]} spl={MESH_SPP}: "
              f"{int((new != old).any(0).sum())} lanes differ from the kernel", flush=True)
        # the main path's launch: the kernel against its yardstick in turns
        t = turns(f"{name} vs {mk.YARDSTICKS[route]} {label} {MESH_W}x{MESH_H}", tables, fx, fy,
                  MESH_SPP, [("new", mk.mesh_trace, route),
                             ("old", mk._mesh_trace_yardstick, route),
                             ("old", mk._mesh_trace_yardstick, route),
                             ("new", mk.mesh_trace, route)], 2)
        ms[name], yard_ms[name] = t["new"], t["old"]
        print(f"[timing] {name} {label} {MESH_W}x{MESH_H} spl={MESH_SPP}: kernel {ms[name]:.3f} "
              f"ms/launch ({MESH_W * MESH_H * MESH_SPP / ms[name] / 1e3:.1f} Mpaths/s), yardstick "
              f"{mk.YARDSTICKS[route]} {yard_ms[name]:.3f} ms ({yard_ms[name] / ms[name]:.2f}x), "
              f"plain {plain_ms[name]:.3f} ms/launch [{card}]", flush=True)
        # both versions on a strided subset, in turns plain, kernel, kernel, plain
        xs, ys = lanes(MESH_W, MESH_H, SUBSET_STRIDE)
        for kind, fn, reps in (("plain", mk.mesh_trace_reference, 1), ("kernel", mk.mesh_trace, 5),
                               ("kernel", mk.mesh_trace, 5),
                               ("plain", mk.mesh_trace_reference, 1)):
            print(f"[timing] {kind} {name} {label} subset of {xs.numel()} lanes spl=1: "
                  f"{timed(fn, tables, xs, ys, 1, route, reps):.3f} ms/launch [{card}]",
                  flush=True)
        # what the bound of the launch is reckoned from (main)
        shape[name] = dict(n_sph=tables.n_sph, n_ft=tables.n_ft, n_tris=tables.n_tris,
                           table_bytes=tensor_bytes(tables.buffers()))
        kept[label] = (tables, fx, fy, route)

    _, tables = setup("octahedra", octa_scheme(64, 32))
    xs, ys = lanes(64, 32, 1)
    for route, name in (("walk", "mesh_trace"), ("brute", "mesh_trace_brute")):
        for spl in (1, 4):
            parity("octahedra", name, tables, xs, ys, spl, route, 3, exact=False)

    # the gate sweep: both routes on cuts of the surface, the whole frame
    sweep = {}
    for n in GATE_SWEEP:
        cut = procedural.a380_cam_scheme(MESH_W, MESH_H, MESH_SPP)
        cut.scene_members.append(ModelMember(path=f"<{n}-triangle surface>",
                                             loaded=[procedural.make_mesh(n, n_textures=0)]))
        _, tables = setup(f"surface-{n}", cut)
        zero = torch.zeros_like(fx)
        out = {r: mk.mesh_trace(fx, fy, zero, tables, route=r, assured=5, max_bounces=24,
                                samples_per_lane=MESH_SPP) for r in ("walk", "brute")}
        bad = max(lane_gate(out["brute"][k], out["walk"][k])[0] for k in range(3))
        differ = int((torch.stack(out["brute"]) != torch.stack(out["walk"])).any(0).sum())
        print(f"[gate] surface-{n}: brute vs walk, {differ} lanes differ, bad-lane fraction "
              f"{bad:.6f}", flush=True)
        assert bad < 0.01, f"surface-{n}: the two routes disagree on {bad:.4f} of lanes"
        sweep[n] = turns(f"surface-{n} {MESH_W}x{MESH_H}", tables, fx, fy, MESH_SPP,
                         [(r, mk.mesh_trace, r) for r in ("walk", "brute", "brute", "walk")], 2)
        print(f"[gate] surface-{n}: walk {sweep[n]['walk']:.3f} ms, brute "
              f"{sweep[n]['brute']:.3f} ms per launch ({sweep[n]['brute'] / sweep[n]['walk']:.2f}x)"
              f" [{card}]", flush=True)
    crossover = max((n for n, t in sweep.items() if t["brute"] < t["walk"]), default=0)
    print(f"[gate] the largest cut at which the brute route is faster: {crossover} triangles "
          f"(0: none); MAX_BRUTE_TRIS = {mk.MAX_BRUTE_TRIS}, "
          f"{'the same' if crossover == mk.MAX_BRUTE_TRIS else 'NOT the same'} [{card}]",
          flush=True)

    # the group sweep: 8, 16 and 32 threads per ray of both entries
    from torch_mesh_trace_groups import sweep as group_sweep

    group_sweep(card, kept, variants)
    del tables, kept

    # ---- 6. the mesh main paths ----
    launches, profiled = {}, None
    for label, scheme, name in (("a380-class", a380, "mesh_trace"),
                                ("surface-2097", surface, "mesh_trace_brute")):
        t0 = time.perf_counter()
        renderer = Renderer(scheme, device="cuda")
        renderer.tables.route = MESH_KERNELS[name][0]  # whatever the gate says
        torch.cuda.synchronize()
        print(f"[mesh] Renderer({label}, cuda) constructed in {time.perf_counter() - t0:.3f} s "
              f"(host set-up)", flush=True)
        for k in mk.LAUNCHES:
            mk.LAUNCHES[k] = 0
        t0 = time.perf_counter()
        img = renderer.render(samples=MESH_SPP)  # ends in a device -> host copy
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches[name] = mk.LAUNCHES[name]
        print(f"[mesh] Renderer({label} {MESH_W}x{MESH_H}, cuda).render({MESH_SPP}): {dt:.4f} s, "
              f"{MESH_W * MESH_H * MESH_SPP / dt:.1f} paths/s, {name} launches "
              f"{launches[name]} (all: {dict(mk.LAUNCHES)}) [{card}]", flush=True)
        assert launches[name] > 0, f"the {label} main path did not launch {name}"
        assert img.shape == (MESH_H, MESH_W, 3) and np.isfinite(img).all(), "bad image"
        print(f"[mesh] {label} image mean per channel {img.mean(axis=(0, 1)).tolist()}",
              flush=True)
        if name == "mesh_trace":  # the warm render, profiled
            profiled = profile(renderer, card, "mesh_trace_kernel",
                               f"a380-class gpu semantics {MESH_W}x{MESH_H}")

    small = variant(a380, 96, 48)
    t0 = time.perf_counter()
    cpu_img = Renderer(small, device="cpu").render(samples=MESH_SPP)
    cpu_s = time.perf_counter() - t0
    gpu_img = Renderer(small, device="cuda").render(samples=MESH_SPP)
    mean_d, bad_tiles = tile_gate(gpu_img, cpu_img)
    print(f"[mesh] a380-class 96x48x{MESH_SPP} card vs cpu ({cpu_s:.1f} s on the cpu): "
          f"channel-mean |d| {mean_d:.3e}, bad 8x8 tiles {bad_tiles:.4f}", flush=True)
    assert mean_d < 2e-3 and bad_tiles < 0.02, "card render disagrees with the CPU render"

    k = 4
    full = Renderer(a380, device="cuda")
    full.render(samples=2 * k, batch=k)
    first = Renderer(a380, device="cuda")
    first.render(samples=k)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        path = os.path.join(tmp, "ck.npz")
        ckpt.save(path, first.target)
        resumed = Renderer(a380, device="cuda")
        resumed.target = ckpt.load(path)
    resumed.render(samples=k)
    assert resumed.target.count == full.target.count == 2 * k
    assert np.array_equal(resumed.target.acc, full.target.acc), "resume is not bitwise exact"
    print(f"[mesh] resume at {k} spp: bitwise exact ({2 * k} spp, a380-class "
          f"{MESH_W}x{MESH_H})", flush=True)

    records = [{"name": name, "route": "cuda", "source": "raytrace_tpu_torch/csrc/mesh_kernel.cu",
                "replaces": replaces, "launches": launches[name], "max_abs_err": err[name],
                "ms": ms[name], "plain_ms": plain_ms[name], "library_ms": None,
                "launches_per_render": launches[name], "yardstick_ms": yard_ms[name]}
               for name, (_, replaces) in MESH_KERNELS.items()]
    if profiled:
        records[0]["in_render_ms"] = profiled["ms"]
    return records, shape


WALLED_WF_SPP = 16  # the walled frame through the wavefront (trace_tiles takes 64 in phase 4)
HIT_POOL = 1 << 17  # the wavefront's lane pool: the launch shape of mesh_hit
CAPTURE_ITER = 20  # the wavefront iteration whose mesh_hit launch is the in-render pool

# The least time of a launch (bound_ms): the larger of its bytes (each input
# read once, each output written once) over the memory rate and its FP32
# operations over the FP32 ceiling of its build (H100 SXM at 700 W, outside
# the tensor cores). Operations per test or shade are counted from the CUDA
# sources, each multiply, add, min, max, compare, divide and square root
# one; loads, the RNG's integer work and branches are not counted, so each
# bound is low. The 67 TFLOP/s peak counts an FMA as two operations (132
# SMs x 128 FP32 lanes x 2 x 1.98 GHz). mesh_kernel.cu is built with
# -fmad=false (kernels/build.py), so none of its multiplies and adds fuse:
# each counted operation is one instruction, and its ceiling is 33.5 T
# instructions/s. trace_kernel.cu keeps contraction, so its work is counted
# in FP32 instructions under contraction (a multiply that feeds an add is
# one FFMA), from trace_kernel.cu's closest_hit, shade and start_sample: a
# compare or min / max one, a draw's scale to [0, 1] one, a square root,
# reciprocal square root, sine or cosine one (their multi-instruction
# sequences are not counted), selects, integer work, loads and branches
# none. What depends on the data is counted from this run's data: the
# plain version counts the launch's lane-iterations by branch and the
# sphere tests that take the near root (trace_tiles_reference's
# return_iters), and each branch is counted along its shortest way through
# the source (below). Not counted, so the bound stays low: an emissive
# hit's radiance add (9), the Russian roulette's test on a hit that
# survives it (2), a DiffSpec's choice of lobe (3), a dielectric's
# refraction beyond its total internal reflection (17). Its ceiling is the same
# 33.5 T instructions/s. (The earlier bound held it to 67 TFLOP/s with every
# operation counted apart, which assumed every operation fused; printed
# beside.)
FP32_PEAK = 67e12  # FP32 FLOP/s, an FMA two
FP32_SINGLE = 33.5e12  # FP32 instructions/s (132 SMs x 128 lanes x 1.98 GHz)
FP32_CEILING = {"trace_tiles": FP32_SINGLE, "mesh_trace": FP32_SINGLE,
                "mesh_trace_brute": FP32_SINGLE, "mesh_hit": FP32_SINGLE}
HBM_RATE = 3.35e12  # bytes/s
SLAB_OPS = 25  # mesh_kernel.cu slab_span (6 sub, 6 mul, 10 min/max) + 3 compares
TRI_OPS = 55  # path_common.cuh tri_hit (53) + the t_min and running-best compares
SPH_OPS = 18  # path_common.cuh closest_sph_ft, one sphere: up to the disc > 0 test
SHADE_SPH_OPS = 93  # shade_sph_ft, diffuse lobe (88) + 5 draws' float conversion
SHADE_MESH_OPS = 204  # mesh_kernel.cu shade_mesh without a normal map (196) + 8 draws
# trace_kernel.cu in FP32 instructions under contraction (see FP32_CEILING):
SPH_INSTR = 13  # closest_hit, one sphere: oc 3 FADD, dirv FMUL + 2 FFMA, consts FMUL +
# 2 FFMA + FADD (the staged r^2), disc FFMA, disc > 0 and dirv < 0
ROOT_INSTR = 4  # a sphere test that takes the near root: the square root, -dirv - root,
# t_near > 0 and t_near < t_best
TRI_INSTR = 39  # tri_hit: pv 6, det 3, |det| 1, 1/det 1, h 3, u 4, q 6, w 4, t 4,
# the five range compares and u + w 6, t < t_best 1
RAYGEN_INSTR = 20  # start_sample without a lens, once a path: 2 draws, the jitter 4,
# the direction 6 FFMA, its normalize 8
# shade by branch (return_iters' BRANCHES). A hit: the point 3 FFMA, a sphere's normal 11
# (3 FADD, the normalize 8: the walled scene has no free triangles), has_em 1, the
# colour 3 FMUL: 18. A hit that survives the roulette: d.n 3, inten *= weight 1, the
# next origin 3 FFMA: 7 more, and its lobe: diffuse 41 (the kind's 2 compares, xd 3,
# its normalize 8, yd 6, 2 draws 2, sqrt u1 with its zero test 2, the angle 1, sine
# and cosine 2, ca sa 2, zz 4, the direction 9); mirror 7 (3 compares, the reflection
# 4); dielectric 10 along its total internal reflection (compare 1, into 1, c22 3 and
# its test 1, the reflection 4; a refraction takes 17 more: its root with the
# argument's test 2, k_t 1, t 6, ct 4, ct2 1, re 4, the draw and its compare 2, less the
# reflection's 4, plus the weight 1). The roulette: its draw and test 2, the radiance
# add 6 (cir * inv_thres once, an FFMA a channel). A miss: its weight record 3 FMUL.
SHADE_INSTR = {"miss": 3, "diffuse": 18 + 7 + 41, "mirror": 18 + 7 + 7,
               "dielectric": 18 + 7 + 10, "roulette": 18 + 2 + 6}


def bound(ops, nbytes, name):
    """(bound_ms, bound_by) of a launch of kernel `name` doing `ops` FP32
    operations and moving `nbytes` bytes."""
    ops_ms, bytes_ms = ops / FP32_CEILING[name] * 1e3, nbytes / HBM_RATE * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def tensor_bytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


HIT_TABLES = ("sgbounds", "sbounds", "bounds", "count", "tri", "gid")


def hit_work(o, d, t, tables, t_min):
    """mesh_hit's least work on these rays: (ops, bytes, walk_work's counts);
    t is the rays' final nearest t."""
    from raytrace_tpu_torch.ops import mesh_kernel as mk

    work = mk.walk_work(o, d, t, tables, t_min=t_min)
    ops = sum(work["slab"]) * SLAB_OPS + work["tri"] * TRI_OPS
    moved = tensor_bytes(getattr(tables, k) for k in HIT_TABLES) + t.numel() * (7 * 4 + 4 * 4)
    return ops, moved, work


def frame_rays(dev, a380):
    """The a380-class scene on the card and the rays of phase 7's frame pool:
    the primary rays of the whole 1216x608 frame in the wavefront's tile
    order, then the secondary rays of one cpu-semantics bounce (lanes whose
    path ended keep their primary ray), every fourth lane dead (seeded
    -inf), the others seeded INF. Returns (scene, o, d, seed, dead, n)."""
    import torch

    from raytrace_tpu_torch.models.camera import build_camera
    from raytrace_tpu_torch.models.scene import SceneTensors, build_scene
    from raytrace_tpu_torch.ops import raygen, rng
    from raytrace_tpu_torch.ops.intersect import INF
    from raytrace_tpu_torch.render import integrator as itg
    from raytrace_tpu_torch.render.renderer import tile_order

    scene = SceneTensors(build_scene(a380), build_camera(a380.cam, MESH_W, MESH_H),
                         a380.render_info.rad_info.russ_roull_info.max_thres).to(dev)
    order = torch.from_numpy(tile_order(MESH_W, MESH_H)).to(dev)
    xs, ys = (order % MESH_W).int(), (order // MESH_W).int()
    state, ro, rd = raygen.generate_paths(rng.init_state(xs, ys, torch.zeros_like(xs)), xs, ys,
                                          scene.cam, scene.has_lens)
    params = itg.IntegratorParams(mode="cpu", assured_depth=5, max_bounces=24)
    st = itg._bounce_step(scene, params, itg.init_lanes(scene, params, ro, rd, state))
    n = xs.numel()
    o = tuple(torch.cat([ro[k], st["ro"][k]]).contiguous() for k in range(3))
    d = tuple(torch.cat([rd[k], st["rd"][k]]).contiguous() for k in range(3))
    dead = torch.arange(2 * n, device=dev) % 4 == 3
    seed = torch.where(dead, torch.full_like(o[0], itg.DEAD_SEED), torch.full_like(o[0], INF))
    print(f"[hit] a380-class {MESH_W}x{MESH_H}: {n} primary + {n} secondary rays "
          f"({int(st['active'].sum())} lanes survived the bounce), {int(dead.sum())} dead",
          flush=True)
    return scene, o, d, seed, dead, n


def frame_pool(o, d, seed, n):
    """The wavefront's launch shape cut from the frame's rays: HIT_POOL
    rays, half primary and half secondary, a quarter dead."""
    import torch

    half = HIT_POOL // 2
    pick = torch.cat([torch.arange(half), torch.arange(n, n + half)]).to(seed.device)
    return tuple(c[pick] for c in o), tuple(c[pick] for c in d), seed[pick]


def in_render_pool(scheme):
    """The rays, seeds, t_min and tables of the CAPTURE_ITER-th mesh_hit
    launch of Renderer(scheme, "cuda").render(MESH_SPP): one mid-render
    wavefront iteration's lanes, as the render hands them to the kernel
    (the integrator's mesh_hit is wrapped for this one render)."""
    from raytrace_tpu_torch.render import integrator as itg
    from raytrace_tpu_torch.render.renderer import Renderer

    real, calls, pool = itg.mesh_hit, [0], {}

    def capture(o, d, seed, tables, *, t_min):
        calls[0] += 1
        if calls[0] == CAPTURE_ITER:
            pool.update(o=tuple(c.clone() for c in o), d=tuple(c.clone() for c in d),
                        seed=seed.clone(), t_min=t_min, tables=tables)
        return real(o, d, seed, tables, t_min=t_min)

    itg.mesh_hit = capture
    try:
        Renderer(scheme, device="cuda").render(samples=MESH_SPP)
    finally:
        itg.mesh_hit = real
    assert pool, f"the render made fewer than {CAPTURE_ITER} mesh_hit launches"
    return pool


def hit_parity(label, ours, ref, seed, t_min):
    """Gates the kernel's (t, gid, u, v) against the plain walk's and prints
    the lanes that differ; returns max |d| of t, u, v on equal hits."""
    import torch

    dead = ~(seed > t_min)
    g, rg = ours[1].long(), ref[1]
    assert bool((g[dead] == -1).all()) and bool((ours[0][dead] == seed[dead]).all()), \
        f"{label}: a dead lane reached the mesh"
    same = g == rg
    agree = float(same.float().mean())
    live = ~dead
    line = [f"[hit] {label} t_min {t_min:.4g}: {int((rg >= 0).sum())} hits of {rg.numel()} rays "
            f"({int(dead.sum())} dead); lanes that differ: gid {int((~same).sum())}"]
    for k, name in ((0, "t"), (2, "u"), (3, "v")):
        line.append(f"{name} {int((ours[k] != ref[k]).sum())}")
    err = 0.0
    for k, name in ((0, "t"), (2, "u"), (3, "v")):
        a, b = ours[k][live], ref[k][live]
        bad, _ = lane_gate(a, b)
        both = same[live] & (rg[live] >= 0)
        e = float((a[both] - b[both]).abs().max()) if bool(both.any()) else 0.0
        err = max(err, e)
        line.append(f"{name} bad-lane fraction {bad:.6f} max|d| on equal hits {e:.3e}")
        assert bad < 0.01, f"{label} t_min {t_min}: {name} differs on {bad:.4f} of lanes"
    print("; ".join(line), flush=True)
    assert agree >= 0.999, f"{label} t_min {t_min}: gid agrees on only {agree:.5f}"
    torch.cuda.synchronize()
    return err


def time_hit_turns(label, pool, card, fns):
    """Each (kind, fn, reps) of `fns` timed with CUDA events on the pool
    (o, d, seed, t_min, tables), in the given turns; mean ms per launch of
    each kind."""
    import torch

    o, d, seed, t_min, tables = pool
    t = {}
    for kind, fn, reps in fns:
        fn(o, d, seed, tables, t_min=t_min)  # warm-up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(o, d, seed, tables, t_min=t_min)
        end.record()
        end.synchronize()
        t.setdefault(kind, []).append(start.elapsed_time(end) / reps)
        print(f"[timing] {kind} mesh_hit {label} ({seed.numel()} rays): {t[kind][-1]:.4f} "
              f"ms/launch [{card}]", flush=True)
    return {k: sum(v) / len(v) for k, v in t.items()}


def mesh_hit_phase(dev, card, a380):
    """Phase 7: `mesh_hit` (the CUDA entry) against `mesh_hit_walk` (its
    plain version) and the per-thread yardstick on the card. Returns the
    record's numbers on the in-render pool, the main path's input:
    {max_abs_err, ms, plain_ms, bound_ms, bound_by, walk_ops_per_ray}."""
    from raytrace_tpu_torch.ops import mesh_kernel as mk
    from raytrace_tpu_torch.ops.intersect import EPS
    from raytrace_tpu_torch.render import integrator as itg

    scene, o, d, seed, dead, n = frame_rays(dev, a380)
    err = 0.0
    walk_ops_per_ray = 0.0
    for t_min in (EPS, itg.CPU_GUARD):
        ref = mk.mesh_hit_walk(o, d, seed, scene.mesh, t_min=t_min)
        err = max(err, hit_parity("frame", mk.mesh_hit(o, d, seed, scene.mesh, t_min=t_min),
                                  ref, seed, t_min))
        hit_parity("frame, per-thread yardstick",
                   mk._mesh_hit_per_thread(o, d, seed, scene.mesh, t_min=t_min), ref, seed, t_min)
        if t_min == EPS:  # gpu semantics: the walk mesh_trace does per lane-bounce
            ops, _, work = hit_work(o, d, ref[0], scene.mesh, t_min)
            walk_ops_per_ray = ops / work["rays"]

    inr = in_render_pool(a380)
    print(f"[hit] in-render pool: mesh_hit launch {CAPTURE_ITER} of a380-class cpu semantics "
          f"render({MESH_SPP}), {inr['seed'].numel()} rays", flush=True)
    ref = mk.mesh_hit_walk(inr["o"], inr["d"], inr["seed"], inr["tables"], t_min=inr["t_min"])
    err = max(err, hit_parity("in-render", mk.mesh_hit(inr["o"], inr["d"], inr["seed"],
                                                       inr["tables"], t_min=inr["t_min"]),
                              ref, inr["seed"], inr["t_min"]))
    inr["t"] = ref[0]

    po, pd, ps = frame_pool(o, d, seed, n)
    fref = mk.mesh_hit_walk(po, pd, ps, scene.mesh, t_min=itg.CPU_GUARD)
    pools = {"frame pool": (po, pd, ps, itg.CPU_GUARD, scene.mesh, fref[0]),
             "in-render pool": (inr["o"], inr["d"], inr["seed"], inr["t_min"], inr["tables"],
                                inr["t"])}
    turns = [("plain", mk.mesh_hit_walk, 2), ("kernel", mk.mesh_hit, 20),
             ("per-thread", mk._mesh_hit_per_thread, 20),
             ("per-thread", mk._mesh_hit_per_thread, 20), ("kernel", mk.mesh_hit, 20),
             ("plain", mk.mesh_hit_walk, 2)]
    for label, (po, pd, ps, t_min, tables, t) in pools.items():
        ms = time_hit_turns(label, (po, pd, ps, t_min, tables), card, turns)
        ops, nbytes, work = hit_work(po, pd, t, tables, t_min)
        b_ms, b_by = bound(ops, nbytes, "mesh_hit")
        print(f"[bound] mesh_hit {label}: walk_work {work} (live rays, slab tests per level, "
              f"triangle tests): {ops:.4g} FP32 ops ({ops / FP32_SINGLE * 1e3:.5f} ms at 33.5 T "
              f"single instructions/s; {ops / FP32_PEAK * 1e3:.5f} at 67 TFLOP/s), {nbytes:.4g} "
              f"bytes ({nbytes / HBM_RATE * 1e3:.5f} ms at 3.35 TB/s): "
              f"bound {b_ms:.5f} ms by {b_by}; kernel {ms['kernel']:.4f} ms "
              f"({b_ms / ms['kernel']:.2%} of the bound reached), per-thread "
              f"{ms['per-thread']:.4f} ms, plain {ms['plain']:.4f} ms [{card}]", flush=True)
    return dict(max_abs_err=err, ms=ms["kernel"], plain_ms=ms["plain"], bound_ms=b_ms,
                bound_by=b_by, walk_ops_per_ray=walk_ops_per_ray)


def integrator_phases(dev, card):
    """Phases 7 and 8; returns the mesh_hit kernel's JSON record and the
    counts the fused kernels' bounds are reckoned from: lane-bounces per
    path of the walled, a380-class and 2,097-triangle frames in gpu
    semantics, and mesh_hit's least walk per ray."""
    import numpy as np
    import torch

    from raytrace_tpu_torch.models import procedural
    from raytrace_tpu_torch.models.config import ModelMember
    from raytrace_tpu_torch.models.walled import walled_scheme
    from raytrace_tpu_torch.ops import mesh_kernel as mk
    from raytrace_tpu_torch.ops import trace_kernel as tk
    from raytrace_tpu_torch.render import integrator as itg
    from raytrace_tpu_torch.render.renderer import Renderer
    from raytrace_tpu_torch.render.target import RenderTarget
    from raytrace_tpu_torch.utils import checkpoint as ckpt

    a380 = procedural.a380_scheme(MESH_W, MESH_H, MESH_SPP)
    a380_cpu = variant(a380, use_gpu=False)

    # ---- 7. mesh_hit against its plain version on the card ----
    hit = mesh_hit_phase(dev, card, a380_cpu)

    # ---- 8. the integrator paths at full width ----
    def reset():
        tk.LAUNCHES = 0
        for k in mk.LAUNCHES:
            mk.LAUNCHES[k] = 0

    def render(label, scheme, spp, route=None, **kw):
        """One warm render (a 1-spp render first, then a fresh target)
        with the counts reset just before and read just after; `route`
        sets the mesh tables' route whatever the gate says."""
        w, h = scheme.render_info.width, scheme.render_info.height
        r = Renderer(scheme, device="cuda", **kw)
        if route is not None:
            r.tables.route = route
        r.render(samples=1)  # loads the torch kernels it uses, grows the allocator
        r.target = RenderTarget(w, h)
        torch.cuda.synchronize()
        reset()
        t0 = time.perf_counter()
        img = r.render(samples=spp)  # ends in a device -> host copy
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        counts = dict(mk.LAUNCHES, trace_tiles=tk.LAUNCHES)
        print(f"[paths] Renderer({label} {w}x{h}, cuda{''.join(f', {k}={v}' for k, v in kw.items())})"
              f".render({spp}): {dt:.4f} s, {w * h * spp / dt:.1f} paths/s, {r.mode} semantics, "
              f"driver {r.driver}, stats {r.stats}, launches {counts} [{card}]", flush=True)
        assert img.shape == (h, w, 3) and np.isfinite(img).all(), f"{label}: bad image"
        print(f"[paths] {label} image mean per channel {img.mean(axis=(0, 1)).tolist()}",
              flush=True)
        return r, img, counts

    def gate(label, img, ref):
        mean_d, bad_tiles = tile_gate(img, ref)
        print(f"[paths] {label}: channel-mean |d| {mean_d:.3e}, bad 8x8 tiles {bad_tiles:.4f}",
              flush=True)
        assert mean_d < 2e-3 and bad_tiles < 0.02, f"{label}: the images disagree"

    # the slice's main path: cpu semantics through the wavefront
    def only_mesh_hit(counts):
        others = {k: v for k, v in counts.items() if k != "mesh_hit"}
        return counts["mesh_hit"] > 0 and not any(others.values())

    r, _, counts = render("a380-class", a380_cpu, MESH_SPP)
    launches = counts["mesh_hit"]
    assert r.driver == "wavefront" and only_mesh_hit(counts), \
        "the main path did not launch mesh_hit, or launched another CUDA kernel"
    _, _, dls = render("a380-class DLS", variant(a380_cpu, dir_light_samp=True), MESH_SPP)
    assert only_mesh_hit(dls) and dls["mesh_hit"] > launches, \
        "the shadow rays did not go through mesh_hit"

    # gpu semantics through the wavefront against the fused mesh kernels;
    # the wavefront's lane-bounces per path set the fused kernels' bounds
    per_path = {}

    def against_fused(label, scheme, spp, name, **kw):
        r, wf_img, counts = render(label, scheme, spp, **kw)
        assert counts[name] == 0 and (counts["mesh_hit"] > 0) == (name != "trace_tiles")
        w, h = scheme.render_info.width, scheme.render_info.height
        per_path[name] = r.stats["lane_bounces"] / (w * h * spp)
        route = MESH_KERNELS[name][0] if name in MESH_KERNELS else None
        _, fused_img, counts = render(label, scheme, spp, route=route)
        assert counts[name] > 0 and counts["mesh_hit"] == 0
        gate(f"{label} {w}x{h}x{spp} wavefront vs {name}", wf_img, fused_img)

    against_fused("a380-class", a380, MESH_SPP, "mesh_trace", use_mesh_fused=False)
    surface = procedural.a380_cam_scheme(MESH_W, MESH_H, MESH_SPP)
    surface.scene_members.append(ModelMember(
        path="<2,097-triangle surface>", loaded=[procedural.make_mesh(2097, n_textures=0)]))
    against_fused("surface-2097", surface, MESH_SPP, "mesh_trace_brute", use_mesh_fused=False)
    against_fused("walled", walled_scheme(W, H), WALLED_WF_SPP, "trace_tiles", use_fused=False)
    print(f"[bound] lane-bounces per path through the wavefront, gpu semantics: {per_path}",
          flush=True)

    small = variant(a380_cpu, 96, 48)
    t0 = time.perf_counter()
    cpu_img = Renderer(small, device="cpu").render(samples=MESH_SPP)
    cpu_s = time.perf_counter() - t0
    gpu_img = Renderer(small, device="cuda").render(samples=MESH_SPP)
    gate(f"a380-class cpu semantics 96x48x{MESH_SPP} card vs cpu ({cpu_s:.1f} s on the cpu)",
         gpu_img, cpu_img)

    k = 4
    full = Renderer(a380_cpu, device="cuda")
    full.render(samples=2 * k, batch=k)
    first = Renderer(a380_cpu, device="cuda")
    first.render(samples=k)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        path = os.path.join(tmp, "ck.npz")
        ckpt.save(path, first.target)
        resumed = Renderer(a380_cpu, device="cuda")
        resumed.target = ckpt.load(path)
    resumed.render(samples=k)
    assert resumed.target.count == full.target.count == 2 * k
    assert np.array_equal(resumed.target.acc, full.target.acc), "resume is not bitwise exact"
    print(f"[paths] resume at {k} spp: bitwise exact ({2 * k} spp, a380-class {MESH_W}x{MESH_H}, "
          f"cpu semantics, wavefront)", flush=True)

    # the main path's render profiled with the kernel, then with the
    # per-thread yardstick in its place (the integrator's mesh_hit wrapped)
    label = f"a380-class cpu semantics {MESH_W}x{MESH_H}"
    new = profile(full, card, "mesh_hit_kernel", label)
    real = itg.mesh_hit
    itg.mesh_hit = mk._mesh_hit_per_thread
    try:
        old = profile(full, card, "mesh_hit_per_thread_kernel", label)
    finally:
        itg.mesh_hit = real
    if new and old:
        print(f"[profile] mesh_hit in the render: {new['ms']:.4f} ms per launch, "
              f"{new['share']:.2%} of device time ({new['device_ms']:.3f} ms); the per-thread "
              f"yardstick in its place: {old['ms']:.4f} ms per launch, {old['share']:.2%} "
              f"({old['device_ms']:.3f} ms) [{card}]", flush=True)
    rec = {"name": "mesh_hit", "route": "cuda", "source": "raytrace_tpu_torch/csrc/mesh_kernel.cu",
           "replaces": "raytrace_tpu/ops/pallas/mesh_hit_kernel.py:269", "launches": launches,
           "max_abs_err": hit["max_abs_err"], "ms": hit["ms"], "plain_ms": hit["plain_ms"],
           "bound_ms": hit["bound_ms"], "bound_by": hit["bound_by"], "library_ms": None,
           "launches_per_render": launches, "in_render_ms": new["ms"] if new else None}
    return rec, per_path, hit["walk_ops_per_ray"]


def profile(renderer, card, kernel, label, spp=MESH_SPP):
    """torch.profiler over one warm render(spp) of the renderer: device
    time per kernel, the share of the kernel whose name holds `kernel` and
    of the device-to-host copies, host syncs per wavefront iteration, and
    the device's idle share of an unprofiled warm render(spp). Returns
    {ms (per launch), share, device_ms, copy_share} of that kernel, or
    None without device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    renderer.render(samples=spp)  # warm, unprofiled
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        renderer.render(samples=spp)
        torch.cuda.synchronize()
    rows = prof.key_averages()
    # the kernels' own rows: an operator's row repeats its kernels' time
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA and not e.is_user_annotation]

    def dev_us(e):
        return float(e.self_device_time_total)

    total = sum(dev_us(e) for e in kernels)
    iters = renderer.stats["iterations"]
    print(f"[profile] {label} render({spp}), warm, driver {renderer.driver}: {iters} "
          f"wavefront iterations, {renderer.stats['lane_bounces']} lane-bounces, device time "
          f"{total / 1e3:.3f} ms [{card}]", flush=True)
    if total <= 0:
        print("[profile] the profiler recorded no device time", flush=True)
        return None
    print(f"[profile] the same render unprofiled: {wall_ms:.3f} ms wall, so the device is idle "
          f"{1 - total / 1e3 / wall_ms:.1%} of it [{card}]", flush=True)
    for e in sorted(kernels, key=dev_us, reverse=True)[:14]:
        print(f"[profile] {dev_us(e) / total:7.2%} {dev_us(e) / 1e3:10.3f} ms {e.count:7d}x "
              f"{e.key[:90]}", flush=True)
    mine = [e for e in kernels if kernel in e.key]
    hit = sum(dev_us(e) for e in mine)
    count = sum(e.count for e in mine)
    copy = sum(dev_us(e) for e in kernels if "Memcpy" in e.key)
    print(f"[profile] {kernel} {hit / total:.2%} of device time, {count} launches; the "
          f"device-to-host copies {copy / total:.2%}; the elementwise work and the rest "
          f"{1 - (hit + copy) / total:.2%}", flush=True)
    for name in ("cudaStreamSynchronize", "aten::_local_scalar_dense", "cudaLaunchKernel"):
        c = sum(e.count for e in rows if e.key == name)
        print(f"[profile] {name}: {c} calls, {c / max(iters, 1):.1f} per iteration", flush=True)
    return {"ms": hit / 1e3 / max(count, 1), "share": hit / total, "device_ms": total / 1e3,
            "copy_share": copy / total}


SASS_DIR = os.path.join(ROOT, "raytrace_tpu_torch", "_build", "sass")


def sass(builds, out=SASS_DIR):
    """Each build's SASS ({tag: Built}) into <out>/<tag>.sass; prints the
    instructions of each kernel (None when cuobjdump is missing)."""
    import re

    from raytrace_tpu_torch.kernels import build

    tool = os.path.join(os.path.dirname(build.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        print(f"[sass] no cuobjdump beside nvcc ({tool})", flush=True)
        return None
    os.makedirs(out, exist_ok=True)
    counts = {}
    for tag, built in builds.items():
        proc = subprocess.run([tool, "-sass", str(built.path)], capture_output=True, text=True)
        if proc.returncode != 0:
            print(f"[sass] {tag}: cuobjdump failed: {proc.stderr.strip()[:200]}", flush=True)
            continue
        path = os.path.join(out, f"{tag}.sass")
        with open(path, "w") as f:
            f.write(proc.stdout)
        fn, n = None, {}
        for line in proc.stdout.splitlines():
            m = re.match(r"\s*Function : (\S+)", line)
            if m:
                fn = m.group(1)
                n[fn] = 0
            elif fn and re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+\S", line):
                n[fn] += 1
        counts[tag] = n
        for k, v in n.items():
            print(f"[sass] {tag} {k}: {v} instructions ({path})", flush=True)
    return counts


def refill_efficiency(iters, warps):
    """The loop efficiency (lane-iterations over 32 x warp-iterations) of
    the launch under lane refill, the schedule trace_tiles does not take:
    `warps` resident warps whose threads each take the next lane, in order,
    once theirs has run all its samples, every warp one iteration a step
    while any of its threads is live."""
    import numpy as np

    costs = iters.reshape(-1).cpu().numpy().astype(np.int64)
    rem = np.zeros(warps * 32, np.int64)
    nxt = steps = 0
    while True:
        free = np.flatnonzero(rem == 0)
        k = min(free.size, costs.size - nxt)
        rem[free[:k]] = costs[nxt:nxt + k]
        nxt += k
        live = rem > 0
        if not live.any():
            return float(costs.sum()) / (32 * steps)
        steps += int(live.reshape(warps, 32).any(1).sum())
        rem[live] -= 1


def iter_stats(iters, branch, roots, card):
    """The work the plain version counts per lane (return_iters) on the
    main path's launch: loop iterations per lane, the efficiency of 32-lane
    warps and 256-lane blocks that each wait for their slowest lane (the
    per-thread design), and of lane refill at 16 and 32 resident warps a
    SM (refill_efficiency), the share of lane-iterations by branch, and the
    share of warp-iterations by the number of branches their live lanes
    take. Returns {lane_iterations, by_branch (lane-iterations of each of
    BRANCHES), near_roots (sphere tests that take the near root)}."""
    import torch

    from raytrace_tpu_torch.ops.trace_kernel import BRANCHES

    it = iters.reshape(-1).double()
    total = float(it.sum())
    effs = []
    for group in (32, 256):
        n = it.numel() // group * group
        g = it[:n].reshape(-1, group)
        effs.append(float(g.sum()) / float(g.max(1).values.sum() * group))
    live = float((branch >= 0).sum())
    count = [float((branch == c).sum()) for c in range(len(BRANCHES))]
    share = [c / live for c in count]
    near_roots = float(roots.double().sum())
    nw = branch.shape[1] // 32
    taken = torch.zeros(branch.shape[0], nw, dtype=torch.int8, device=branch.device)
    for c in range(len(BRANCHES)):
        taken += (branch[:, : nw * 32].reshape(-1, nw, 32) == c).any(-1).to(torch.int8)
    busy = taken[taken > 0]
    hist = [float((busy == k).sum()) / busy.numel() for k in range(1, len(BRANCHES) + 1)]
    print(f"[iters] per lane: mean {float(it.mean()):.2f}, std {float(it.std()):.2f}, min "
          f"{int(it.min())}, max {int(it.max())} loop iterations; {total:.5g} lane-iterations; "
          f"efficiency of warps waiting for their slowest lane {effs[0]:.4f}, of 256-lane blocks "
          f"{effs[1]:.4f}; of lane refill at 16 resident warps a SM "
          f"{refill_efficiency(iters, SMS * 16):.4f}, at 32 {refill_efficiency(iters, SMS * 32):.4f}",
          flush=True)
    print("[iters] lane-iterations by branch: " + ", ".join(
        f"{b} {v:.4f}" for b, v in zip(BRANCHES, share)) + f"; near roots taken {near_roots:.5g}, "
        f"{near_roots / total:.4f} a lane-iteration", flush=True)
    print("[iters] warp-iterations by branches taken: " + ", ".join(
        f"{k + 1}: {v:.4f}" for k, v in enumerate(hist)) + f" [{card}]", flush=True)
    return dict(lane_iterations=total, by_branch=dict(zip(BRANCHES, count)),
                near_roots=near_roots)


def trace_phase(dev, card):
    """Phase 3: `trace_tiles` and its yardstick `trace_tiles_per_thread`
    against `trace_tiles_reference` on the card under the lane gate
    (walled 1200x600 and the mixed scene, samples per lane 1: all 9
    outputs, 4: radiance), the plain version's per-lane counts on the main
    path's launch, and the three timed in turns at that launch. Returns
    {max_abs_err, ms, yardstick_ms, plain_ms, work (iter_stats'), tables}."""
    import torch

    from raytrace_tpu_torch.models.camera import build_camera
    from raytrace_tpu_torch.models.scene import build_scene
    from raytrace_tpu_torch.models.walled import walled_scheme
    from raytrace_tpu_torch.ops import trace_kernel as tk

    def setup(scheme, width, height):
        scene = build_scene(scheme)
        tables = tk.SceneTables(scene, build_camera(scheme.cam, width, height),
                                scheme.render_info.rad_info.russ_roull_info.max_thres).to(dev)
        flat = torch.arange(width * height, dtype=torch.int32, device=dev)
        return tables, flat % width, flat // width

    def run(fn, tables, xs, ys, samp, assured, spl, **kw):
        return fn(xs, ys, samp, tables.sph, tables.ft, tables.cam_vec,
                  n_sph=tables.n_sph, n_ft=tables.n_ft, has_lens=tables.has_lens,
                  assured=assured, max_bounces=24, samples_per_lane=spl, **kw)

    max_err = 0.0
    cases = [("walled", walled_scheme(W, H), W, H, 5, 1), ("walled", walled_scheme(W, H), W, H, 5, 4),
             ("mixed", mixed_scheme(64, 32), 64, 32, 2, 1), ("mixed", mixed_scheme(64, 32), 64, 32, 2, 4)]
    for name, scheme, w, h, assured, spl in cases:
        tables, xs, ys = setup(scheme, w, h)
        samp = torch.full_like(xs, 7)
        ref = run(tk.trace_tiles_reference, tables, xs, ys, samp, assured, spl)
        n_out = 9 if spl == 1 else 3  # miss records mean something only at spl == 1
        outs = {}
        for label, fn in (("trace_tiles", tk.trace_tiles),
                          ("trace_tiles_per_thread", tk._trace_tiles_per_thread)):
            ours = outs[label] = run(fn, tables, xs, ys, samp, assured, spl)
            torch.cuda.synchronize()
            worst = 0.0
            for k in range(n_out):
                bad, err = lane_gate(ours[k], ref[k])
                worst = max(worst, bad)
                if fn is tk.trace_tiles:
                    max_err = max(max_err, err)
                print(f"[parity] {label} {name} {w}x{h} spl={spl} out{k}: bad-lane fraction "
                      f"{bad:.6f} max|d| {err:.3e}", flush=True)
                assert bad < 0.01, f"{label} {name} spl={spl} output {k}: {bad:.4f} of lanes differ"
            print(f"[gate] {label} {name} {w}x{h} spl={spl}: worst bad-lane fraction {worst:.6f} "
                  f"over {n_out} outputs (limit 0.01); radiance mean "
                  f"{[round(float(o.mean()) / spl, 5) for o in ours[:3]]}", flush=True)
        differ = int((torch.stack(outs["trace_tiles"][:n_out])
                      != torch.stack(outs["trace_tiles_per_thread"][:n_out])).any(0).sum())
        print(f"[parity] {name} {w}x{h} spl={spl}: {differ} of {xs.numel()} lanes differ between "
              f"trace_tiles and its yardstick", flush=True)

    # the main path's launch: its per-lane work, then the three in turns
    tables, xs, ys = setup(walled_scheme(W, H), W, H)
    samp = torch.zeros_like(xs)
    _, (iters, branch, roots) = run(tk.trace_tiles_reference, tables, xs, ys, samp, 5,
                                    TIMING_SPL, return_iters=True)
    work = iter_stats(iters, branch, roots, card)
    del branch

    def timed(fn, reps):
        run(fn, tables, xs, ys, samp, 5, TIMING_SPL)  # warm-up
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run(fn, tables, xs, ys, samp, 5, TIMING_SPL)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    order = [("plain", tk.trace_tiles_reference, 1), ("new", tk.trace_tiles, 5),
             ("old", tk._trace_tiles_per_thread, 5), ("old", tk._trace_tiles_per_thread, 5),
             ("new", tk.trace_tiles, 5), ("plain", tk.trace_tiles_reference, 1)]
    times = {}
    for label, fn, reps in order:
        ms = timed(fn, reps)
        times.setdefault(label, []).append(ms)
        print(f"[timing] {label} walled {W}x{H} spl={TIMING_SPL}: {ms:.3f} ms/launch "
              f"({W * H * TIMING_SPL / ms / 1e6:.3f} Gpaths/s) [{card}]", flush=True)
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    print(f"[timing] trace_tiles walled {W}x{H} spl={TIMING_SPL}: {ms['new']:.3f} ms/launch, "
          f"yardstick trace_tiles_per_thread {ms['old']:.3f} ms ({ms['old'] / ms['new']:.3f}x), "
          f"plain {ms['plain']:.3f} ms [{card}]", flush=True)
    return dict(max_abs_err=max_err, ms=ms["new"], yardstick_ms=ms["old"], plain_ms=ms["plain"],
                work=work, tables=tables)


PROFILE_CHILD = "--walled-profile"  # the argument of the child that profiles phase 4's render


def walled_profile_child(card) -> int:
    """Phase 4's profiler table in a process of its own: one warm walled
    1200x600 render(64); prints its result as the last line."""
    from raytrace_tpu_torch.models.walled import walled_scheme
    from raytrace_tpu_torch.render.renderer import Renderer

    renderer = Renderer(walled_scheme(W, H), device="cuda")
    renderer.render(samples=1)  # loads the kernel (built: the parent's cache)
    result = profile(renderer, card, "trace_tiles_kernel", f"walled {W}x{H}", spp=MAIN_SPP)
    print(json.dumps(result), flush=True)
    return 0


def profile_in_child(card):
    """Phase 4's profiler table, taken by a child process (walled_profile_child):
    in this process a profiler session after the others lost records of the
    kernels launched through ctypes (one recorded no device time). Returns
    its result, or None."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), PROFILE_CHILD, card],
                          capture_output=True, text=True, timeout=600)
    lines = proc.stdout.strip().splitlines()
    for line in lines[:-1]:
        print(line, flush=True)
    assert proc.returncode == 0 and lines, f"the profiling child failed:\n{proc.stderr[-2000:]}"
    return json.loads(lines[-1])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA device",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    if sys.argv[1:2] == [PROFILE_CHILD]:
        return walled_profile_child(sys.argv[2])
    import numpy as np

    from raytrace_tpu_torch.kernels import build
    from raytrace_tpu_torch.models.walled import walled_scheme
    from raytrace_tpu_torch.ops import trace_kernel as tk
    from raytrace_tpu_torch.render.renderer import Renderer
    from raytrace_tpu_torch.render.target import RenderTarget
    from raytrace_tpu_torch.utils import checkpoint as ckpt

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. environment ----
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    card = smi
    print(smi, flush=True)
    nvcc_v = subprocess.run([build.nvcc_path(), "--version"], capture_output=True, text=True,
                            check=True).stdout.strip().splitlines()[-1]
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda} nvcc '{nvcc_v}' device '{torch.cuda.get_device_name(0)}' "
          f"count {torch.cuda.device_count()}", flush=True)

    # ---- 2. build: one nvcc per source and per group-sweep copy, started together ----
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import torch_mesh_trace_groups as groups

    t0 = time.perf_counter()
    names = ("trace_kernel", "mesh_kernel")
    with ThreadPoolExecutor(len(names) + len(groups.GROUPS)) as pool:
        copies = pool.map(groups.build_variant, groups.GROUPS)
        builds = list(pool.map(build.build, names))
        variants = dict(zip(groups.GROUPS, copies))
    print(f"[build] {len(names)} kernels and {len(variants)} group-sweep copies in "
          f"{time.perf_counter() - t0:.2f} s", flush=True)
    for built in builds:
        print(f"[build] {built.path.name}: nvcc {built.seconds:.2f} s", flush=True)
        for line in built.log.splitlines():
            if any(k in line for k in ("registers", "spill", "smem", "Compiling")):
                print(f"[build] {line.strip()}", flush=True)
    groups.print_ptxas(variants)
    sass({"trace_kernel": builds[0]})  # both entries' SASS, for reading

    # ---- 3. kernel vs plain on the card ----
    trace = trace_phase(dev, card)

    # ---- 4. the main path ----
    scheme = walled_scheme(W, H)
    renderer = Renderer(scheme, device="cuda")
    torch.cuda.synchronize()
    tk.LAUNCHES = 0
    t0 = time.perf_counter()
    img = renderer.render(samples=MAIN_SPP)  # ends in a device -> host copy
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = tk.LAUNCHES
    print(f"[main] Renderer(walled {W}x{H}, cuda).render({MAIN_SPP}): {dt:.4f} s, "
          f"{W * H * MAIN_SPP / dt:.1f} paths/s, kernel launches {launches} [{card}]", flush=True)
    assert launches > 0, "the main path did not launch the CUDA kernel"
    assert img.shape == (H, W, 3) and np.isfinite(img).all(), "bad image"
    print(f"[main] image mean per channel {img.mean(axis=(0, 1)).tolist()}", flush=True)

    # the same frame at a small size: card vs the plain version on the CPU
    small = walled_scheme(128, 64)
    gpu_img = Renderer(small, device="cuda").render(samples=16)
    cpu_img = Renderer(small, device="cpu").render(samples=16)
    mean_d, bad_tiles = tile_gate(gpu_img, cpu_img)
    print(f"[main] 128x64x16 card vs cpu: channel-mean |d| {mean_d:.3e}, "
          f"bad 8x8 tiles {bad_tiles:.4f}", flush=True)
    assert mean_d < 2e-3 and bad_tiles < 0.02, "card render disagrees with the CPU render"

    # resume: render(2k, batch=k) == render(k), checkpoint save/load, render(k)
    k = 4
    full = Renderer(scheme, device="cuda")
    full.render(samples=2 * k, batch=k)
    first = Renderer(scheme, device="cuda")
    first.render(samples=k)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        path = os.path.join(tmp, "ck.npz")
        ckpt.save(path, first.target)
        resumed = Renderer(scheme, device="cuda")
        resumed.target = ckpt.load(path)
    resumed.render(samples=k)
    assert resumed.target.count == full.target.count == 2 * k
    assert np.array_equal(resumed.target.acc, full.target.acc), "resume is not bitwise exact"
    print(f"[main] resume at {k} spp: bitwise exact ({2 * k} spp, {W}x{H})", flush=True)

    # the same render with the yardstick in trace_tiles' place, in turns
    def render_ms(fn):
        """The median wall time of RENDER_REPS warm renders, each into a
        fresh target: one render's host side (the pageable copy) varies by
        several ms, more than the kernels differ."""
        real, tk.trace_tiles = tk.trace_tiles, fn
        try:
            r = Renderer(scheme, device="cuda")
            r.render(samples=1)
            times = []
            for _ in range(RENDER_REPS):
                r.target = RenderTarget(W, H)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r.render(samples=MAIN_SPP)  # ends in a device -> host copy
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return float(np.median(times))
        finally:
            tk.trace_tiles = real

    walls = {}
    yardstick = tk._trace_tiles_per_thread
    for label, fn in (("trace_tiles", tk.trace_tiles), ("yardstick", yardstick),
                      ("yardstick", yardstick), ("trace_tiles", tk.trace_tiles)):
        walls.setdefault(label, []).append(render_ms(fn))
    sides = ", ".join(
        f"{k} {sum(v) / 2:.3f} ms ({W * H * MAIN_SPP / (sum(v) / 2) / 1e6:.3f} Gpaths/s; turns "
        f"{v[0]:.3f}, {v[1]:.3f})" for k, v in walls.items())
    print(f"[main] walled render(64) in turns, each the median of {RENDER_REPS} renders: {sides} "
          f"[{card}]", flush=True)

    kernels = [{
        "name": "trace_tiles",
        "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/trace_kernel.cu",
        "replaces": "raytrace_tpu/ops/pallas/trace_kernel.py:722",
        "launches": launches,
        "max_abs_err": trace["max_abs_err"],
        "ms": trace["ms"],
        "plain_ms": trace["plain_ms"],
        "library_ms": None,
        "launches_per_render": launches,
        "yardstick_ms": trace["yardstick_ms"],
    }]
    tables = trace["tables"]
    shape = {"trace_tiles": dict(
        n_sph=tables.n_sph, n_ft=tables.n_ft, n_tris=0,
        table_bytes=tensor_bytes(tables.buffers()))}
    mesh_records, mesh_shape = mesh_phases(dev, card, variants)
    kernels += mesh_records
    shape.update(mesh_shape)
    hit_record, per_path, walk_ops = integrator_phases(dev, card)
    walled_profile = profile_in_child(card)
    if walled_profile:
        kernels[0]["in_render_ms"] = walled_profile["ms"]

    # ---- the fused kernels' bounds: their timed launches' lane-bounces
    # (the wavefront's lane-bounces per path of the same frame, phase 8)
    # times the FP32 operations of a bounce, counted from the sources ----
    paths = {"trace_tiles": (W * H, TIMING_SPL), "mesh_trace": (MESH_W * MESH_H, MESH_SPP),
             "mesh_trace_brute": (MESH_W * MESH_H, MESH_SPP)}
    for rec in kernels:
        name, s = rec["name"], shape[rec["name"]]
        lanes, spl = paths[name]
        lane_bounces = per_path[name] * lanes * spl
        if name == "trace_tiles":
            # the plain version's counts of this launch's work (phase 3)
            work = trace["work"]
            lane_bounces = work["lane_iterations"]
            terms = {"sphere tests": lane_bounces * s["n_sph"] * SPH_INSTR,
                     "near roots": work["near_roots"] * ROOT_INSTR,
                     "free triangles": lane_bounces * s["n_ft"] * TRI_INSTR,
                     **{f"shade {b}": n * SHADE_INSTR[b] for b, n in work["by_branch"].items()},
                     "raygen": lanes * spl * RAYGEN_INSTR}
            per_bounce = sum(terms.values()) / lane_bounces
            old = lane_bounces * (s["n_sph"] * SPH_OPS + s["n_ft"] * (TRI_OPS - 2)
                                  + SHADE_SPH_OPS) / FP32_PEAK * 1e3
            out_floats = 9
            note = (f" (the wavefront's {per_path[name]:.4f} per path would give "
                    f"{per_path[name] * lanes * spl:.4g}); FP32 instructions by term: "
                    + ", ".join(f"{k} {v:.4g} ({v / FP32_CEILING[name] * 1e3:.4f} ms)"
                                for k, v in terms.items())
                    + f"; the earlier count, every operation apart at 67 TFLOP/s: {old:.4f} ms")
        else:
            per_bounce = s["n_sph"] * SPH_OPS + s["n_ft"] * (TRI_OPS - 2) + SHADE_MESH_OPS + (
                walk_ops if name == "mesh_trace" else s["n_tris"] * TRI_OPS)
            out_floats = 3
            note = f" ({per_path[name]:.4f} per path x {lanes * spl} paths)"
        nbytes = s["table_bytes"] + lanes * (3 * 4 + out_floats * 4)
        ops = lane_bounces * per_bounce
        rec["bound_ms"], rec["bound_by"] = bound(ops, nbytes, name)
        print(f"[bound] {name}: {lane_bounces:.4g} lane-bounces{note}; x {per_bounce:.1f} FP32 "
              f"instructions at {FP32_CEILING[name] / 1e12:g} T/s ({ops / FP32_CEILING[name] * 1e3:.4f}"
              f" ms), {nbytes:.4g} bytes ({nbytes / HBM_RATE * 1e3:.4f} ms at 3.35 TB/s): bound "
              f"{rec['bound_ms']:.4f} ms by {rec['bound_by']}; kernel {rec['ms']:.4f} ms "
              f"({rec['bound_ms'] / rec['ms']:.2%} of the bound reached)"
              + (f", yardstick {rec['yardstick_ms']:.4f} ms "
                 f"({rec['bound_ms'] / rec['yardstick_ms']:.2%})" if "yardstick_ms" in rec else "")
              + f" [{card}]", flush=True)
    kernels.append(hit_record)
    print(f"[done] all phases in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
