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
   instruction counts (cuobjdump, into raytrace_tpu_torch/_build/sass/),
   with the registers of each trace_tiles_kernel<kSky, kPcg>, and
   mesh_kernel.cu's, with the registers of each mesh_trace_kernel<kBrute,
   kInst, kSky, kPcg> (scripts/torch_mesh_sass.py puts them beside another
   checkout's);
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
   launch inside the render and its share of device time;
9. the cube map: six 2048x2048 u8 faces (models/procedural.sky_cubemap,
   biplane's size) written to a temporary directory. Outdoor spheres
   under the sky at 1200x600 (procedural.outdoor_scheme): `trace_tiles`
   with the sky (its sky instantiation, counted as trace_tiles_sky)
   against its plain version on the whole frame at samples per lane 1
   (all 9 outputs) and 4 under the lane gate, the share of paths that end in the sky, the plain version's
   counts of the 64-spl launch, that launch timed in turns against the
   same launch without the sky and against the JAX driver's route done
   in the port (64 launches of one sample a lane and `cubemap.sample` on
   their miss records), Renderer(...).render(64) with paths/s and (in a
   child process of its own, as phase 4's) a torch.profiler table, the
   image against the wavefront at 16 spp, a small frame against the CPU
   and a bitwise resume. The a380-class surface under the sky: `mesh_trace`
   with the sky bitwise against `mesh_trace_reference` on the whole
   1216x608 frame at 1, 4 and 16 samples per lane, `mesh_trace_brute`
   with the sky bitwise on the 2,097-triangle cut at 16, each timed
   against its launch without the sky in turns; render(16) with paths/s
   and a torch.profiler table, against the wavefront and a bitwise resume; then in cpu semantics
   through the wavefront: render(16) with mesh_hit launches, a 96x48
   frame on the card against the CPU and a bitwise resume. A sky scene
   on the card must launch the sky instantiations (their launch counts).
   Every resume loads its checkpoint into a new Renderer. Prints the
   phase's seconds;
10. the differentiable tier: walled 1200x600 (gpu semantics, assured
   depth 5, 24 bounces) through the differentiable sample_batch at one
   sample (id 0): the image bitwise the forward render's, every gradient
   of split_diff_scene's fields and the camera's o, d, up, right finite,
   forward and backward ms and peak allocated memory; then five steps of
   make_train_step from the scene with its two emitters' emissive halved
   and its four walls' rgb moved by 0.1 toward the true image at the same
   sample ids, each a tenth of the Polyak step, the loss printed and
   falling at every step. The a380-class 1216x608 frame likewise, through
   mesh_hit: the (t, u, v) recomputed at the kernel's ids on the frame's
   primary rays bitwise the kernel's, mesh_hit's launches (and no other
   kernel's) with the counts reset just before and read just after, the
   image bitwise the forward render's, and the image and every gradient
   against the same render with the plain walk in mesh_hit's place (the
   tile gate, the lanes that differ, relative L2 within 1e-2); the
   2,097-triangle cut at 152x76 on the card against the cpu (every
   gradient within 1e-3) and walled in cpu semantics at that size
   (within 1e-2); and, in a child process, a torch.profiler table of the
   a380-class render's forward and backward with mesh_hit's ms a launch.

11. pcg, animation and the host remainder: (a) the reference's generator:
   `trace_tiles`' pcg instantiations against the plain version under pcg
   (the lane gate) on walled 1200x600 at samples per lane 1 (all 9
   outputs) and 4, the mixed 64x32 scene at 1 and 4 and outdoor + sky at 1;
   `mesh_trace`'s bitwise on the whole a380-class 1216x608 frame at 1 and
   16, with the sky at 1, and `mesh_trace_brute`'s on the 2,097-triangle
   cut at 16; every launch counted under its `<entry>_pcg` key alone and
   differing from the weyl launch; each kernel's main launch timed in
   turns weyl, pcg, pcg, weyl; pcg renders with the launch counts reset
   just before and read just after: walled render(64), the a380-class
   frame's render(16) in gpu semantics and (through the wavefront, mesh_hit
   alone) in cpu semantics, the 2,097-triangle cut's on the brute route;
   walled and the cpu-semantics frame against the CPU at a small size and
   resumed bitwise. (b) animation through cli._render_animation in a
   temporary working directory: walled 1200x600 with two spheres
   keyframed through the bezier, polynomial, Step and Hold easings (8
   frames of 64 spp) and the a380-class surface moved and turned (4
   frames of 16 spp), each at pipeline depths 2, 1, 1, 2 in turns with
   every frame's build (on the builder thread), wait, set-up, render and
   PNG seconds; every frame's PNG bitwise a fresh Renderer(frame,
   "cuda")'s; frame 0 and the last at a small size against the CPU; the
   encode rung, its seconds and the frames read back. (c) the host
   remainder: walled render(64) in batches of 8 with a PNG + checkpoint
   hook, async_hook on and off in turns, the final targets bitwise equal
   both ways and to the no-hook render; a LivePreview on 127.0.0.1 fetched
   once, equal to the final image. The fused kernels' records gain pcg_ms,
   pcg_weyl_ms (the weyl launch of the same turns), pcg_max_abs_err and
   pcg_launches (the pcg render's).
12. parallel/ under torch.distributed, in torchrun children that run this
   script with --dist (a rank that fails fails the phase): NCCL at a
   world of 1 (NCCL takes no two ranks on one card, and this run needs
   one card): walled 1200x600 render(64) through the grouped
   fused driver bitwise the ungrouped render, timed in turns; then two
   gloo ranks on cuda:0 (gloo's all-reduce of CUDA tensors stages through
   host memory): walled render(64) through trace_tiles and the a380-class
   render(16) through mesh_trace, each bitwise the one-process render at
   samples_per_launch spp / 2, and the cpu-semantics a380-class
   render(16) through the wavefront and mesh_hit, bitwise the rank-order
   sum of the one-process slices' renders and under the tile gate
   against the whole one-process render; each with the tables' digests
   all-gathered and equal, the launch counts reset just before and read
   just after, the two ranks' targets bitwise equal, a resume bitwise and
   render(samples=5) the sum of its slices (3 + 2); make_train_step on
   make_mesh(tile=1, spp=2) at walled 1200x600, one sample a rank: the
   loss bitwise the one-process two-sample step's, every gradient within
   relative L2 1e-3 (the largest difference printed); each rank's render
   ms beside the one-process render's on the same card, and the
   all-reduce's ms at each image's size (8.64 MB walled, 8.87 MB
   a380-class). Two ranks share one card's SMs: correctness and the
   collective's cost, not scaling. The records of trace_tiles, mesh_trace
   and mesh_hit gain dist_launches_per_rank and dist_backend, trace_tiles'
   nccl_launches.
13. two-level instancing on the fleet (procedural.fleet_scheme: 17
   instances of a 7,300-triangle cut, 124,100 triangles, four u8
   1024x1024 textures, the a380 camera at 1216x608): ptxas' registers,
   stack, spills and shared memory of every instanced kernel (4 blocks of
   256 a SM by registers and at most INST_SPILL_MAX bytes of spill for
   mesh_trace_instanced); n_inst, inst_tris, build_scene's and the
   instanced build's host seconds, the flattened and asset-local kernel
   tables' bytes and the route's reason;
   `mesh_trace_instanced` and its sky (the procedural faces) and pcg
   instantiations bitwise against the plain version (route "instanced")
   on the whole frame at samples per lane 1, 4 and 16, each launch counted
   under its key alone, the lanes that differ printed (none allowed), and
   at 1 the batched plain version bitwise the table-order loop
   (tests/torch_instanced_loop.py); the 16-spl launch in turns instanced,
   its first design (mesh_trace_instanced_first), walk, sky, pcg, and
   back; renders with the launch counts reset just before and read just
   after: the default route (MeshTables.route, whose launches must be its
   entry's alone), the instanced and walk routes' images under the tile
   gate, a resume bitwise, a 96x48 frame card against CPU, render(16) on
   both routes in turns, and the sky and pcg renders; the share of the
   frame's primary rays that hit, the least walk a ray of each route on
   the fleet frame's rays (instanced_walk_work, walk_work) and the bounds
   of the three records and of the first design; in a child process, a
   torch.profiler table of a warm render(16) on the default route. Then
   the large fleet (FLEET_LARGE_ROWS: 144 instances, 1,051,200 triangles,
   flattened tables over the 50 MB L2): its build and bytes, the instanced
   entry bitwise against the plain version on a 1216x32 strip at 1, 4 and
   16 and on the whole frame at 16, the three entries in turns with their
   bounds, the two routes' images under the tile gate. Prints the phase's
   seconds.

Each kernel's record has its bound (bound_ms, bound_by): the larger of
its bytes over 3.35 TB/s and its FP32 work, counted from the sources,
over 33.5 T FP32 instructions/s (see FP32_CEILING); trace_tiles' work is
counted in instructions under contraction on the plain version's counts
of the launch's lane-bounces by branch and of its near roots. The
trace_tiles and mesh_trace records also carry their sky
instantiations' sky_ms, sky_bound_ms / sky_bound_by (the same count on
the plain version's counts of the sky launch, plus SKY_INSTR a fetch and
the distinct 32-byte sectors of the sky pool its fetches read) and
sky_launches_per_render; the mesh_hit record its launches a
differentiable a380-class render (diff_launches_per_render) and its ms a
launch there (diff_in_render_ms, phase 10's profiler table). Phase 13
adds the records mesh_trace_instanced, mesh_trace_instanced_sky and
mesh_trace_instanced_pcg, the first with its yardstick's ms and share and
the large fleet's ms; every record carries `share`, bound_ms / ms.

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


def reset_launches():
    """Every CUDA entry's launch count to 0."""
    from raytrace_tpu_torch.ops import mesh_kernel as mk
    from raytrace_tpu_torch.ops import trace_kernel as tk

    for counts in (tk.LAUNCHES, mk.LAUNCHES):
        for k in counts:
            counts[k] = 0


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


def gate(tag, label, img, ref):
    """The tile gate between two images, printed under [tag]; raises."""
    mean_d, bad_tiles = tile_gate(img, ref)
    print(f"[{tag}] {label}: channel-mean |d| {mean_d:.3e}, bad 8x8 tiles {bad_tiles:.4f}",
          flush=True)
    assert mean_d < 2e-3 and bad_tiles < 0.02, f"{label}: the images disagree"


def card_vs_cpu(tag, label, scheme, width, height, spp, **kw):
    """The scheme at width x height, render(spp) on the card and on the
    CPU (Renderer's keywords kw on both), under the tile gate."""
    from raytrace_tpu_torch.render.renderer import Renderer

    small = variant(scheme, width, height)
    t0 = time.perf_counter()
    cpu_img = Renderer(small, device="cpu", **kw).render(progress=False, samples=spp)
    cpu_s = time.perf_counter() - t0
    gpu_img = Renderer(small, device="cuda", **kw).render(progress=False, samples=spp)
    gate(tag, f"{label} {width}x{height}x{spp} card vs cpu ({cpu_s:.1f} s on the cpu)", gpu_img,
         cpu_img)


def resume_bitwise(tag, r, label, k=4):
    """Each time into a fresh target: render(2k, batch=k) on r against
    render(k) on r, a checkpoint saved, loaded into a new Renderer built
    as r was (scheme, mode, generator, driver, route), render(k) there;
    bitwise or raise."""
    import numpy as np

    from raytrace_tpu_torch.render.renderer import Renderer
    from raytrace_tpu_torch.render.target import RenderTarget
    from raytrace_tpu_torch.utils import checkpoint as ckpt

    r.target = RenderTarget(r.width, r.height)
    r.render(progress=False, samples=2 * k, batch=k)
    full = r.target.acc.copy()
    r.target = RenderTarget(r.width, r.height)
    r.render(progress=False, samples=k)
    resumed = Renderer(r.scheme, device="cuda", samples_per_launch=r.samples_per_launch,
                       mode=r.mode, generator=r.params.generator, use_fused=r.driver == "fused",
                       use_mesh_fused=r.driver == "mesh_fused",
                       use_wavefront=r.driver == "wavefront")
    if r.driver == "mesh_fused":
        resumed.tables.route = r.tables.route
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_") as tmp:
        path = os.path.join(tmp, "ck.npz")
        ckpt.save(path, r.target)
        resumed.target = ckpt.load(path)
    resumed.render(progress=False, samples=k)
    assert resumed.driver == r.driver and resumed.target.count == 2 * k and np.array_equal(
        resumed.target.acc, full), f"{label}: resume is not bitwise exact"
    print(f"[{tag}] resume at {k} spp: bitwise exact ({2 * k} spp, {label})", flush=True)


def warm_render(tag, label, scheme, spp, card, route=None, **kw):
    """One warm render (a 1-spp render first, then a fresh target) with the
    launch counts reset just before and read just after; `route` sets the
    mesh tables' route whatever the gate says. Returns (renderer, image,
    every entry's launches, seconds)."""
    import numpy as np
    import torch

    from raytrace_tpu_torch.ops import mesh_kernel as mk
    from raytrace_tpu_torch.ops import trace_kernel as tk
    from raytrace_tpu_torch.render.renderer import Renderer
    from raytrace_tpu_torch.render.target import RenderTarget

    r = Renderer(scheme, device="cuda", **kw)
    if route is not None:
        r.tables.route = route
    r.render(progress=False, samples=1)  # loads the torch kernels it uses, grows the allocator
    r.target = RenderTarget(r.width, r.height)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    img = r.render(progress=False, samples=spp)  # ends in a device -> host copy
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = dict(mk.LAUNCHES, **tk.LAUNCHES)
    w, h = r.width, r.height
    print(f"[{tag}] Renderer({label} {w}x{h}, cuda{''.join(f', {k}={v}' for k, v in kw.items())})"
          f".render({spp}): {dt:.4f} s, {w * h * spp / dt:.1f} paths/s, {r.mode} semantics, "
          f"driver {r.driver}, stats {r.stats}, launches {({k: v for k, v in counts.items() if v})}"
          f" [{card}]", flush=True)
    assert img.shape == (h, w, 3) and np.isfinite(img).all(), f"{label}: bad image"
    print(f"[{tag}] {label} image mean per channel {img.mean(axis=(0, 1)).tolist()}", flush=True)
    return r, img, counts, dt


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
        reset_launches()
        t0 = time.perf_counter()
        img = renderer.render(progress=False, samples=MESH_SPP)  # ends in a device -> host copy
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
            resume_bitwise("mesh", renderer, f"a380-class {MESH_W}x{MESH_H}")

    card_vs_cpu("mesh", "a380-class", a380, 96, 48, MESH_SPP)

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


def tiles_terms(work, n_sph, n_ft, paths):
    """trace_tiles' FP32 instructions by term on a launch's plain-version
    counts (iter_stats' work) of `paths` paths."""
    lane_bounces = work["lane_iterations"]
    return {"sphere tests": lane_bounces * n_sph * SPH_INSTR,
            "near roots": work["near_roots"] * ROOT_INSTR,
            "free triangles": lane_bounces * n_ft * TRI_INSTR,
            **{f"shade {b}": n * SHADE_INSTR[b] for b, n in work["by_branch"].items()},
            "raygen": paths * RAYGEN_INSTR}


def bound(ops, nbytes, name):
    """(bound_ms, bound_by) of a launch of kernel `name` doing `ops` FP32
    operations and moving `nbytes` bytes."""
    ops_ms, bytes_ms = ops / FP32_CEILING[name] * 1e3, nbytes / HBM_RATE * 1e3
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def tensor_bytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def table_bytes(tables):
    """The bytes of a kernel's tables but the sky pool, of which the
    launch's fetches read their distinct sectors (sky_sectors)."""
    return tensor_bytes(b for n, b in tables.named_buffers() if n != "sky.pool")


HIT_TABLES = ("sgbounds", "sbounds", "bounds", "count", "tri", "gid")


def hit_work(o, d, t, tables, t_min):
    """mesh_hit's least work on these rays: (ops, bytes, walk_work's counts);
    t is the rays' final nearest t."""
    from raytrace_tpu_torch.ops import mesh_kernel as mk

    work = mk.walk_work(o, d, t, tables, t_min=t_min)
    ops = sum(work["slab"]) * SLAB_OPS + work["tri"] * TRI_OPS
    moved = tensor_bytes(getattr(tables, k) for k in HIT_TABLES) + t.numel() * (7 * 4 + 4 * 4)
    return ops, moved, work


def frame_rays(dev, a380, built=None):
    """The a380-class scene on the card (built: its build_scene, when the
    caller has it) and the rays of phase 7's frame pool:
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

    scene = SceneTensors(built or build_scene(a380), build_camera(a380.cam, MESH_W, MESH_H),
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
        Renderer(scheme, device="cuda").render(progress=False, samples=MESH_SPP)
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
    from raytrace_tpu_torch.models import procedural
    from raytrace_tpu_torch.models.config import ModelMember
    from raytrace_tpu_torch.models.walled import walled_scheme
    from raytrace_tpu_torch.ops import mesh_kernel as mk
    from raytrace_tpu_torch.render import integrator as itg

    a380 = procedural.a380_scheme(MESH_W, MESH_H, MESH_SPP)
    a380_cpu = variant(a380, use_gpu=False)

    # ---- 7. mesh_hit against its plain version on the card ----
    hit = mesh_hit_phase(dev, card, a380_cpu)

    # ---- 8. the integrator paths at full width ----
    def render(label, scheme, spp, route=None, **kw):
        return warm_render("paths", label, scheme, spp, card, route, **kw)[:3]

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
        gate("paths", f"{label} {w}x{h}x{spp} wavefront vs {name}", wf_img, fused_img)

    against_fused("a380-class", a380, MESH_SPP, "mesh_trace", use_mesh_fused=False)
    surface = procedural.a380_cam_scheme(MESH_W, MESH_H, MESH_SPP)
    surface.scene_members.append(ModelMember(
        path="<2,097-triangle surface>", loaded=[procedural.make_mesh(2097, n_textures=0)]))
    against_fused("surface-2097", surface, MESH_SPP, "mesh_trace_brute", use_mesh_fused=False)
    against_fused("walled", walled_scheme(W, H), WALLED_WF_SPP, "trace_tiles", use_fused=False)
    print(f"[bound] lane-bounces per path through the wavefront, gpu semantics: {per_path}",
          flush=True)

    card_vs_cpu("paths", "a380-class cpu semantics", a380_cpu, 96, 48, MESH_SPP)
    full = r  # the main path's renderer
    resume_bitwise("paths", full, f"a380-class {MESH_W}x{MESH_H}, cpu semantics, wavefront")

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
    renderer.render(progress=False, samples=spp)  # warm, unprofiled
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        renderer.render(progress=False, samples=spp)
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
# trace_tiles_kernel<kSky, kPcg>'s mangled template arguments -> its name
TILES_INSTANTIATIONS = {"trace_tiles_kernelILb0ELb0E": "false, false: weyl",
                        "trace_tiles_kernelILb1ELb0E": "true, false: weyl, sky",
                        "trace_tiles_kernelILb0ELb1E": "false, true: pcg",
                        "trace_tiles_kernelILb1ELb1E": "true, true: pcg, sky"}


def ptxas_registers(log):
    """{mangled entry: registers} from ptxas's -v lines of a build log."""
    import re

    regs, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            regs[fn] = int(m.group(1))
    return regs


def ptxas_info(log):
    """{mangled entry: {registers, stack, spill_stores, spill_loads, smem}}
    (bytes but the registers) from ptxas's -v lines of a build log."""
    import re

    info, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn = m.group(1)
            info[fn] = {}
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and fn:
            info[fn].update(zip(("stack", "spill_stores", "spill_loads"), map(int, m.groups())))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and fn:
            info[fn].update(registers=int(m.group(1)), smem=int(m.group(2) or 0))
    return info


def inst_ptxas(log):
    """ptxas' {readable name: info} of the instanced kernels of a
    mesh_kernel build: every mesh_trace_kernel<kInst true> instantiation
    and mesh_trace_instanced_first_kernel."""
    from torch_mesh_sass import label

    return {label(fn): v for fn, v in ptxas_info(log).items()
            if "mesh_trace_instanced_first_kernel" in fn or "inst=1" in label(fn)}


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
    differ = int((torch.stack(run(tk.trace_tiles, tables, xs, ys, samp, 5, TIMING_SPL))
                  != torch.stack(run(tk._trace_tiles_per_thread, tables, xs, ys, samp, 5,
                                     TIMING_SPL))).any(0).sum())
    print(f"[parity] walled {W}x{H} spl={TIMING_SPL}: {differ} of {xs.numel()} lanes differ "
          f"between trace_tiles and its yardstick", flush=True)
    print(f"[timing] trace_tiles walled {W}x{H} spl={TIMING_SPL}: {ms['new']:.3f} ms/launch, "
          f"yardstick trace_tiles_per_thread {ms['old']:.3f} ms ({ms['old'] / ms['new']:.3f}x), "
          f"plain {ms['plain']:.3f} ms [{card}]", flush=True)
    return dict(max_abs_err=max_err, ms=ms["new"], yardstick_ms=ms["old"], plain_ms=ms["plain"],
                work=work, tables=tables)

# ---- 9. the cube map ----
# The sky fetch of cubemap.cuh sky_rgb and its radiance add, in FP32
# instructions (intrinsics: nothing fuses), counted as the bounds count, along
# the shortest way: the normalize 11 (3 FMUL, 2 FADD, the clamp's compare, the
# square root, 1 / n, 3 FMUL), the face 3 (|x| >= |y|, |x| >= |z|, the sign),
# su and sv 8 (FMUL, FDIV, the 0.5 FMUL and FADD each), the width and height to
# float 2, px and py 10 (FMUL, FMAX, FMIN, w - 1, its FMAX each), the texel's
# three components 6 (to float, / 255), the add 6 (3 FMUL, 3 FADD): 46. A
# missed path's weight record is in SHADE_INSTR["miss"].
SKY_INSTR = 46
SKY_SECTOR = 32  # bytes of a sector of the sky pool, what a fetch reads from memory
SKY_WF_SPP = 16  # the sky renders against the wavefront, and the small frames


def sky_sectors(sky):
    """A stand-in for the SkyTables `sky` in a plain version's run: it
    samples as `sky` does and marks the SKY_SECTOR-byte sectors of the
    pool each fetch reads (the misses of neighbouring lanes share them).
    Returns (stand-in, counts): counts() is (fetches, the distinct
    sectors' bytes), the bytes the run's fetches must move at least."""
    import torch

    from raytrace_tpu_torch.ops import cubemap, texture

    pool, size = sky.pool, sky.pool.element_size()
    seen = torch.zeros(-(-pool.numel() * size // SKY_SECTOR), dtype=torch.bool,
                       device=pool.device)
    fetches = torch.zeros((), dtype=torch.int64, device=pool.device)

    class Counting(torch.nn.Module):
        def sample(self, dx, dy, dz):
            ok, base3 = cubemap.texel(sky.offsets, sky.dims, sky.uv_scales, dx, dy, dz)
            b = base3[ok].long()
            if sky.kind == texture.POOL_U32:  # a packed word a texel
                first, last = b // 3 * 4, b // 3 * 4 + 3
            else:  # three components
                first, last = b * size, (b + 3) * size - 1
            seen[first // SKY_SECTOR] = True
            seen[last // SKY_SECTOR] = True
            fetches.add_(b.numel())
            return sky.sample(dx, dy, dz)

    return Counting(), lambda: (int(fetches), int(seen.sum()) * SKY_SECTOR)


def sky_render(label, scheme, spp, card, entry=None, **kw):
    """warm_render under [sky]; with `entry`, asserts that the render
    launched that sky entry and not its no-sky twin. Returns (renderer,
    image, launches)."""
    r, img, counts, _ = warm_render("sky", label, scheme, spp, card, **kw)
    if entry is not None:
        assert counts[entry] > 0 and not counts[entry[:-len("_sky")]], \
            f"{label}: the sky render did not launch {entry} alone"
    return r, img, counts


def sky_tiles(dev, card, outdoor):
    """Phase 9, outdoor spheres + sky through trace_tiles_sky. Returns
    {ms, no_sky_ms, route_ms, plain_ms, max_abs_err, work, launches,
    table_bytes, n_sph, n_ft}."""
    import torch

    from raytrace_tpu_torch.models.camera import build_camera
    from raytrace_tpu_torch.models.scene import build_scene
    from raytrace_tpu_torch.ops import trace_kernel as tk

    t0 = time.perf_counter()
    scene = build_scene(outdoor)
    tables = tk.SceneTables(scene, build_camera(outdoor.cam, W, H), 0.5).to(dev)
    torch.cuda.synchronize()
    print(f"[sky] outdoor: {scene.n_spheres} spheres, sky pool {scene.sky_pool.dtype} x "
          f"{scene.sky_pool.size}, faces {scene.cm_dims.tolist()}, uv scales "
          f"{scene.cm_uv_scales.tolist()}; build_scene + SceneTables {time.perf_counter() - t0:.3f} "
          f"s (host)", flush=True)
    flat = torch.arange(W * H, dtype=torch.int32, device=dev)
    xs, ys = flat % W, flat // W
    zero = torch.zeros_like(xs)

    def run(fn, samp, spl, sky=tables.sky, **kw):
        return fn(xs, ys, samp, tables.sph, tables.ft, tables.cam_vec, n_sph=tables.n_sph,
                  n_ft=tables.n_ft, has_lens=tables.has_lens, assured=5, max_bounces=24,
                  samples_per_lane=spl, sky=sky, **kw)

    err = 0.0
    for spl in (1, 4):
        samp = torch.full_like(xs, 7)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ref = run(tk.trace_tiles_reference, samp, spl)
        end.record()
        end.synchronize()
        ours = run(tk.trace_tiles, samp, spl)
        torch.cuda.synchronize()
        n_out = 9 if spl == 1 else 3
        worst = 0.0
        for k in range(n_out):
            bad, e = lane_gate(ours[k], ref[k])
            worst, err = max(worst, bad), max(err, e)
            assert bad < 0.01, f"trace_tiles_sky outdoor spl={spl} output {k}: {bad:.4f} differ"
        differ = int((torch.stack(ours[:n_out]) != torch.stack(ref[:n_out])).any(0).sum())
        print(f"[sky] trace_tiles_sky outdoor {W}x{H} spl={spl}: worst bad-lane fraction "
              f"{worst:.6f} over {n_out} outputs (limit 0.01), {differ} lanes differ, max|d| "
              f"{err:.3e}; radiance mean {[round(float(o.mean()) / spl, 5) for o in ours[:3]]}; "
              f"plain {start.elapsed_time(end):.1f} ms", flush=True)
        if spl == 1:
            ended = float(((ref[3] != 0) | (ref[4] != 0) | (ref[5] != 0)).float().mean())
            print(f"[sky] outdoor spl=1: {ended:.4f} of the paths end in the sky", flush=True)

    # the main launch: the plain version's counts, then it with the sky,
    # without it, by the JAX route and plain, in turns
    counting, sky_counts = sky_sectors(tables.sky)
    _, (iters, branch, roots) = run(tk.trace_tiles_reference, zero, TIMING_SPL, sky=counting,
                                    return_iters=True)
    work = iter_stats(iters, branch, roots, card)
    fetches, sky_bytes = sky_counts()
    assert fetches == work["by_branch"]["miss"], "the sky's fetches and the misses disagree"
    del branch

    def route():
        """The JAX driver's route in the port: launches of one sample a lane
        without the sky, each resolved outside the kernel from its miss
        records (raytrace_tpu/render/renderer.py:169-178)."""
        acc = [torch.zeros(xs.shape, dtype=torch.float32, device=dev) for _ in range(3)]
        for s in range(TIMING_SPL):
            out = run(tk.trace_tiles, zero + s, 1, sky=None)
            md, mw = out[3:6], out[6:9]
            missed = (md[0] != 0) | (md[1] != 0) | (md[2] != 0)
            c = tables.sky.sample(torch.where(missed, md[0], torch.ones_like(md[0])), md[1], md[2])
            acc = [acc[k] + (out[k] + torch.where(missed, mw[k] * c[k], torch.zeros_like(c[k])))
                   for k in range(3)]
        return acc

    kinds = {"sky": lambda: run(tk.trace_tiles, zero, TIMING_SPL),
             "no-sky": lambda: run(tk.trace_tiles, zero, TIMING_SPL, sky=None),
             "jax-route": route,
             "plain": lambda: run(tk.trace_tiles_reference, zero, TIMING_SPL)}
    launched, routed = kinds["sky"](), route()
    for k in range(3):
        bad, e = lane_gate(launched[k], routed[k])
        print(f"[sky] trace_tiles_sky spl={TIMING_SPL} against the JAX route, channel {k}: "
              f"bad-lane fraction {bad:.6f} max|d| {e:.3e}", flush=True)
        assert bad < 0.01, "the sky launch disagrees with the JAX driver's route"
    times = {}
    for kind, reps in (("plain", 1), ("sky", 5), ("no-sky", 5), ("jax-route", 2), ("jax-route", 2),
                       ("no-sky", 5), ("sky", 5), ("plain", 1)):
        kinds[kind]()  # warm-up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            kinds[kind]()
        end.record()
        end.synchronize()
        times.setdefault(kind, []).append(start.elapsed_time(end) / reps)
        print(f"[timing] {kind} outdoor {W}x{H} spl={TIMING_SPL}: {times[kind][-1]:.3f} ms/launch "
              f"[{card}]", flush=True)
    ms = {k: sum(v) / len(v) for k, v in times.items()}
    print(f"[timing] trace_tiles_sky outdoor {W}x{H} spl={TIMING_SPL}: {ms['sky']:.3f} ms/launch "
          f"({W * H * TIMING_SPL / ms['sky'] / 1e6:.3f} Gpaths/s); without the sky "
          f"{ms['no-sky']:.3f} ms ({ms['sky'] / ms['no-sky']:.3f}x); the JAX route "
          f"{ms['jax-route']:.3f} ms ({ms['jax-route'] / ms['sky']:.2f}x the sky launch); plain "
          f"{ms['plain']:.1f} ms [{card}]", flush=True)

    r, _, counts = sky_render("outdoor + sky", outdoor, MAIN_SPP, card, "trace_tiles_sky")
    _, fused16, _ = sky_render("outdoor + sky", outdoor, SKY_WF_SPP, card, "trace_tiles_sky")
    _, wf16, _ = sky_render("outdoor + sky", outdoor, SKY_WF_SPP, card, use_wavefront=True)
    gate("sky", f"outdoor + sky {W}x{H}x{SKY_WF_SPP} trace_tiles_sky vs the wavefront", fused16,
         wf16)
    card_vs_cpu("sky", "outdoor + sky", outdoor, 128, 64, SKY_WF_SPP)
    resume_bitwise("sky", r, f"outdoor + sky {W}x{H}")
    return dict(ms=ms["sky"], no_sky_ms=ms["no-sky"], route_ms=ms["jax-route"],
                plain_ms=ms["plain"], max_abs_err=err, work=work, misses=fetches,
                sky_bytes=sky_bytes, pool_bytes=tensor_bytes([tables.sky.pool]),
                launches=counts["trace_tiles_sky"], n_sph=tables.n_sph, n_ft=tables.n_ft,
                table_bytes=table_bytes(tables))


def sky_mesh(dev, card, a380, surface):
    """Phase 9, the a380-class surface + sky through mesh_trace_sky (and the
    2,097-triangle cut through mesh_trace_brute_sky), then through the
    wavefront in cpu semantics. Returns {ms, no_sky_ms, plain_ms,
    max_abs_err, lane_bounces, misses, sky_bytes, pool_bytes, launches,
    table_bytes}."""
    import torch

    from raytrace_tpu_torch.models.camera import build_camera
    from raytrace_tpu_torch.models.scene import build_scene
    from raytrace_tpu_torch.ops import mesh_kernel as mk

    fx, fy = (lambda f: (f % MESH_W, f // MESH_W))(
        torch.arange(MESH_W * MESH_H, dtype=torch.int32, device=dev))
    zero = torch.zeros_like(fx)
    out = {}
    for label, scheme, name in (("a380-class + sky", a380, "mesh_trace"),
                                ("surface-2097 + sky", surface, "mesh_trace_brute")):
        t0 = time.perf_counter()
        scene = build_scene(scheme)
        tables = mk.MeshTables(scene, build_camera(scheme.cam, MESH_W, MESH_H), 0.5).to(dev)
        torch.cuda.synchronize()
        route = MESH_KERNELS[name][0]
        print(f"[sky] {label}: {scene.n_mesh_tris} triangles, route {route}, sky pool "
              f"{scene.sky_pool.dtype} x {scene.sky_pool.size}; build_scene + MeshTables "
              f"{time.perf_counter() - t0:.3f} s (host)", flush=True)
        sky = tables.sky

        def launch(spl, with_sky, samp=zero):
            tables.sky = sky if with_sky else None
            try:
                return mk.mesh_trace(fx, fy, samp, tables, route=route, assured=5,
                                     max_bounces=24, samples_per_lane=spl)
            finally:
                tables.sky = sky

        err = 0.0
        for spl in ((1, 4, MESH_SPP) if name == "mesh_trace" else (MESH_SPP,)):
            samp = torch.full_like(fx, 7)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            tables.sky, sky_counts = sky_sectors(sky)
            start.record()
            ref, (iters, misses) = mk.mesh_trace_reference(
                fx, fy, samp, tables, route=route, assured=5, max_bounces=24,
                samples_per_lane=spl, return_counts=True)
            end.record()
            end.synchronize()
            tables.sky = sky
            plain_ms = start.elapsed_time(end)
            ours = launch(spl, True, samp)
            torch.cuda.synchronize()
            differ = int((torch.stack(ours) != torch.stack(ref)).any(0).sum())
            err = max(err, max(lane_gate(ours[k], ref[k])[1] for k in range(3)))
            print(f"[sky] {name}_sky {label} {MESH_W}x{MESH_H} spl={spl}: {differ} lanes differ "
                  f"from the plain version; {int(misses.sum())} of {int(iters.sum())} lane-bounces "
                  f"end in the sky; radiance mean {[round(float(o.mean()) / spl, 6) for o in ours]}; "
                  f"plain {plain_ms:.1f} ms", flush=True)
            assert differ == 0, f"{name}_sky {label} spl={spl}: {differ} lanes differ"
        t = {}  # the counted launch (samp, spl MESH_SPP), with and without the sky
        for kind in ("sky", "no-sky", "no-sky", "sky"):
            launch(MESH_SPP, kind == "sky", samp)  # warm-up
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(2):
                launch(MESH_SPP, kind == "sky", samp)
            end.record()
            end.synchronize()
            t.setdefault(kind, []).append(start.elapsed_time(end) / 2)
        ms = {k: sum(v) / len(v) for k, v in t.items()}
        print(f"[timing] {name}_sky {label} {MESH_W}x{MESH_H} spl={MESH_SPP}: {ms['sky']:.3f} "
              f"ms/launch ({MESH_W * MESH_H * MESH_SPP / ms['sky'] / 1e3:.1f} Mpaths/s), without the "
              f"sky {ms['no-sky']:.3f} ms ({ms['sky'] / ms['no-sky']:.3f}x; turns {t}) [{card}]",
              flush=True)
        fetches, sky_bytes = sky_counts()  # the counted launch's
        assert fetches == int(misses.sum()), "the sky's fetches and the misses disagree"
        out[name] = dict(ms=ms["sky"], no_sky_ms=ms["no-sky"], plain_ms=plain_ms,
                         max_abs_err=err, lane_bounces=float(iters.sum()), misses=fetches,
                         sky_bytes=sky_bytes, pool_bytes=tensor_bytes([sky.pool]),
                         table_bytes=table_bytes(tables))
        del tables

    # the renders: gpu semantics through mesh_trace_sky and the wavefront
    r, img, counts = sky_render("a380-class + sky", a380, MESH_SPP, card, "mesh_trace_sky")
    out["mesh_trace"]["launches"] = counts["mesh_trace_sky"]
    _, wf, _ = sky_render("a380-class + sky", a380, MESH_SPP, card, use_mesh_fused=False)
    gate("sky", f"a380-class + sky {MESH_W}x{MESH_H}x{MESH_SPP} mesh_trace_sky vs the wavefront",
         img, wf)
    resume_bitwise("sky", r, f"a380-class + sky {MESH_W}x{MESH_H}")
    # cpu semantics through the wavefront: mesh_hit and no fused kernel
    cpu = variant(a380, use_gpu=False)
    r, _, counts = sky_render("a380-class + sky", cpu, MESH_SPP, card)
    assert r.driver == "wavefront" and {k for k, v in counts.items() if v} == {"mesh_hit"}, \
        f"the cpu-semantics sky render launched {counts}"
    card_vs_cpu("sky", "a380-class + sky cpu semantics", cpu, 96, 48, SKY_WF_SPP)
    resume_bitwise("sky", r, f"a380-class + sky {MESH_W}x{MESH_H}, cpu semantics")
    return out


def sky_phase(dev, card):
    """Phase 9: the cube map on every path (see the module docstring).
    Returns {"trace_tiles": sky_tiles' result, "mesh_trace": ...,
    "mesh_trace_brute": ...} (sky_mesh's)."""
    from raytrace_tpu_torch.models import procedural
    from raytrace_tpu_torch.models.config import ModelMember

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_sky_") as face_dir:
        t0 = time.perf_counter()
        sky = procedural.sky_cubemap(face_dir)
        print(f"[sky] six {procedural.SKY_SIZE}x{procedural.SKY_SIZE} u8 faces generated and "
              f"written in {time.perf_counter() - t0:.3f} s (host)", flush=True)
        result = {"trace_tiles": sky_tiles(dev, card, procedural.outdoor_scheme(sky, W, H, MAIN_SPP))}
        a380 = procedural.a380_scheme(MESH_W, MESH_H, MESH_SPP)
        a380.scene_members.append(sky)
        surface = procedural.a380_cam_scheme(MESH_W, MESH_H, MESH_SPP)
        surface.scene_members += [ModelMember(path="<2,097-triangle surface>", loaded=[
            procedural.make_mesh(2097, n_textures=0)]), sky]
        result.update(sky_mesh(dev, card, a380, surface))
    print(f"[sky] phase 9 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return result


def sky_bounds(kernels, sky, shape, walk_ops, card):
    """The sky entries' bounds into the trace_tiles and mesh_trace records
    (with sky_ms, sky_plain_ms, sky_launches_per_render): each kernel's
    count on its sky launch's own plain-version counts (sky_phase), plus
    SKY_INSTR a fetch and the distinct sectors of the sky pool the
    launch's fetches read (sky_sectors); shape and walk_ops as the no-sky
    bounds take them."""
    for rec in kernels:
        name = rec["name"]
        if name not in ("trace_tiles", "mesh_trace"):
            continue
        k = sky[name]
        misses = k["misses"]
        if name == "trace_tiles":
            ops = sum(tiles_terms(k["work"], k["n_sph"], k["n_ft"], W * H * TIMING_SPL).values())
            nbytes = k["table_bytes"] + W * H * (3 * 4 + 9 * 4)
        else:
            s = shape[name]
            ops = k["lane_bounces"] * (s["n_sph"] * SPH_OPS + s["n_ft"] * (TRI_OPS - 2)
                                       + SHADE_MESH_OPS + walk_ops)
            nbytes = k["table_bytes"] + MESH_W * MESH_H * (3 * 4 + 3 * 4)
        ops += misses * SKY_INSTR
        nbytes += k["sky_bytes"]
        b_ms, b_by = bound(ops, nbytes, name)
        rec.update(sky_ms=k["ms"], sky_plain_ms=k["plain_ms"], sky_bound_ms=b_ms,
                   sky_bound_by=b_by, sky_launches_per_render=k["launches"])
        print(f"[bound] {name}_sky: {misses:.4g} sky fetches x {SKY_INSTR} FP32 instructions; "
              f"{k['sky_bytes'] / SKY_SECTOR:.4g} distinct {SKY_SECTOR} B sectors of the "
              f"{k['pool_bytes']:.4g} B pool ({k['sky_bytes']:.4g} B; a sector a fetch would be "
              f"{misses * SKY_SECTOR:.4g} B); {ops:.4g} FP32 instructions ({ops / FP32_CEILING[name] * 1e3:.4f}"
              f" ms), {nbytes:.4g} bytes ({nbytes / HBM_RATE * 1e3:.4f} ms): bound {b_ms:.4f} ms by "
              f"{b_by}; kernel {k['ms']:.4f} ms ({b_ms / k['ms']:.2%} of the bound reached), without "
              f"the sky {k['no_sky_ms']:.4f} ms" + (f", the JAX route {k['route_ms']:.4f} ms"
                                                    if "route_ms" in k else "") + f" [{card}]",
              flush=True)


# ---- 10. the differentiable tier ----
DIFF_STEPS = 5  # make_train_step steps on walled
DIFF_GRAD_GATE = 1e-2  # relative L2 of each a380-class gradient, mesh_hit against the plain walk
DIFF_CPU_GATE = 1e-3  # relative L2 of each gradient of the 2,097-triangle cut, card against cpu
DIFF_CPU_GEOM_GATE = 1e-2  # the same of walled in cpu semantics (diff_card_vs_cpu)
DIFF_CUT = (152, 76)  # the 2,097-triangle cut's frame for card against cpu
CAM_LEAVES = ("o", "d", "up", "right")


def diff_setup(scheme, device):
    """(SceneTensors, camera, differentiable params, xs, ys, weights) of a
    scheme's whole frame on `device`; the loss weights uniform in [0, 1)
    from seed 0, the same on every device."""
    import dataclasses

    import torch

    from raytrace_tpu_torch.models.camera import build_camera
    from raytrace_tpu_torch.models.scene import SceneTensors, build_scene
    from raytrace_tpu_torch.render.renderer import params_from_scheme

    w, h = scheme.render_info.width, scheme.render_info.height
    cam = build_camera(scheme.cam, w, h)
    params = dataclasses.replace(params_from_scheme(scheme), differentiable=True)
    scene = SceneTensors(build_scene(scheme), cam, params.max_thres).to(device)
    flat = torch.arange(w * h, dtype=torch.int32, device=device)
    wts = torch.rand((w * h, 3), generator=torch.Generator().manual_seed(0)).to(device)
    return scene, cam, params, flat % w, flat // w, wts


def diff_render(scene, cam, params, xs, ys, wts):
    """One differentiable sample (id 0) of the lanes (xs, ys) through
    renderer.sample_batch, then the backward of sum(sums * wts). Returns
    (sums, {field: gradient} over split_diff_scene's fields and the
    camera's o, d, up, right as cam.*, forward ms, backward ms, the peak
    of allocated device bytes over both (0 on the cpu))."""
    import torch

    from raytrace_tpu_torch.ops.raygen import camera_to_arrays
    from raytrace_tpu_torch.parallel.distributed import split_diff_scene
    from raytrace_tpu_torch.render.renderer import sample_batch

    dev = xs.device
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    diff, merge = split_diff_scene(scene)
    leaves = {k: v.requires_grad_() for k, v in diff.items()}
    cm = camera_to_arrays(cam, dev)
    cam_leaves = {f"cam.{k}": getattr(cm, k).requires_grad_() for k in CAM_LEAVES}
    sync()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    out = sample_batch(merge(leaves), params, xs, ys, 0, 1, cam=cm)
    sync()
    t1 = time.perf_counter()
    (out * wts).sum().backward()
    sync()
    t2 = time.perf_counter()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    grads = {k: v.grad if v.grad is not None else torch.zeros_like(v)
             for k, v in {**leaves, **cam_leaves}.items()}
    return out.detach(), grads, (t1 - t0) * 1e3, (t2 - t1) * 1e3, peak


def rel_l2(ours, ref):
    """|ours - ref| / |ref| in f64: 0 where both are 0, inf where only ref is."""
    num = float((ours.double() - ref.double().to(ours.device)).norm())
    den = float(ref.double().norm())
    return 0.0 if num == 0.0 else (num / den if den else float("inf"))


def plain_mesh_hit(o, d, t_seed, tables, *, t_min):
    """mesh_hit's plain walk on the card's tensors, in the kernel's place."""
    import numpy as np
    import torch

    from raytrace_tpu_torch.ops import mesh_kernel as mk

    t, gid, u, v = mk.mesh_hit_walk(o, d, t_seed, tables, t_min=float(np.float32(t_min)))
    return t, gid.to(torch.int32), u, v


def polyak_step(scene, loss, grads, fields=("sph_emissive", "sph_rgb"), fraction=0.1):
    """A gradient step over `fields` of `fraction` * loss / |g|^2 (as
    tests/test_torch_train_step.py takes it)."""
    lr = fraction * float(loss) / sum(float((grads[k] ** 2).sum()) for k in fields)
    return scene.replace(**{k: getattr(scene, k) - lr * grads[k] for k in fields})


def diff_walled(dev, card):
    """Walled 1200x600 through the differentiable sample_batch: the image
    bitwise the forward render's, finite gradients, forward / backward ms
    and peak memory; then DIFF_STEPS steps of make_train_step from the
    perturbed scene toward the true scene's image, the loss falling."""
    import dataclasses

    import torch

    from raytrace_tpu_torch.models.walled import walled_scheme
    from raytrace_tpu_torch.ops.raygen import camera_to_arrays
    from raytrace_tpu_torch.parallel.distributed import make_train_step
    from raytrace_tpu_torch.render.renderer import sample_batch

    scene, cam, params, xs, ys, wts = diff_setup(walled_scheme(W, H), dev)
    with torch.no_grad():
        plain = sample_batch(scene, dataclasses.replace(params, differentiable=False), xs, ys, 0, 1)
    diff_render(scene, cam, params, xs, ys, wts)  # warm: loads torch's kernels
    out, grads, fwd, bwd, peak = diff_render(scene, cam, params, xs, ys, wts)
    assert torch.equal(out, plain), "walled: the differentiable forward is not the forward render"
    bad = [k for k, g in grads.items() if not bool(torch.isfinite(g).all())]
    assert not bad, f"walled: non-finite gradients of {bad}"
    print(f"[diff] walled {W}x{H}, 1 sample, {params.mode} semantics, assured "
          f"{params.assured_depth}, {params.max_bounces} bounces: image bitwise the forward "
          f"render's; forward {fwd:.1f} ms, backward {bwd:.1f} ms, peak {peak / 2**30:.2f} GiB "
          f"allocated; |gradient| "
          + ", ".join(f"{k} {float(g.norm()):.4g}" for k, g in grads.items()) + f" [{card}]",
          flush=True)

    # train from the perturbed scene toward the true image at the same sample ids
    em, rgb = scene.sph_emissive.clone(), scene.sph_rgb.clone()
    em[7:9] *= 0.5  # the two emitters
    rgb[9:13] += 0.1  # the four walls
    sc, losses, times = scene.replace(sph_emissive=em, sph_rgb=rgb), [], []
    step = make_train_step()
    for _ in range(DIFF_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, (g, _) = step(sc, camera_to_arrays(cam, dev), params, xs, ys, 0, plain)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss))
        sc = polyak_step(sc, loss, g)
    print(f"[diff] walled make_train_step x{DIFF_STEPS} (sph_emissive, sph_rgb, a tenth of the "
          f"Polyak step): loss {losses}, ms per step {[round(t, 1) for t in times]} [{card}]",
          flush=True)
    assert all(b < a for a, b in zip(losses, losses[1:])), "walled: the loss did not fall"
    return dict(fwd_ms=fwd, bwd_ms=bwd, peak_gib=peak / 2**30, losses=losses, step_ms=times)


def diff_a380(dev, card):
    """The a380-class 1216x608 frame through the differentiable
    sample_batch: mesh_hit's launches; the recomputed (t, u, v) bitwise the
    kernel's on the frame's primary rays; the image bitwise the forward
    render's; the image and every gradient against the same render with
    the plain walk in mesh_hit's place (the tile gate, DIFF_GRAD_GATE)."""
    import dataclasses

    import torch

    from raytrace_tpu_torch.models import procedural
    from raytrace_tpu_torch.ops import mesh_kernel as mk
    from raytrace_tpu_torch.ops import raygen, rng
    from raytrace_tpu_torch.ops.intersect import EPS, INF, triangle_tuv
    from raytrace_tpu_torch.ops.texture import take
    from raytrace_tpu_torch.render import integrator as itg
    from raytrace_tpu_torch.render.renderer import sample_batch

    scene, cam, params, xs, ys, wts = diff_setup(
        procedural.a380_scheme(MESH_W, MESH_H, MESH_SPP), dev)

    # the primary rays: the kernel's (t, u, v) and the recomputation at its ids
    state = rng.init_state(xs, ys, torch.zeros_like(xs))
    _, ro, rd = raygen.generate_paths(state, xs, ys, scene.cam, scene.has_lens)
    t, gid, u, v = mk.mesh_hit(ro, rd, torch.full_like(ro[0], INF), scene.mesh, t_min=EPS)
    won = gid >= 0
    g = gid.long().clamp(min=0)
    rt, ru, rv = triangle_tuv(*ro, *rd, *(take(getattr(scene, k), g).unbind(1)
                                          for k in ("mt_v0", "mt_e1", "mt_e2")))
    same = all(torch.equal(a[won], b[won]) for a, b in ((t, rt), (u, ru), (v, rv)))
    print(f"[diff] a380-class primary rays: {int(won.sum())} of {won.numel()} hit the mesh; "
          f"(t, u, v) recomputed at mesh_hit's ids from mt_v0 / mt_e1 / mt_e2: "
          f"{'bitwise equal to' if same else 'different from'} the kernel's", flush=True)
    assert same, "the recomputed (t, u, v) differ from the kernel's"

    with torch.no_grad():
        forward = sample_batch(scene, dataclasses.replace(params, differentiable=False), xs, ys,
                               0, 1)
    diff_render(scene, cam, params, xs, ys, wts)  # warm
    reset_launches()
    out, grads, fwd, bwd, peak = diff_render(scene, cam, params, xs, ys, wts)
    counts = dict(mk.LAUNCHES)
    launches = counts.pop("mesh_hit")
    assert launches > 0 and not any(counts.values()), f"launches {counts}, mesh_hit {launches}"
    assert torch.equal(out, forward), "a380-class: the differentiable forward is not the forward"
    real = itg.mesh_hit
    itg.mesh_hit = plain_mesh_hit
    try:
        out_p, grads_p, fwd_p, bwd_p, peak_p = diff_render(scene, cam, params, xs, ys, wts)
    finally:
        itg.mesh_hit = real
    print(f"[diff] a380-class {MESH_W}x{MESH_H}, 1 sample, {params.mode} semantics, "
          f"{params.max_bounces} bounces, through mesh_hit ({launches} launches a render): forward "
          f"{fwd:.1f} ms, backward {bwd:.1f} ms, peak {peak / 2**30:.2f} GiB; image bitwise the "
          f"forward render's; with the plain walk in its place: forward {fwd_p:.1f} ms, backward "
          f"{bwd_p:.1f} ms, peak {peak_p / 2**30:.2f} GiB [{card}]", flush=True)
    lanes = int((out != out_p).any(dim=1).sum())
    print(f"[diff] a380-class: {lanes} of {out.shape[0]} lanes differ between mesh_hit and the "
          f"plain walk", flush=True)
    img = lambda a: a.reshape(MESH_H, MESH_W, 3).cpu().numpy()
    gate("diff", f"a380-class {MESH_W}x{MESH_H}x1 mesh_hit vs the plain walk", img(out), img(out_p))
    rels = {k: rel_l2(grads[k], grads_p[k]) for k in grads}
    print("[diff] a380-class gradients, relative L2 mesh_hit vs the plain walk (|plain|): "
          + ", ".join(f"{k} {r:.3e} ({float(grads_p[k].norm()):.4g})" for k, r in rels.items()),
          flush=True)
    bad = [k for k, r in rels.items() if not r <= DIFF_GRAD_GATE]
    assert not bad, f"a380-class: the gradients of {bad} are over the {DIFF_GRAD_GATE} gate"
    return dict(launches=launches, fwd_ms=fwd, bwd_ms=bwd, peak_gib=peak / 2**30, lanes=lanes,
                rel_l2=rels)


def diff_card_vs_cpu(dev, card):
    """One differentiable sample at DIFF_CUT on the card (mesh_hit) and on
    the cpu (the plain walk): the 2,097-triangle cut (four 256x256
    textures; in gpu semantics only its emissive, colour factor and texels
    take gradients), every gradient within DIFF_CPU_GATE; and walled in
    cpu semantics, where the spheres' centres and radii and the camera
    take them too (the dielectrics' angle-dependent weights), within
    DIFF_CPU_GEOM_GATE: sine and cosine may differ by an ulp between the
    card and the cpu, and move a knife-edge path."""
    import torch

    from raytrace_tpu_torch.models import procedural
    from raytrace_tpu_torch.models.config import ModelMember
    from raytrace_tpu_torch.models.walled import walled_scheme

    w, h = DIFF_CUT
    surface = procedural.a380_cam_scheme(w, h, 1)
    surface.scene_members.append(ModelMember(path="<2,097-triangle surface>", loaded=[
        procedural.make_mesh(2097, n_textures=4, tex_size=256)]))
    result = {}
    for label, scheme, limit in (
            ("surface-2097", surface, DIFF_CPU_GATE),
            ("walled cpu semantics", variant(walled_scheme(w, h), use_gpu=False),
             DIFF_CPU_GEOM_GATE)):
        runs = []
        for device in (dev, torch.device("cpu")):
            t0 = time.perf_counter()
            runs.append(diff_render(*diff_setup(scheme, device)))
            print(f"[diff] {label} {w}x{h} on the {device.type}: "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
        (out, grads, *_), (out_c, grads_c, *_) = runs
        lanes = int((out.cpu() != out_c).any(dim=1).sum())
        rels = {k: rel_l2(grads[k].cpu(), grads_c[k]) for k in grads}
        print(f"[diff] {label} card vs cpu: {lanes} lanes differ; gradients' relative L2 "
              f"(|cpu|) " + ", ".join(f"{k} {r:.3e} ({float(grads_c[k].norm()):.4g})"
                                     for k, r in rels.items()), flush=True)
        bad = [k for k, r in rels.items() if not r <= limit]
        assert not bad, f"{label}: card and cpu gradients of {bad} differ over {limit}"
        result[label] = dict(lanes=lanes, rel_l2=rels)
    return result


def diff_phase(dev, card):
    """Phase 10: the differentiable tier (see the module docstring)."""
    t_phase = time.perf_counter()
    result = dict(walled=diff_walled(dev, card), a380=diff_a380(dev, card),
                  card_vs_cpu=diff_card_vs_cpu(dev, card))
    print(f"[diff] phase 10 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return result


def profile_diff(card):
    """torch.profiler over one warm differentiable a380-class render
    (forward and backward): device time by kernel, and mesh_hit's ms per
    launch and share. Returns {ms, share, device_ms, launches} or None
    without device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity

    from raytrace_tpu_torch.models import procedural

    setup = diff_setup(procedural.a380_scheme(MESH_W, MESH_H, MESH_SPP), torch.device("cuda", 0))
    diff_render(*setup)  # warm
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, _, fwd, bwd, _ = diff_render(*setup)
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and not e.is_user_annotation]
    total = sum(float(e.self_device_time_total) for e in kernels)
    label = f"a380-class {MESH_W}x{MESH_H} differentiable render, forward and backward"
    print(f"[profile] {label}: device time {total / 1e3:.3f} ms in {fwd + bwd:.1f} ms of wall "
          f"time (profiled) [{card}]", flush=True)
    if total <= 0:
        print("[profile] the profiler recorded no device time", flush=True)
        return None
    for e in sorted(kernels, key=lambda e: float(e.self_device_time_total), reverse=True)[:12]:
        us = float(e.self_device_time_total)
        print(f"[profile] {us / total:7.2%} {us / 1e3:10.3f} ms {e.count:7d}x {e.key[:90]}",
              flush=True)
    mine = [e for e in kernels if "mesh_hit_kernel" in e.key]
    hit, count = sum(float(e.self_device_time_total) for e in mine), sum(e.count for e in mine)
    print(f"[profile] mesh_hit_kernel {hit / total:.2%} of device time, {count} launches, "
          f"{hit / 1e3 / max(count, 1):.4f} ms a launch", flush=True)
    return {"ms": hit / 1e3 / max(count, 1), "share": hit / total, "device_ms": total / 1e3,
            "launches": count}


# ---- 11. pcg, animation and the host remainder ----
ANIM_DEPTHS = (2, 1, 1, 2)  # the animation pipeline's depths, in turns
HOOK_BATCH = 8  # walled's render_batch in the hook timing (render(64): 8 batches)


def pcg_tiles(dev, card, outdoor):
    """Phase 11a, trace_tiles' pcg instantiations against the plain version
    under pcg, the lane gate: walled 1200x600 at samples per lane 1 (all 9
    outputs) and 4, the mixed 64x32 scene at 1 and 4, outdoor + sky at 1;
    each launch counted under its <entry>_pcg key alone; then the main
    path's launch (walled, TIMING_SPL) timed in turns weyl, pcg, pcg, weyl.
    Returns {ms, weyl_ms, max_abs_err}."""
    import torch

    from raytrace_tpu_torch.models.camera import build_camera
    from raytrace_tpu_torch.models.scene import build_scene
    from raytrace_tpu_torch.models.walled import walled_scheme
    from raytrace_tpu_torch.ops import trace_kernel as tk

    def setup(scheme):
        w, h = scheme.render_info.width, scheme.render_info.height
        tables = tk.SceneTables(build_scene(scheme), build_camera(scheme.cam, w, h),
                                scheme.render_info.rad_info.russ_roull_info.max_thres).to(dev)
        flat = torch.arange(w * h, dtype=torch.int32, device=dev)
        return tables, flat % w, flat // w

    def run(fn, tables, xs, ys, samp, assured, spl, generator):
        return fn(xs, ys, samp, tables.sph, tables.ft, tables.cam_vec, n_sph=tables.n_sph,
                  n_ft=tables.n_ft, has_lens=tables.has_lens, assured=assured, max_bounces=24,
                  samples_per_lane=spl, sky=tables.sky, generator=generator)

    err = 0.0
    walled, mixed = walled_scheme(W, H), mixed_scheme(64, 32)
    for label, scheme, assured, spl in (("walled", walled, 5, 1), ("walled", walled, 5, 4),
                                        ("mixed", mixed, 2, 1), ("mixed", mixed, 2, 4),
                                        ("outdoor + sky", outdoor, 5, 1)):
        tables, xs, ys = setup(scheme)
        samp = torch.full_like(xs, 7)
        ref = run(tk.trace_tiles_reference, tables, xs, ys, samp, assured, spl, "pcg")
        reset_launches()
        ours = run(tk.trace_tiles, tables, xs, ys, samp, assured, spl, "pcg")
        torch.cuda.synchronize()
        key = tk.launch_key("trace_tiles", tables.sky, "pcg")
        assert tk.LAUNCHES[key] == 1 == sum(tk.LAUNCHES.values()), f"launches {tk.LAUNCHES}"
        weyl = run(tk.trace_tiles, tables, xs, ys, samp, assured, spl, "weyl")
        n_out = 9 if spl == 1 else 3
        worst = 0.0
        for k in range(n_out):
            bad, e = lane_gate(ours[k], ref[k])
            worst, err = max(worst, bad), max(err, e)
            assert bad < 0.01, f"{key} {label} spl={spl} output {k}: {bad:.4f} of lanes differ"
        differ = int((torch.stack(ours[:n_out]) != torch.stack(ref[:n_out])).any(0).sum())
        other = int((torch.stack(ours[:3]) != torch.stack(weyl[:3])).any(0).sum())
        print(f"[pcg] {key} {label} {xs.numel()} lanes spl={spl}: worst bad-lane fraction "
              f"{worst:.6f} over {n_out} outputs (limit 0.01), {differ} lanes differ from the "
              f"plain version, max|d| {err:.3e}; {other} lanes differ from the weyl launch; "
              f"radiance mean {[round(float(o.mean()) / spl, 5) for o in ours[:3]]}", flush=True)
        assert other > 0, f"{key}: the pcg launch equals the weyl one"

    tables, xs, ys = setup(walled)
    zero = torch.zeros_like(xs)

    def timed(generator, reps=5):
        run(tk.trace_tiles, tables, xs, ys, zero, 5, TIMING_SPL, generator)  # warm-up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            run(tk.trace_tiles, tables, xs, ys, zero, 5, TIMING_SPL, generator)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps

    t = {}
    for generator in ("weyl", "pcg", "pcg", "weyl"):
        t.setdefault(generator, []).append(timed(generator))
    ms = {k: sum(v) / len(v) for k, v in t.items()}
    print(f"[timing] trace_tiles walled {W}x{H} spl={TIMING_SPL} in turns weyl, pcg, pcg, weyl: "
          f"pcg {ms['pcg']:.3f} ms/launch (turns {t['pcg']}), weyl {ms['weyl']:.3f} ms (turns "
          f"{t['weyl']}): pcg / weyl {ms['pcg'] / ms['weyl']:.3f} [{card}]", flush=True)
    return dict(ms=ms["pcg"], weyl_ms=ms["weyl"], max_abs_err=err)


def pcg_mesh(dev, card, a380, a380_sky, surface):
    """Phase 11a, mesh_trace's and mesh_trace_brute's pcg instantiations
    bitwise against the plain version under pcg on the whole frame: the
    a380-class surface at samples per lane 1 and MESH_SPP, with the sky at
    1, the 2,097-triangle cut (brute route) at MESH_SPP; each launch counted
    under its <entry>_pcg key alone; each route's MESH_SPP launch timed in
    turns weyl, pcg, pcg, weyl. Returns {name: {ms, weyl_ms, max_abs_err}}."""
    import torch

    from raytrace_tpu_torch.models.camera import build_camera
    from raytrace_tpu_torch.models.scene import build_scene
    from raytrace_tpu_torch.ops import mesh_kernel as mk

    fx, fy = (lambda f: (f % MESH_W, f // MESH_W))(
        torch.arange(MESH_W * MESH_H, dtype=torch.int32, device=dev))
    zero = torch.zeros_like(fx)
    out = {}
    for label, scheme, name, spls in (("a380-class", a380, "mesh_trace", (1, MESH_SPP)),
                                      ("a380-class + sky", a380_sky, "mesh_trace", (1,)),
                                      ("surface-2097", surface, "mesh_trace_brute", (MESH_SPP,))):
        route = MESH_KERNELS[name][0]
        t0 = time.perf_counter()
        tables = mk.MeshTables(build_scene(scheme), build_camera(scheme.cam, MESH_W, MESH_H),
                               0.5).to(dev)
        torch.cuda.synchronize()
        print(f"[pcg] {label}: build_scene + MeshTables {time.perf_counter() - t0:.3f} s (host), "
              f"route {route}", flush=True)

        def launch(spl, generator, samp, fn=mk.mesh_trace):
            return fn(fx, fy, samp, tables, route=route, assured=5, max_bounces=24,
                      samples_per_lane=spl, generator=generator)

        err = 0.0
        for spl in spls:
            samp = torch.full_like(fx, 7)
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            ref = launch(spl, "pcg", samp, mk.mesh_trace_reference)
            end.record()
            end.synchronize()
            reset_launches()
            ours = launch(spl, "pcg", samp)
            torch.cuda.synchronize()
            key = mk.launch_key(name, tables.sky, "pcg")
            assert mk.LAUNCHES[key] == 1 == sum(mk.LAUNCHES.values()), f"launches {mk.LAUNCHES}"
            weyl = launch(spl, "weyl", samp)
            differ = int((torch.stack(ours) != torch.stack(ref)).any(0).sum())
            other = int((torch.stack(ours) != torch.stack(weyl)).any(0).sum())
            err = max(err, max(lane_gate(ours[k], ref[k])[1] for k in range(3)))
            print(f"[pcg] {key} {label} {MESH_W}x{MESH_H} spl={spl}: {differ} lanes differ from "
                  f"the plain version; {other} lanes differ from the weyl launch; radiance mean "
                  f"{[round(float(o.mean()) / spl, 6) for o in ours]}; plain "
                  f"{start.elapsed_time(end):.1f} ms", flush=True)
            assert differ == 0, f"{key} {label} spl={spl}: {differ} lanes differ"
            assert other > 0, f"{key}: the pcg launch equals the weyl one"
        if tables.sky is None:
            t = {}
            for generator in ("weyl", "pcg", "pcg", "weyl"):
                launch(MESH_SPP, generator, zero)  # warm-up
                start, end = (torch.cuda.Event(enable_timing=True),
                              torch.cuda.Event(enable_timing=True))
                start.record()
                for _ in range(2):
                    launch(MESH_SPP, generator, zero)
                end.record()
                end.synchronize()
                t.setdefault(generator, []).append(start.elapsed_time(end) / 2)
            ms = {k: sum(v) / len(v) for k, v in t.items()}
            print(f"[timing] {name} {label} {MESH_W}x{MESH_H} spl={MESH_SPP} in turns weyl, pcg, "
                  f"pcg, weyl: pcg {ms['pcg']:.3f} ms/launch (turns {t['pcg']}), weyl "
                  f"{ms['weyl']:.3f} ms (turns {t['weyl']}): pcg / weyl "
                  f"{ms['pcg'] / ms['weyl']:.3f} [{card}]", flush=True)
            out[name] = dict(ms=ms["pcg"], weyl_ms=ms["weyl"], max_abs_err=err)
        del tables
    return out


def pcg_renders(dev, card, a380, surface):
    """Phase 11a, the renders under pcg, each with the launch counts reset
    just before and read just after: walled 1200x600 render(MAIN_SPP)
    (trace_tiles_pcg alone), the a380-class frame's render(MESH_SPP) in gpu
    semantics (mesh_trace_pcg alone) and in cpu semantics through the
    wavefront (mesh_hit alone), the 2,097-triangle cut's on the brute route
    (mesh_trace_brute_pcg alone); walled and the cpu-semantics frame on the
    card against the CPU at a small size and resumed bitwise. Returns
    {entry: launches}."""
    from raytrace_tpu_torch.models.walled import walled_scheme

    walled = walled_scheme(W, H)
    launches = {}
    cpu = variant(a380, use_gpu=False)
    for label, scheme, spp, entry, kw in (
            ("walled", walled, MAIN_SPP, "trace_tiles_pcg", {}),
            ("a380-class", a380, MESH_SPP, "mesh_trace_pcg", {}),
            ("surface-2097", surface, MESH_SPP, "mesh_trace_brute_pcg", dict(route="brute")),
            ("a380-class cpu semantics", cpu, MESH_SPP, "mesh_hit", {})):
        r, _, counts, _ = warm_render("pcg", f"{label} pcg", scheme, spp, card, generator="pcg",
                                      **kw)
        launched = {k for k, v in counts.items() if v}
        assert launched == {entry}, f"{label}: the pcg render launched {counts}"
        launches[entry] = counts[entry]
        if label == "walled":
            card_vs_cpu("pcg", "walled pcg", walled, 128, 64, 16, generator="pcg")
            resume_bitwise("pcg", r, f"walled {W}x{H} pcg")
        elif label.endswith("cpu semantics"):
            card_vs_cpu("pcg", "a380-class cpu semantics pcg", cpu, 96, 48, MESH_SPP,
                        generator="pcg")
            resume_bitwise("pcg", r, f"a380-class {MESH_W}x{MESH_H} cpu semantics pcg")
    return launches


def pcg_phase(dev, card):
    """Phase 11a: the pcg generator on every kernel and render path (see
    the module docstring). Returns {"trace_tiles": pcg_tiles', mesh
    entries: pcg_mesh's, "launches": pcg_renders'}."""
    from raytrace_tpu_torch.models import procedural
    from raytrace_tpu_torch.models.config import ModelMember

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_sky_") as face_dir:
        sky = procedural.sky_cubemap(face_dir)
        outdoor = procedural.outdoor_scheme(sky, W, H, MAIN_SPP)
        result = {"trace_tiles": pcg_tiles(dev, card, outdoor)}
        a380 = procedural.a380_scheme(MESH_W, MESH_H, MESH_SPP)
        a380_sky = copy.copy(a380)
        a380_sky.scene_members = a380.scene_members + [sky]
        surface = procedural.a380_cam_scheme(MESH_W, MESH_H, MESH_SPP)
        surface.scene_members.append(ModelMember(path="<2,097-triangle surface>", loaded=[
            procedural.make_mesh(2097, n_textures=0)]))
        result.update(pcg_mesh(dev, card, a380, a380_sky, surface))
    result["launches"] = pcg_renders(dev, card, a380, surface)
    print(f"[pcg] phase 11a in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return result


def video_facts(path):
    """(the encode_mp4 rung that wrote `path`, the frames read back from it)."""
    if path.endswith(".avi"):  # the MJPEG-AVI rung: count idx1's 16-byte entries
        with open(path, "rb") as f:
            data = f.read()
        at = data.rindex(b"idx1")
        return "mjpeg-avi", int.from_bytes(data[at + 4:at + 8], "little") // 16
    try:
        import cv2
    except ImportError:
        import imageio

        return "imageio", imageio.get_reader(path).count_frames()
    cap = cv2.VideoCapture(path)
    code = int(cap.get(cv2.CAP_PROP_FOURCC)).to_bytes(4, "little").decode("ascii", "replace")
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    # MPEG-4 part 2 (cv2's mp4v, read back as FMP4) or imageio's H.264
    return ("opencv mp4v" if code.lower() in ("mp4v", "fmp4") else f"imageio ({code})"), n


def anim_phase(dev, card):
    """Phase 11b: animation through cli._render_animation in a temporary
    working directory: the animated walled 1200x600 (two spheres keyframed
    through the bezier, polynomial, Step and Hold easings) at 8 frames of
    MAIN_SPP and the animated a380-class 1216x608 surface (translation and
    Euler angles) at 4 frames of MESH_SPP, each at the pipeline depths
    ANIM_DEPTHS in turns with its per-frame build, render and PNG seconds;
    every frame's PNG bitwise a fresh Renderer(frame, "cuda")'s; frame 0
    and the last at a small size against the CPU; the encode rung, its
    seconds and the frames read back. Returns {label: {depth: mean seconds
    a frame, ...}}."""
    import argparse

    import numpy as np

    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.models import procedural
    from raytrace_tpu_torch.models.animation import extract_frames
    from raytrace_tpu_torch.render.renderer import Renderer
    from raytrace_tpu_torch.utils.image import encode_png

    t_phase = time.perf_counter()
    args = argparse.Namespace(device="cuda", mode=None, samples=None, generator="weyl")
    cases = (("walled", procedural.animated_walled_scheme(W, H, MAIN_SPP, framerate=8), (128, 64)),
             ("a380-class", procedural.animated_a380_scheme(MESH_W, MESH_H, MESH_SPP,
                                                            framerate=4), (96, 48)))
    result, cwd = {}, os.getcwd()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_anim_") as tmp:
        os.chdir(tmp)
        try:
            for label, scheme, small in cases:
                info = scheme.render_info
                per = {}
                for depth in ANIM_DEPTHS:
                    info.anim_pipeline_depth = depth
                    res = cli._render_animation(scheme, args)
                    frames = res["frames"]
                    for i, f in enumerate(frames):
                        print(f"[anim] {label} {info.width}x{info.height} depth {depth} frame {i}: "
                              + ", ".join(f"{k} {v:.4f}" for k, v in f.items()), flush=True)
                    rung, n = video_facts(res["video"])
                    mean = {k: float(np.mean([f[k] for f in frames])) for k in frames[0]}
                    before = res["seconds"] - res["encode_s"]
                    print(f"[anim] {label} depth {depth}: {len(frames)} frames in "
                          f"{res['seconds']:.3f} s ({before / len(frames):.4f} s a frame before "
                          f"the encode; mean s a frame "
                          f"{ {k: round(v, 4) for k, v in mean.items()} }); encoded by {rung} "
                          f"to {os.path.basename(res['video'])} in {res['encode_s']:.3f} s, "
                          f"{n} frames read back [{card}]", flush=True)
                    assert n == len(frames) == res["n_frames"], f"{label}: {n} frames read back"
                    per.setdefault(depth, []).append(before)
                frames = extract_frames(scheme, info.framerate)
                for i, f in enumerate(frames):
                    r = Renderer(f, device="cuda")
                    r.render(progress=False)
                    with open(os.path.join(cli.ANIM_DIR, f"{i}.png"), "rb") as fh:
                        same = fh.read() == encode_png(r.target.to_u8_rgba())
                    assert same, f"{label} frame {i}: the PNG is not the single-frame render's"
                print(f"[anim] {label}: every frame's PNG ({len(frames)}) bitwise a fresh "
                      f"Renderer(frame, 'cuda').render({info.samps_per_pix})'s", flush=True)
                for k in (0, len(frames) - 1):
                    card_vs_cpu("anim", f"{label} frame {k}", frames[k], *small,
                                min(info.samps_per_pix, 16))
                depth_s = {d: sum(v) / len(v) / len(frames) for d, v in per.items()}
                print(f"[anim] {label}: seconds a frame before the encode, depth 2 "
                      f"{depth_s[2]:.4f}, depth 1 {depth_s[1]:.4f} (turns {per}) [{card}]",
                      flush=True)
                result[label] = depth_s
        finally:
            os.chdir(cwd)
    print(f"[anim] phase 11b in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return result


def host_phase(dev, card):
    """Phase 11c: walled 1200x600 render(MAIN_SPP) in batches of
    HOOK_BATCH with a PNG + checkpoint hook, timed with async_hook on and
    off in turns, the final target bitwise equal both ways and to the
    no-hook render in the same batches; a LivePreview on 127.0.0.1 fetched
    once, equal to the final image. Returns {async_ms, sync_ms}."""
    import io
    import urllib.request

    import numpy as np
    import torch
    from PIL import Image

    from raytrace_tpu_torch.models.walled import walled_scheme
    from raytrace_tpu_torch.render.renderer import Renderer
    from raytrace_tpu_torch.render.target import RenderTarget
    from raytrace_tpu_torch.utils import checkpoint as ckpt
    from raytrace_tpu_torch.utils.image import save_png
    from raytrace_tpu_torch.utils.preview import LivePreview

    t_phase = time.perf_counter()
    scheme = walled_scheme(W, H)
    scheme.render_info.render_batch = HOOK_BATCH
    r = Renderer(scheme, device="cuda")
    r.render(progress=False, samples=1)  # warm
    r.target = RenderTarget(W, H)
    r.render(progress=False, samples=MAIN_SPP, batch=HOOK_BATCH)
    plain = r.target.acc.copy()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_hook_") as tmp:
        calls = []

        def hook(target):
            save_png(os.path.join(tmp, "out.png"), target.to_u8_rgba())
            ckpt.save(os.path.join(tmp, "ck.npz"), target)
            calls.append(target.count)

        t, runs = {}, {}
        for mode in ("async", "sync", "sync", "async"):
            r.target = RenderTarget(W, H)
            calls.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.render(samples=MAIN_SPP, update_hook=hook, async_hook=mode == "async",
                     progress=False)
            dt = (time.perf_counter() - t0) * 1e3
            t.setdefault(mode, []).append(dt)
            runs[mode] = r.target.acc.copy()
            assert calls[-1] == MAIN_SPP and ckpt.load(os.path.join(tmp, "ck.npz")).count == \
                MAIN_SPP, f"{mode}: the final snapshot was not delivered ({calls})"
            print(f"[hook] walled {W}x{H} render({MAIN_SPP}) in {MAIN_SPP // HOOK_BATCH} batches, "
                  f"PNG + checkpoint hook, {mode}: {dt:.1f} ms, the hook ran {len(calls)} times "
                  f"(counts {calls}) [{card}]", flush=True)
    assert np.array_equal(runs["async"], runs["sync"]) and np.array_equal(runs["sync"], plain), \
        "the hooked renders' targets differ"
    ms = {k: sum(v) / len(v) for k, v in t.items()}
    print(f"[hook] async {ms['async']:.1f} ms, sync {ms['sync']:.1f} ms ({t}); final targets "
          f"bitwise equal both ways and to the no-hook render [{card}]", flush=True)

    pv = LivePreview(port=0)
    pv.start()
    try:
        r.target = RenderTarget(W, H)
        r.render(samples=MAIN_SPP, update_hook=pv.update, progress=False)
        with urllib.request.urlopen(f"http://127.0.0.1:{pv.port}/frame", timeout=30) as resp:
            body = resp.read()
        got = np.asarray(Image.open(io.BytesIO(body)))
        assert np.array_equal(got, r.target.to_u8_rgba()[::-1]), "the preview is not the image"
        print(f"[hook] LivePreview on 127.0.0.1:{pv.port}: /frame ({len(body)} bytes PNG) equals "
              f"the final image", flush=True)
    finally:
        pv.stop()
    print(f"[hook] phase 11c in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(async_ms=ms["async"], sync_ms=ms["sync"])


# ---- 12. parallel/ under torch.distributed ----
# Ranks of torchrun children that run this script in DIST_CHILD mode. The
# run needs one card, and NCCL takes no two ranks on one card: so NCCL runs
# at a world of 1 (a real NCCL all-reduce on the card), and the
# two-rank runs use gloo on CUDA tensors, both ranks on cuda:0, sharing its
# SMs: they measure correctness and the collective's cost, not scaling.
DIST_CHILD = "--dist"  # the arguments of a rank: --dist <backend> <out dir> <card>
DIST_REPS = 10  # all-reduces of an image's sums timed a rank
DIST_ODD = 5  # render(samples=DIST_ODD) must add exactly that many
DIST_WF_K = 2  # the cpu-semantics resume's k (render(2k) against k + k)


def dist_renders():
    """Phase 12's renders: (label, scheme, Renderer keywords, spp, samples
    a launch of the one-process render whose launches cover the two
    ranks' slices, or None where the driver adds per sample)."""
    from raytrace_tpu_torch.models import procedural
    from raytrace_tpu_torch.models.walled import walled_scheme

    a380 = procedural.a380_scheme(MESH_W, MESH_H, MESH_SPP)
    return [("walled", walled_scheme(W, H), {}, MAIN_SPP, MAIN_SPP // 2),
            ("a380-class", a380, {}, MESH_SPP, MESH_SPP // 2),
            ("a380-class cpu", a380, dict(mode="cpu"), MESH_SPP, None)]


def tables_digest(module) -> str:
    """sha256 over a module's buffers, by name (the replicated scene tables)."""
    import hashlib

    h = hashlib.sha256()
    for name, b in sorted(module.named_buffers()):
        h.update(name.encode())
        h.update(b.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def all_reduce_ms(n_pix, dev, group=None):
    """The mean ms of DIST_REPS all-reduces of an (n_pix, 3) f32 tensor on
    dev over group (after 3 warm ones), each synchronised."""
    import torch
    import torch.distributed as dist

    buf = torch.ones((n_pix, 3), dtype=torch.float32, device=dev)
    for _ in range(3):
        dist.all_reduce(buf, group=group)
    torch.cuda.synchronize()
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(DIST_REPS):
        dist.all_reduce(buf, group=group)
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / DIST_REPS * 1e3


def timed_sharded(r, spp):
    """r.render(spp) into a fresh target after a barrier, the launch counts
    reset just before and read just after: (ms, launches)."""
    import torch
    import torch.distributed as dist

    from raytrace_tpu_torch.ops import mesh_kernel as mk
    from raytrace_tpu_torch.ops import trace_kernel as tk
    from raytrace_tpu_torch.render.target import RenderTarget

    r.target = RenderTarget(r.width, r.height)
    torch.cuda.synchronize()
    dist.barrier()
    reset_launches()
    t0 = time.perf_counter()
    r.render(progress=False, samples=spp)  # ends in a device -> host copy
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    return ms, {k: v for k, v in dict(mk.LAUNCHES, **tk.LAUNCHES).items() if v}


def dist_child(backend, out, card) -> int:
    """One rank of phase 12 (under torchrun). nccl (a world of 1): walled
    1200x600 render(MAIN_SPP) through the grouped fused driver against the
    ungrouped render, bitwise, timed in turns. gloo (2 ranks, cuda:0): each
    of dist_renders() through the Renderer over the world (the tables'
    digests all-gathered and equal, a warm render(1), the timed render with
    its launches, a resume, render(samples=DIST_ODD)), then make_train_step
    on make_mesh(tile=1, spp=2) at walled 1200x600, one sample a rank.
    Every rank: the all-reduce's ms at each image's size; its targets,
    loss and gradients into <out>/<backend>_<rank>.npz, its numbers into
    .json."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from raytrace_tpu_torch.models.walled import walled_scheme
    from raytrace_tpu_torch.ops.raygen import camera_to_arrays
    from raytrace_tpu_torch.parallel import multihost
    from raytrace_tpu_torch.parallel.distributed import make_train_step
    from raytrace_tpu_torch.parallel.mesh import make_mesh
    from raytrace_tpu_torch.render.renderer import Renderer
    from raytrace_tpu_torch.render.target import RenderTarget

    assert multihost.init(backend=backend, device="cuda") and dist.get_backend() == backend
    rank, world = dist.get_rank(), dist.get_world_size()
    dev = torch.device("cuda", torch.cuda.current_device())
    tag = f"[dist] {backend} rank {rank}/{world} on {dev}"
    arrays, info = {}, {"rank": rank, "world": world, "backend": backend, "renders": {}}
    if backend == "nccl":
        scheme = walled_scheme(W, H)
        alone, grouped = Renderer(scheme, "cuda"), Renderer(scheme, "cuda", group=dist.group.WORLD)
        assert alone.group is None and grouped.driver == alone.driver == "fused"
        for r in (alone, grouped):
            r.render(progress=False, samples=1)  # warm
        ms, counts = {}, {}
        for label, r in (("alone", alone), ("grouped", grouped), ("grouped", grouped),
                         ("alone", alone)):
            t, counts[label] = timed_sharded(r, MAIN_SPP)
            ms.setdefault(label, []).append(t)
        launches = counts["grouped"]
        assert launches == counts["alone"] == {"trace_tiles": 1}, counts
        assert np.array_equal(grouped.target.acc, alone.target.acc), \
            "nccl: the grouped render is not the ungrouped one"
        info["renders"]["walled"] = dict(ms=ms, launches=launches)
        print(f"{tag}: walled {W}x{H} render({MAIN_SPP}) through the grouped fused driver "
              f"bitwise the ungrouped render; in turns grouped {ms['grouped']} ms, ungrouped "
              f"{ms['alone']} ms; launches {launches} [{card}]", flush=True)
    else:
        for label, scheme, kw, spp, _ in dist_renders():
            r = Renderer(scheme, "cuda", **kw)
            digests = [None] * world
            dist.all_gather_object(digests, tables_digest(r.tables))
            assert len(set(digests)) == 1, f"{label}: the ranks' tables differ"
            r.render(progress=False, samples=1)  # warm
            ms, launches = timed_sharded(r, spp)
            arrays[label] = r.target.acc.copy()
            info["renders"][label] = dict(ms=ms, launches=launches, driver=r.driver,
                                          stats=r.stats, digest=digests[0])
            print(f"{tag}: {label} {r.width}x{r.height} render({spp}), driver {r.driver}, "
                  f"sharded: {ms:.2f} ms, launches {launches}, stats {r.stats}; tables' digest "
                  f"equal on the {world} ranks [{card}]", flush=True)
            resume_bitwise("dist", r, f"{label} rank {rank}", k=DIST_WF_K if kw else 4)
            r.target = RenderTarget(r.width, r.height)
            r.render(progress=False, samples=DIST_ODD)
            assert r.target.count == DIST_ODD, f"{label}: render({DIST_ODD}) added {r.target.count}"
            arrays[label + " odd"] = r.target.acc.copy()
        scene, cam, params, xs, ys, wts = diff_setup(walled_scheme(W, H), dev)
        step = make_train_step(make_mesh(tile=1, spp=2, device_type="cuda"), n_samples=1)
        torch.cuda.synchronize()
        dist.barrier()
        t0 = time.perf_counter()
        loss, (g, gc) = step(scene, camera_to_arrays(cam, dev), params, xs, ys, 0, wts)
        torch.cuda.synchronize()
        info["train_ms"] = (time.perf_counter() - t0) * 1e3
        arrays["loss"] = loss.detach().cpu().numpy()
        arrays.update({"g." + k: v.cpu().numpy() for k, v in g.items()})
        arrays.update({"gc." + k: v.cpu().numpy() for k, v in gc.items()})
        print(f"{tag}: make_train_step on make_mesh(tile=1, spp=2), walled {W}x{H}, one sample "
              f"a rank: loss {float(loss):.9g}, {info['train_ms']:.1f} ms [{card}]", flush=True)
    for label, n_pix in (("walled", W * H), ("a380-class", MESH_W * MESH_H)):
        ms = all_reduce_ms(n_pix, dev)
        info.setdefault("all_reduce", {})[label] = dict(ms=ms, bytes=n_pix * 12)
        print(f"{tag}: all-reduce of the {label} sums, {n_pix * 12} bytes f32: {ms:.3f} ms "
              f"(mean of {DIST_REPS}) [{card}]", flush=True)
    np.savez(os.path.join(out, f"{backend}_{rank}.npz"), **arrays)
    with open(os.path.join(out, f"{backend}_{rank}.json"), "w") as f:
        json.dump(info, f)
    bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "raytrace_tpu")]
    assert not bad, bad
    dist.destroy_process_group()
    return 0


def run_ranks(n, backend, out, card, timeout):
    """torchrun --standalone --nproc-per-node n of this script in
    DIST_CHILD mode, torchrun and its ranks in a new process group of the
    OS (killed together at the timeout); prints its output; raises unless
    every rank succeeded."""
    import signal

    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n}", os.path.abspath(__file__), DIST_CHILD, backend, out, card]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        stdout, stderr = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    for line in stdout.splitlines():
        print(line, flush=True)
    assert proc.returncode == 0, f"{backend} x{n}: rc {proc.returncode}\n{stderr[-4000:]}"
    print(f"[dist] {backend} x{n}: torchrun in {time.perf_counter() - t0:.1f} s", flush=True)


def dist_phase(card):
    """Phase 12: the ranks (run_ranks), then their results against one
    process on the card: NCCL's world of 1 bitwise (in the rank); the two
    gloo ranks' targets bitwise equal; walled and the a380-class gpu
    render bitwise the one-process render at samples_per_launch spp / 2;
    the cpu-semantics render bitwise the rank-order sum of the one-process
    renders of the two slices and under the tile gate against the whole
    one-process render; each render(samples=DIST_ODD) bitwise the sum of
    its slices (3 + 2); the train step's loss bitwise the one-process
    two-sample step's and every gradient within relative L2 1e-3 of it.
    Returns {label: launches a rank of its sharded render}."""
    import numpy as np
    import torch

    from raytrace_tpu_torch.models.scene import build_scene
    from raytrace_tpu_torch.parallel.distributed import make_train_step, sample_slice
    from raytrace_tpu_torch.render.renderer import Renderer

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_dist_") as out:
        run_ranks(1, "nccl", out, card, timeout=300)
        run_ranks(2, "gloo", out, card, timeout=600)
        nccl = json.load(open(os.path.join(out, "nccl_0.json")))
        infos = [json.load(open(os.path.join(out, f"gloo_{r}.json"))) for r in range(2)]
        ranks = [dict(np.load(os.path.join(out, f"gloo_{r}.npz"))) for r in range(2)]
    for k in ranks[0]:
        assert np.array_equal(ranks[0][k], ranks[1][k]), f"gloo: rank 1's {k} is not rank 0's"

    def one(scheme, kw, base, n, spl=256):
        r = Renderer(scheme, "cuda", samples_per_launch=spl, scene=scenes[id(scheme)], **kw)
        r.target.count = base
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render(progress=False, samples=n)
        torch.cuda.synchronize()
        return r.target.acc, (time.perf_counter() - t0) * 1e3

    def slices(scheme, kw, n):
        parts = [one(scheme, kw, off, cnt)[0] for off, cnt in
                 (sample_slice(n, 2, r) for r in range(2))]
        return parts[0] + parts[1]

    launches, renders = {}, dist_renders()
    scenes = {id(scheme): build_scene(scheme) for _, scheme, *_ in renders}
    for label, scheme, kw, spp, half in renders:
        got = ranks[0][label]
        one(scheme, kw, 0, 1)  # warm
        whole, whole_ms = one(scheme, kw, 0, spp, half or 256)
        if half:
            assert np.array_equal(got, whole), \
                f"{label}: 2 ranks are not the 1-process render at {half} samples a launch"
            how = f"bitwise the 1-process render at samples_per_launch {half}"
        else:
            assert np.array_equal(got, slices(scheme, kw, spp)), \
                f"{label}: 2 ranks are not the rank-order sum of the slices"
            w, h = scheme.render_info.width, scheme.render_info.height
            gate("dist", f"{label} 2 ranks against the 1-process render({spp})",
                 got.reshape(h, w, 3) / spp, whole.reshape(h, w, 3) / spp)
            how = "bitwise the rank-order sum of the 1-process slices"
        assert np.array_equal(ranks[0][label + " odd"], slices(scheme, kw, DIST_ODD)), \
            f"{label}: render({DIST_ODD}) is not the sum of its slices"
        rec = [info["renders"][label] for info in infos]
        assert rec[0]["launches"] == rec[1]["launches"] and rec[0]["launches"], rec
        launches[label] = rec[0]["launches"]
        print(f"[dist] {label} render({spp}) over 2 gloo ranks on one card: {how}; both ranks' "
              f"targets equal; render({DIST_ODD}) the sum of its slices; sharded "
              f"{rec[0]['ms']:.2f} / {rec[1]['ms']:.2f} ms (ranks 0 / 1) against the 1-process "
              f"render's {whole_ms:.2f} ms (two ranks share the card's SMs: not scaling); launches "
              f"a rank {launches[label]} [{card}]", flush=True)

    # the train step: one process, two samples, the same target
    from raytrace_tpu_torch.models.walled import walled_scheme
    from raytrace_tpu_torch.ops.raygen import camera_to_arrays

    scene, cam, params, xs, ys, wts = diff_setup(walled_scheme(W, H), torch.device("cuda", 0))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    loss, (g, gc) = make_train_step(n_samples=2)(scene, camera_to_arrays(cam, "cuda"), params,
                                                  xs, ys, 0, wts)
    torch.cuda.synchronize()
    one_ms = (time.perf_counter() - t0) * 1e3
    ref = {"loss": loss.detach().cpu().numpy(), **{"g." + k: v.cpu().numpy() for k, v in g.items()},
           **{"gc." + k: v.cpu().numpy() for k, v in gc.items()}}
    assert np.array_equal(ranks[0]["loss"], ref["loss"]), \
        f"train: loss {ranks[0]['loss']} against the 1-process {ref['loss']}"
    grads = {k: v for k, v in ref.items() if k != "loss" and v.size}
    errs = {k: rel_l2(torch.from_numpy(ranks[0][k]), torch.from_numpy(v))
            for k, v in grads.items()}
    worst = max(errs, key=errs.get)
    print(f"[dist] make_train_step on make_mesh(tile=1, spp=2): loss {float(ref['loss']):.9g} "
          f"bitwise the 1-process two-sample step's; gradients' relative L2 at most "
          f"{errs[worst]:.3e} ({worst}; gate 1e-3), max |d| "
          f"{max(float(np.abs(ranks[0][k] - v).max()) for k, v in grads.items()):.3e}; "
          f"{infos[0]['train_ms']:.1f} / {infos[1]['train_ms']:.1f} ms (ranks) against "
          f"{one_ms:.1f} ms [{card}]", flush=True)
    assert errs[worst] <= 1e-3, f"train: {worst} relative L2 {errs[worst]:.3e}"
    for label in ("walled", "a380-class"):
        ar = [info["all_reduce"][label] for info in (nccl, *infos)]
        print(f"[dist] all-reduce of the {label} sums ({ar[0]['bytes']} bytes f32): NCCL world 1 "
              f"{ar[0]['ms']:.3f} ms, gloo 2 ranks on CUDA tensors {ar[1]['ms']:.3f} / "
              f"{ar[2]['ms']:.3f} ms [{card}]", flush=True)
    print(f"[dist] phase 12 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return dict(launches, nccl=nccl["renders"]["walled"]["launches"])


# ---- 13. two-level instancing: the fleet ----
# group_instances' transform of a ray into an instance's frame, in FP32
# instructions under -fmad=false: o - T 3 FADD, A (o - T) and A d 15 each (9
# FMUL, 6 FADD), and the local walk's three reciprocals of the clamped d' (3
# compares, 3 divides): 39. Its slab test of the instance's world AABB is a
# SLAB_OPS box test.
TRANSFORM_OPS = 39
FLEET_TURNS = 2  # launches a turn in the fleet's timing, after a warm-up
FLEET_KERNELS = {  # record -> (generator, with the sky)
    "mesh_trace_instanced": ("weyl", False),
    "mesh_trace_instanced_sky": ("weyl", True),
    "mesh_trace_instanced_pcg": ("pcg", False),
}
FLEET_REPLACES = "raytrace_tpu/ops/pallas/mesh_bounce_kernel.py:500"  # bounce_tiles' inst_body


def fleet_scheme(face_dir=None, rows=None):
    """procedural.fleet_scheme at the a380-class cell's size (`rows`: its
    rows, by default the fleet's), under the procedural sky written into
    face_dir when one is given."""
    from raytrace_tpu_torch.models import procedural

    scheme = procedural.fleet_scheme(MESH_W, MESH_H, MESH_SPP, rows=rows or procedural.FLEET_ROWS)
    if face_dir is not None:
        scheme.scene_members.append(procedural.sky_cubemap(face_dir))
    return scheme


def fleet_build(dev, card, scheme, label):
    """build_scene (the instanced build's share timed) and MeshTables on the
    card; prints the counts and the kernel tables' bytes. Returns (scene,
    tables)."""
    import torch

    from raytrace_tpu_torch.models import scene as scene_mod
    from raytrace_tpu_torch.models.camera import build_camera
    from raytrace_tpu_torch.models.config import ModelMember
    from raytrace_tpu_torch.ops import mesh_kernel as mk

    real, took = scene_mod._try_build_instancing, []

    def timed(*args):
        t0 = time.perf_counter()
        try:
            return real(*args)
        finally:
            took.append(time.perf_counter() - t0)

    scene_mod._try_build_instancing = timed
    try:
        t0 = time.perf_counter()
        scene = scene_mod.build_scene(scheme)
        t1 = time.perf_counter()
    finally:
        scene_mod._try_build_instancing = real
    tables = mk.MeshTables(scene, build_camera(scheme.cam, MESH_W, MESH_H), 0.5).to(dev)
    torch.cuda.synchronize()
    flat = tensor_bytes(getattr(tables, k) for k in HIT_TABLES)
    local = tensor_bytes(tables.asset.buffers())
    print(f"[fleet] {label}: n_inst {scene.n_inst}, inst_tris {scene.inst_tris}, "
          f"{scene.n_mesh_tris} triangles, {scene.n_clusters} clusters flattened and "
          f"{scene.inst_cl_idx.shape[0]} asset-local; build_scene {t1 - t0:.3f} s, of which the "
          f"instanced build {took[0]:.3f} s; MeshTables {time.perf_counter() - t1:.3f} s (host); "
          f"kernel tables: flattened {flat} B, asset-local {local} B + the instance table "
          f"{tensor_bytes([tables.inst])} B; texel pool {scene.tex_pool.dtype} x "
          f"{scene.tex_pool.size}; route {tables.route}", flush=True)
    n_inst = sum(isinstance(m, ModelMember) for m in scheme.scene_members)
    assert scene.n_inst == n_inst and scene.inst_tris * n_inst == scene.n_mesh_tris
    assert scene.inst_tris == 7300, "the fleet's asset is the 7,300-triangle cut"
    assert scene.tex_pool.size == 4 * 1024 * 1024, "the texel pool does not hold 4 textures once"
    return scene, tables


def fleet_ops(dev, scheme, scene, tables):
    """FP32 operations a ray of the least walk each route needs on the
    fleet frame's rays (frame_rays: primary and one bounce's secondary,
    gpu semantics' t_min), beside the counts: ((instanced ops, counts),
    (flattened ops, counts)). scene: the scheme's build_scene. Prints the
    share of the frame's live primary rays that hit the mesh."""
    from raytrace_tpu_torch.ops import mesh_kernel as mk
    from raytrace_tpu_torch.ops.intersect import EPS, INF

    _, o, d, seed, dead, n = frame_rays(dev, scheme, scene)
    t = mk.mesh_hit_walk(o, d, seed, tables, t_min=EPS)[0]
    inst = mk.instanced_walk_work(o, d, t, tables, t_min=EPS)
    flat = mk.walk_work(o, d, t, tables, t_min=EPS)
    live = ~dead[:n]
    print(f"[fleet] {tables.n_inst} instances: {float((t[:n] < INF)[live].float().mean()):.2%} of "
          f"the frame's live primary rays hit the mesh; {inst['transforms'] / inst['rays']:.3f} "
          f"instances reached a live ray (primary and secondary)", flush=True)
    inst_ops = ((inst["inst_slab"] + sum(inst["slab"])) * SLAB_OPS
                + inst["transforms"] * TRANSFORM_OPS + inst["tri"] * TRI_OPS)
    flat_ops = sum(flat["slab"]) * SLAB_OPS + flat["tri"] * TRI_OPS
    return (inst_ops / inst["rays"], inst), (flat_ops / flat["rays"], flat)


def fleet_parity(dev, card, tables, sky):
    """mesh_trace_instanced and its sky and pcg instantiations against the
    plain version (route instanced) on the whole frame at samples per lane
    1, 4 and MESH_SPP, bitwise; each launch counted under its key alone.
    Returns {record: {plain_ms, max_abs_err, lane_bounces, misses,
    sky_bytes}} of the MESH_SPP launches."""
    import torch

    from raytrace_tpu_torch.ops import mesh_kernel as mk

    fx, fy = (lambda f: (f % MESH_W, f // MESH_W))(
        torch.arange(MESH_W * MESH_H, dtype=torch.int32, device=dev))
    out = {}
    for name, (generator, with_sky) in FLEET_KERNELS.items():
        err = 0.0
        for spl in (1, 4, MESH_SPP):
            samp = torch.full_like(fx, 7)
            kw = dict(route="instanced", assured=5, max_bounces=24, samples_per_lane=spl,
                      generator=generator)
            tables.sky, sky_counts = sky_sectors(sky) if with_sky else (None, lambda: (0, 0))
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            ref, (iters, misses) = mk.mesh_trace_reference(fx, fy, samp, tables,
                                                           return_counts=True, **kw)
            end.record()
            end.synchronize()
            if name == "mesh_trace_instanced" and spl == 1:
                loop_check(fx, fy, samp, tables, kw, ref, start.elapsed_time(end))
            tables.sky = sky if with_sky else None
            reset_launches()
            ours = mk.mesh_trace(fx, fy, samp, tables, **kw)
            torch.cuda.synchronize()
            assert mk.LAUNCHES[name] == 1 == sum(mk.LAUNCHES.values()), f"launches {mk.LAUNCHES}"
            ours, ref = torch.stack(ours), torch.stack(ref)
            bad = (ours != ref).any(0).nonzero()[:, 0]
            err = max(err, float((ours - ref).abs().max()))
            print(f"[fleet] {name} {MESH_W}x{MESH_H} spl={spl}: {bad.numel()} lanes differ from "
                  f"the plain version{' ' + str(bad[:8].tolist()) if bad.numel() else ''}; "
                  f"{int(misses.sum())} of {int(iters.sum())} lane-bounces miss; radiance mean "
                  f"{(ours.mean(1) / spl).tolist()}; plain {start.elapsed_time(end):.1f} ms",
                  flush=True)
            assert bad.numel() == 0, f"{name} spl={spl}: {bad.numel()} lanes differ"
        fetches, sky_bytes = sky_counts()
        assert fetches == (int(misses.sum()) if with_sky else 0)
        out[name] = dict(plain_ms=start.elapsed_time(end), max_abs_err=err,
                         lane_bounces=float(iters.sum()), misses=float(misses.sum()),
                         sky_bytes=sky_bytes)
    tables.sky = None
    return out


def loop_check(xs, ys, samp, tables, kw, batched, batched_ms):
    """The instanced plain version with the table-order loop
    (tests/torch_instanced_loop.py) in the batched mesh_hit_instanced's
    place: its radiance bitwise `batched`'s; prints both ms."""
    import torch

    from raytrace_tpu_torch.ops import mesh_kernel as mk

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from torch_instanced_loop import mesh_hit_instanced_loop

    real, mk.mesh_hit_instanced = mk.mesh_hit_instanced, mesh_hit_instanced_loop
    try:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        ref = torch.stack(mk.mesh_trace_reference(xs, ys, samp, tables, **kw))
        end.record()
        end.synchronize()
    finally:
        mk.mesh_hit_instanced = real
    bad = int((ref != torch.stack(batched)).any(0).sum())
    print(f"[fleet] plain version spl={kw['samples_per_lane']}: the batched mesh_hit_instanced "
          f"against the table-order loop: {bad} lanes differ; {batched_ms:.1f} ms against "
          f"{start.elapsed_time(end):.1f} ms", flush=True)
    assert bad == 0, f"the batched plain version differs from the loop on {bad} lanes"


def trace_turns(label, tables, xs, ys, runs, card):
    """The MESH_SPP launch of xs, ys by each of `runs` ({key: (route,
    generator, sky)}; route "first" the instanced yardstick) in turns,
    forward then back, FLEET_TURNS launches a turn after a warm-up. Returns
    the mean ms a launch of each."""
    import torch

    from raytrace_tpu_torch.ops import mesh_kernel as mk

    zero = torch.zeros_like(xs)
    order = list(runs) + list(reversed(runs))
    t = {}
    for key in order:
        route, generator, with_sky = runs[key]
        tables.sky = with_sky

        def launch():
            kw = dict(assured=5, max_bounces=24, samples_per_lane=MESH_SPP)
            if route == "first":
                return mk._mesh_trace_yardstick(xs, ys, zero, tables, route="instanced", **kw)
            return mk.mesh_trace(xs, ys, zero, tables, route=route, generator=generator, **kw)

        launch()  # warm-up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(FLEET_TURNS):
            launch()
        end.record()
        end.synchronize()
        t.setdefault(key, []).append(start.elapsed_time(end) / FLEET_TURNS)
    tables.sky = None
    ms = {k: sum(v) / len(v) for k, v in t.items()}
    print(f"[timing] {label} {MESH_W}x{MESH_H} spl={MESH_SPP} in turns {order}: "
          + ", ".join(f"{k} {ms[k]:.3f} ms/launch (turns {t[k]})" for k in runs)
          + f"; instanced / walk {ms['mesh_trace_instanced'] / ms['walk']:.3f}, first design / "
          f"walk {ms['mesh_trace_instanced_first'] / ms['walk']:.3f} [{card}]", flush=True)
    return ms


def fleet_timing(dev, card, tables, sky):
    """The fleet's MESH_SPP launch of the whole frame in turns: instanced,
    its first design, walk, the instanced sky and pcg instantiations, and
    back. Returns the mean ms a launch of each."""
    import torch

    fx, fy = (lambda f: (f % MESH_W, f // MESH_W))(
        torch.arange(MESH_W * MESH_H, dtype=torch.int32, device=dev))
    return trace_turns("fleet", tables, fx, fy, {
        "mesh_trace_instanced": ("instanced", "weyl", None),
        "mesh_trace_instanced_first": ("first", "weyl", None), "walk": ("walk", "weyl", None),
        "mesh_trace_instanced_sky": ("instanced", "weyl", sky),
        "mesh_trace_instanced_pcg": ("instanced", "pcg", None)}, card)


def fleet_renders(card, scheme, sky_scheme):
    """Renders of the fleet, each with the launch counts reset just before
    and read just after: render(MESH_SPP) on the default route
    (MeshTables.route), the instanced and walk routes' images under the tile
    gate, a resume, card against CPU, the two routes' render(MESH_SPP) in
    turns (each the median of RENDER_REPS warm renders), and the sky and
    pcg renders. Returns ({record: launches}, render ms of each route)."""
    import numpy as np
    import torch

    from raytrace_tpu_torch.ops import mesh_kernel as mk
    from raytrace_tpu_torch.render.target import RenderTarget

    renders = {}
    r, img, counts, _ = warm_render("fleet", "fleet", scheme, MESH_SPP, card)
    default = mk.ROUTES[r.tables.route]
    assert r.tables.route == ("instanced" if mk.INSTANCED_ROUTE else "walk")
    assert counts[default] > 0 and sum(counts.values()) == counts[default], \
        f"the default ({r.tables.route}) render launched {counts}"
    print(f"[fleet] the default route {r.tables.route} (INSTANCED_ROUTE {mk.INSTANCED_ROUTE}): "
          f"{counts[default]} {default} launches a render({MESH_SPP})", flush=True)
    renders[r.tables.route] = (r, img, counts)
    for route in ("instanced", "walk"):
        if route not in renders:
            renders[route] = warm_render("fleet", f"fleet {route}", scheme, MESH_SPP, card,
                                         route=route)[:3]
    r, img, counts = renders["instanced"]
    launches = {"mesh_trace_instanced": counts["mesh_trace_instanced"]}
    assert launches["mesh_trace_instanced"] > 0 and sum(counts.values()) == \
        launches["mesh_trace_instanced"], f"the instanced render launched {counts}"
    _, walk_img, walk_counts = renders["walk"]
    assert walk_counts["mesh_trace"] > 0 and not walk_counts["mesh_trace_instanced"]
    gate("fleet", f"fleet {MESH_W}x{MESH_H}x{MESH_SPP} instanced vs walk", img, walk_img)
    resume_bitwise("fleet", r, f"fleet {MESH_W}x{MESH_H}")
    card_vs_cpu("fleet", "fleet", scheme, 96, 48, MESH_SPP)

    walls = {}
    for route in ("instanced", "walk", "walk", "instanced"):
        r.tables.route = route
        times = []
        for _ in range(RENDER_REPS):
            r.target = RenderTarget(r.width, r.height)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            r.render(progress=False, samples=MESH_SPP)  # ends in a device -> host copy
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        walls.setdefault(route, []).append(float(np.median(times)))
    render_ms = {k: sum(v) / 2 for k, v in walls.items()}
    paths = MESH_W * MESH_H * MESH_SPP
    print(f"[fleet] render({MESH_SPP}) in turns, each the median of {RENDER_REPS} warm renders: "
          + ", ".join(f"{k} {render_ms[k]:.3f} ms ({paths / render_ms[k] / 1e3:.1f} Mpaths/s; "
                      f"turns {v})" for k, v in walls.items()) + f" [{card}]", flush=True)

    for name, kw, s in (("mesh_trace_instanced_sky", {}, sky_scheme),
                        ("mesh_trace_instanced_pcg", dict(generator="pcg"), scheme)):
        _, _, counts, _ = warm_render("fleet", name, s, MESH_SPP, card, route="instanced", **kw)
        launches[name] = counts[name]
        assert counts[name] > 0 and sum(counts.values()) == counts[name], \
            f"the {name} render launched {counts}"
    return launches, render_ms


def inst_bytes(tables):
    """The bytes an instanced launch reads (the flattened walk tables it
    does not) and writes: the scene rows, the instance table, the mesh's
    attributes and texels, the asset's walk tables and each lane's (x, y,
    sample id) in and radiance out."""
    read = ("sph", "ft", "cam_vec", "inst", "attr", "desc", "pool")
    return (tensor_bytes(getattr(tables, k) for k in read) + tensor_bytes(tables.asset.buffers())
            + MESH_W * MESH_H * (3 * 4 + 3 * 4))


def per_bounce_ops(tables, walk_ops):
    """FP32 instructions of a lane-bounce: spheres, free triangles, the
    mesh shade and a least walk of walk_ops."""
    return (tables.n_sph * SPH_OPS + tables.n_ft * (TRI_OPS - 2) + SHADE_MESH_OPS + walk_ops)


INST_SPILL_MAX = 64  # bytes of spill stores a thread mesh_trace_instanced may take (see below)


def inst_ptxas_check(mesh_log):
    """ptxas' registers, stack, spills and shared memory of every instanced
    kernel of the mesh_kernel build (the four mesh_trace_kernel<kInst>
    instantiations and the first design); raises if an instantiation of
    mesh_trace_instanced runs fewer than 4 blocks of 256 a SM by its
    registers or spills more than INST_SPILL_MAX bytes a thread (its
    4-block build spills 32-40 B around the shade, and ran faster than the
    3-block build without a spill; without the lane stash the 4-block
    build spilled 380 B and ran 1.5x slower: csrc/mesh_kernel.cu's note)."""
    info = inst_ptxas(mesh_log)
    for name, v in info.items():
        print(f"[fleet] ptxas {name}: {v.get('registers')} registers ("
              f"{65536 // (256 * max(v.get('registers', 1), 1))} blocks of 256 a SM by registers), "
              f"{v.get('stack')} B stack, {v.get('spill_stores')} B spill stores, "
              f"{v.get('spill_loads')} B spill loads, {v.get('smem')} B static smem", flush=True)
    redesigned = {k: v for k, v in info.items() if "inst=1" in k}
    assert len(redesigned) == 4 and len(info) == 5, f"instanced kernels {sorted(info)}"
    for name, v in redesigned.items():
        assert v["spill_stores"] <= INST_SPILL_MAX, f"{name} spills {v['spill_stores']} B"
        assert v["registers"] <= 64, f"{name}: {v['registers']} registers, under 4 blocks a SM"


LARGE_STRIP = 288  # the first row of the large fleet's 1216x32 bitwise strip


def large_fleet(dev, card):
    """Phase 13's large fleet (procedural.FLEET_LARGE_ROWS: 144 instances,
    1,051,200 triangles, flattened tables over the 50 MB L2): the build and
    both table sets' bytes; mesh_trace_instanced bitwise against the plain
    version on the 1216x32 strip from row LARGE_STRIP at samples per lane
    1, 4 and MESH_SPP; the whole frame's MESH_SPP launch through the plain
    version (its lane-bounces for the bound) and by mesh_trace_instanced,
    its first design and the walk in turns, the two routes' images under
    the tile gate; the least walk a ray of each route on the frame's rays.
    Returns (ms of each, the plain launch's lane-bounces, instanced ops a
    ray, flattened ops a ray, tables)."""
    import torch

    from raytrace_tpu_torch.models import procedural
    from raytrace_tpu_torch.ops import mesh_kernel as mk

    scheme = fleet_scheme(rows=procedural.FLEET_LARGE_ROWS)
    scene, tables = fleet_build(dev, card, scheme, "large fleet")
    flat = torch.arange(MESH_W * MESH_H, dtype=torch.int32, device=dev)
    fx, fy = flat % MESH_W, flat // MESH_W
    strip = slice(LARGE_STRIP * MESH_W, (LARGE_STRIP + 32) * MESH_W)
    for spl in (1, 4, MESH_SPP):
        kw = dict(route="instanced", assured=5, max_bounces=24, samples_per_lane=spl)
        xs, ys = fx[strip], fy[strip]
        ref = torch.stack(mk.mesh_trace_reference(xs, ys, torch.zeros_like(xs), tables, **kw))
        ours = torch.stack(mk.mesh_trace(xs, ys, torch.zeros_like(xs), tables, **kw))
        bad = int((ours != ref).any(0).sum())
        print(f"[fleet] large fleet {MESH_W}x32 strip (rows {LARGE_STRIP}-{LARGE_STRIP + 31}) "
              f"spl={spl}: {bad} lanes differ from the plain version; radiance mean "
              f"{(ours.mean(1) / spl).tolist()}", flush=True)
        assert bad == 0, f"large fleet strip spl={spl}: {bad} lanes differ"
    zero = torch.zeros_like(fx)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    ref, (iters, _) = mk.mesh_trace_reference(fx, fy, zero, tables, route="instanced", assured=5,
                                              max_bounces=24, samples_per_lane=MESH_SPP,
                                              return_counts=True)
    end.record()
    end.synchronize()
    ms = trace_turns("large fleet", tables, fx, fy, {
        "mesh_trace_instanced": ("instanced", "weyl", None),
        "mesh_trace_instanced_first": ("first", "weyl", None), "walk": ("walk", "weyl", None)},
        card)
    images = {route: torch.stack(mk.mesh_trace(fx, fy, zero, tables, route=route, assured=5,
                                               max_bounces=24, samples_per_lane=MESH_SPP))
              for route in ("instanced", "walk")}
    bad = int((images["instanced"] != torch.stack(ref)).any(0).sum())
    print(f"[fleet] large fleet {MESH_W}x{MESH_H} spl={MESH_SPP}: {bad} lanes of the instanced "
          f"launch differ from the plain version (plain {start.elapsed_time(end):.1f} ms, "
          f"{int(iters.sum())} lane-bounces)", flush=True)
    assert bad == 0, f"large fleet: {bad} lanes differ"
    img = {k: (v / MESH_SPP).T.reshape(MESH_H, MESH_W, 3).cpu().numpy() for k, v in images.items()}
    gate("fleet", f"large fleet {MESH_W}x{MESH_H}x{MESH_SPP} instanced vs walk", img["instanced"],
         img["walk"])
    (inst_ops, inst_work), (flat_ops, flat_work) = fleet_ops(dev, scheme, scene, tables)
    print(f"[bound] large fleet least walks a ray: instanced {inst_ops:.1f} FP32 instructions "
          f"({inst_work}), flattened {flat_ops:.1f} ({flat_work})", flush=True)
    return ms, float(iters.sum()), inst_ops, flat_ops, tables


def fleet_phase(dev, card, mesh_log):
    """Phase 13: two-level instancing on the fleet and the large fleet
    (module docstring); mesh_log: the mesh_kernel build's log. Returns the
    JSON records of mesh_trace_instanced and its sky and pcg
    instantiations."""
    from raytrace_tpu_torch.ops import mesh_kernel as mk

    t_phase = time.perf_counter()
    inst_ptxas_check(mesh_log)
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_fleet_") as face_dir:
        scheme, sky_scheme = fleet_scheme(), fleet_scheme(face_dir)
        scene, tables = fleet_build(dev, card, scheme, "fleet")
        _, sky_tables = fleet_build(dev, card, sky_scheme, "fleet + sky")
        sky = sky_tables.sky
        parity = fleet_parity(dev, card, tables, sky)
        ms = fleet_timing(dev, card, tables, sky)
        (inst_ops, inst_work), (flat_ops, flat_work) = fleet_ops(dev, scheme, scene, tables)
        launches, render_ms = fleet_renders(card, scheme, sky_scheme)
    del sky_tables, sky
    print(f"[bound] fleet least walks a ray (frame rays, gpu semantics): instanced {inst_ops:.1f} "
          f"FP32 instructions ({inst_work}: live rays, instance boxes, transforms, local slab "
          f"tests a level, triangle tests), flattened {flat_ops:.1f} ({flat_work})", flush=True)
    nbytes = inst_bytes(tables)
    per_bounce = per_bounce_ops(tables, inst_ops)
    records = []
    for name, p in parity.items():
        ops = p["lane_bounces"] * per_bounce + p["misses"] * (SKY_INSTR if FLEET_KERNELS[name][1]
                                                              else 0)
        b_ms, b_by = bound(ops, nbytes + p["sky_bytes"], "mesh_trace")
        rec = {"name": name, "route": "cuda", "source": "raytrace_tpu_torch/csrc/mesh_kernel.cu",
               "replaces": FLEET_REPLACES, "launches": launches[name],
               "max_abs_err": p["max_abs_err"], "ms": ms[name], "plain_ms": p["plain_ms"],
               "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
               "launches_per_render": launches[name]}
        if name == "mesh_trace_instanced":
            first = ms["mesh_trace_instanced_first"]
            rec.update(walk_ms=ms["walk"], yardstick_ms=first, yardstick_share=b_ms / first,
                       render_ms=render_ms["instanced"], walk_render_ms=render_ms["walk"],
                       default_route=tables.route)
            print(f"[bound] mesh_trace_instanced_first (the yardstick): kernel {first:.4f} ms "
                  f"({b_ms / first:.2%} of the {b_ms:.4f} ms bound); the walk {ms['walk']:.4f} ms "
                  f"[{card}]", flush=True)
        records.append(rec)
        fetches = f" + {p['misses']:.4g} sky fetches" if FLEET_KERNELS[name][1] else ""
        print(f"[bound] {name}: {p['lane_bounces']:.4g} lane-bounces x {per_bounce:.1f} FP32 "
              f"instructions{fetches} ({ops / FP32_SINGLE * 1e3:.4f} ms at 33.5 T/s), "
              f"{nbytes + p['sky_bytes']:.4g} bytes: "
              f"bound {b_ms:.4f} ms by {b_by}; kernel {ms[name]:.4f} ms ({b_ms / ms[name]:.2%} of "
              f"the bound reached); plain {p['plain_ms']:.1f} ms [{card}]", flush=True)
    del tables
    t_large = time.perf_counter()
    lms, lane_bounces, l_inst_ops, l_flat_ops, ltables = large_fleet(dev, card)
    l_bound, l_by = bound(lane_bounces * per_bounce_ops(ltables, l_inst_ops), inst_bytes(ltables),
                          "mesh_trace")
    for key in ("mesh_trace_instanced", "mesh_trace_instanced_first"):
        print(f"[bound] large fleet {key}: {lane_bounces:.4g} lane-bounces: bound {l_bound:.4f} ms "
              f"by {l_by}; kernel {lms[key]:.4f} ms ({l_bound / lms[key]:.2%} of the bound "
              f"reached); the walk {lms['walk']:.4f} ms [{card}]", flush=True)
    records[0].update(large_ms=lms["mesh_trace_instanced"], large_walk_ms=lms["walk"],
                      large_yardstick_ms=lms["mesh_trace_instanced_first"],
                      large_bound_ms=l_bound, large_default_route=ltables.route)
    print(f"[fleet] large fleet in {time.perf_counter() - t_large:.1f} s", flush=True)
    print(f"[fleet] MeshTables.route: fleet {records[0]['default_route']}, large fleet "
          f"{ltables.route} (INSTANCED_ROUTE {mk.INSTANCED_ROUTE}); measured a launch: fleet "
          f"instanced {ms['mesh_trace_instanced']:.3f}, first design "
          f"{ms['mesh_trace_instanced_first']:.3f}, walk {ms['walk']:.3f} ms; large fleet "
          f"instanced {lms['mesh_trace_instanced']:.3f}, first design "
          f"{lms['mesh_trace_instanced_first']:.3f}, walk {lms['walk']:.3f} ms [{card}]",
          flush=True)
    print(f"[fleet] phase 13 in {time.perf_counter() - t_phase:.1f} s", flush=True)
    return records


PROFILE_CHILD = "--profile"  # the argument of the child that profiles warm renders


def profile_child(what, card) -> int:
    """Profiler tables in a process of its own: "walled", phase 4's warm
    walled 1200x600 render(64); "sky", phase 9's warm outdoor + sky
    render(64) and a380-class + sky render(16) (the faces written anew);
    "diff", phase 10's differentiable a380-class render (profile_diff);
    "fleet", phase 13's warm fleet render(16) on its default route.
    Prints {label: profile's result} as the last line."""
    from raytrace_tpu_torch.models import procedural
    from raytrace_tpu_torch.models.walled import walled_scheme
    from raytrace_tpu_torch.render.renderer import Renderer

    if what == "diff":
        print(json.dumps({"a380-class differentiable": profile_diff(card)}), flush=True)
        return 0
    if what == "fleet":
        renderer = Renderer(fleet_scheme(), device="cuda")
        renderer.render(progress=False, samples=1)  # loads the kernel (the parent's build)
        print(json.dumps({"fleet": profile(renderer, card, "mesh_trace_kernel",
                                           f"fleet {renderer.tables.route} {MESH_W}x{MESH_H}")}),
              flush=True)
        return 0
    results = {}
    with tempfile.TemporaryDirectory(dir=ROOT, prefix=".chip_smoke_sky_") as face_dir:
        if what == "walled":
            runs = [("walled", walled_scheme(W, H), "trace_tiles_kernel", MAIN_SPP)]
        else:
            sky = procedural.sky_cubemap(face_dir)
            a380 = procedural.a380_scheme(MESH_W, MESH_H, MESH_SPP)
            a380.scene_members.append(sky)
            runs = [("outdoor + sky", procedural.outdoor_scheme(sky, W, H, MAIN_SPP),
                     "trace_tiles_kernel", MAIN_SPP),
                    ("a380-class + sky", a380, "mesh_trace_kernel", MESH_SPP)]
        for label, scheme, kernel, spp in runs:
            renderer = Renderer(scheme, device="cuda")
            renderer.render(progress=False, samples=1)  # loads the kernel (the parent's build)
            results[label] = profile(renderer, card, kernel,
                                     f"{label} {renderer.width}x{renderer.height}", spp=spp)
    print(json.dumps(results), flush=True)
    return 0


def profile_in_child(what, card):
    """profile_child(what)'s tables, taken by a child process: in this
    process a profiler session after the others lost records of the
    kernels launched through ctypes (they recorded no device time).
    Returns its {label: result or None}."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__), PROFILE_CHILD, what, card],
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
        return profile_child(sys.argv[2], sys.argv[3])
    if sys.argv[1:2] == [DIST_CHILD]:
        return dist_child(*sys.argv[2:5])
    import numpy as np

    from raytrace_tpu_torch.kernels import build
    from raytrace_tpu_torch.models.walled import walled_scheme
    from raytrace_tpu_torch.ops import trace_kernel as tk
    from raytrace_tpu_torch.render.renderer import Renderer
    from raytrace_tpu_torch.render.target import RenderTarget

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
    counts = sass(dict(zip(names, builds))) or {}  # every entry's SASS, for reading
    mesh_regs = ptxas_registers(builds[1].log)
    from torch_mesh_sass import label as mesh_label

    for fn, n in counts.get("mesh_kernel", {}).items():
        print(f"[sass] {mesh_label(fn)}: {n} instructions, {mesh_regs.get(fn, '?')} registers",
              flush=True)
    regs = ptxas_registers(builds[0].log)
    for fn, n in counts.get("trace_kernel", {}).items():
        for mangled, label in TILES_INSTANTIATIONS.items():
            if mangled in fn:
                print(f"[sass] trace_tiles_kernel<{label}>: {n} instructions, "
                      f"{regs.get(fn, '?')} registers (weyl without the sky: 2,120 at 64 "
                      f"before the generator template)", flush=True)

    # ---- 3. kernel vs plain on the card ----
    trace = trace_phase(dev, card)

    # ---- 4. the main path ----
    scheme = walled_scheme(W, H)
    renderer = Renderer(scheme, device="cuda")
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    img = renderer.render(progress=False, samples=MAIN_SPP)  # ends in a device -> host copy
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = tk.LAUNCHES["trace_tiles"]
    print(f"[main] Renderer(walled {W}x{H}, cuda).render({MAIN_SPP}): {dt:.4f} s, "
          f"{W * H * MAIN_SPP / dt:.1f} paths/s, kernel launches {launches} [{card}]", flush=True)
    assert launches > 0, "the main path did not launch the CUDA kernel"
    assert img.shape == (H, W, 3) and np.isfinite(img).all(), "bad image"
    print(f"[main] image mean per channel {img.mean(axis=(0, 1)).tolist()}", flush=True)

    # the same frame at a small size: card vs the plain version on the CPU
    card_vs_cpu("main", "walled", scheme, 128, 64, 16)
    resume_bitwise("main", renderer, f"walled {W}x{H}")

    # the same render with the yardstick in trace_tiles' place, in turns
    def render_ms(fn):
        """The median wall time of RENDER_REPS warm renders, each into a
        fresh target: one render's host side (the pageable copy) varies by
        several ms, more than the kernels differ."""
        real, tk.trace_tiles = tk.trace_tiles, fn
        try:
            r = Renderer(scheme, device="cuda")
            r.render(progress=False, samples=1)
            times = []
            for _ in range(RENDER_REPS):
                r.target = RenderTarget(W, H)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r.render(progress=False, samples=MAIN_SPP)  # ends in a device -> host copy
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            return float(np.median(times))
        finally:
            tk.trace_tiles = real

    def yardstick(*args, sky=None, generator="weyl", **kw):
        """The yardstick in trace_tiles' place: the render passes sky=None
        and generator="weyl", which the yardstick (weyl, without a cube
        map) does not take; anything else it refuses."""
        if sky is not None or generator != "weyl":
            raise ValueError("the yardstick takes neither a cube map nor pcg")
        return tk._trace_tiles_per_thread(*args, **kw)

    walls = {}
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
    walled_profile = profile_in_child("walled", card)["walled"]
    if walled_profile:
        kernels[0]["in_render_ms"] = walled_profile["ms"]
    sky = sky_phase(dev, card)
    sky_profiles = profile_in_child("sky", card)
    for rec, label in ((kernels[0], "outdoor + sky"), (kernels[1], "a380-class + sky")):
        if sky_profiles[label]:
            rec["sky_in_render_ms"] = sky_profiles[label]["ms"]

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
            terms = tiles_terms(work, s["n_sph"], s["n_ft"], lanes * spl)
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

    sky_bounds(kernels, sky, shape, walk_ops, card)
    diff = diff_phase(dev, card)
    diff_profile = profile_in_child("diff", card)["a380-class differentiable"]
    hit_record["diff_launches_per_render"] = diff["a380"]["launches"]
    hit_record["diff_in_render_ms"] = diff_profile["ms"] if diff_profile else None
    kernels.append(hit_record)

    # ---- 11. pcg on every path, animation, the host remainder ----
    pcg = pcg_phase(dev, card)
    for rec in kernels:
        if rec["name"] in pcg:
            rec.update(pcg_ms=pcg[rec["name"]]["ms"], pcg_weyl_ms=pcg[rec["name"]]["weyl_ms"],
                       pcg_max_abs_err=pcg[rec["name"]]["max_abs_err"],
                       pcg_launches=pcg["launches"][f"{rec['name']}_pcg"])
    anim_phase(dev, card)
    host_phase(dev, card)

    # ---- 12. parallel/ under torch.distributed ----
    dist = dist_phase(card)
    for rec in kernels:
        label, key = {"trace_tiles": ("walled", "trace_tiles"),
                      "mesh_trace": ("a380-class", "mesh_trace"),
                      "mesh_hit": ("a380-class cpu", "mesh_hit")}.get(rec["name"], (None, None))
        if label:
            rec.update(dist_launches_per_rank=dist[label][key], dist_backend="gloo")
    kernels[0]["nccl_launches"] = dist["nccl"]["trace_tiles"]

    # ---- 13. two-level instancing: the fleet ----
    fleet = fleet_phase(dev, card, builds[1].log)
    fleet_profile = profile_in_child("fleet", card)["fleet"]
    if fleet_profile:
        fleet[0]["in_render_ms"] = fleet_profile["ms"]
    kernels += fleet
    for rec in kernels:
        rec["share"] = rec["bound_ms"] / rec["ms"]  # of the bound reached
    print(f"[done] all phases in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
