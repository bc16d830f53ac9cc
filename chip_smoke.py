#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU (H100).

    python3 chip_smoke.py

Drives raytrace_tpu_torch's main paths on the card and checks them:

1. environment: the card's name and power limit, CUDA and nvcc versions;
2. build: compiles csrc/trace_kernel.cu and csrc/mesh_kernel.cu with nvcc
   for sm_90a, both at once (timed), and prints ptxas's registers /
   shared memory / spills;
3. kernel vs plain, both on the card: `trace_tiles` (the CUDA kernel)
   against `trace_tiles_reference` (plain torch) on the walled scene at
   1200x600 (samples per lane 1: all 9 outputs; 4: radiance) and on a
   mixed sphere / free-triangle / dielectric / emissive scene at 64x32
   (1 and 4), under the lane-fraction gate: under 1% of lanes may have
   |a - b| / (|b| + 1e-3) > 1e-3; then both timed with CUDA events at
   the main path's launch shape, in turns plain, kernel, kernel, plain;
4. walled main path: Renderer(walled 1200x600, device="cuda").render(64
   spp) with the kernel's launch count reset just before and read just
   after; the image must be finite and agree with the CPU render of a
   small frame (scripts/hw_parity.py's tile gate), and a checkpoint
   resume must be bitwise exact on the card. Prints paths/s with the
   card's name and power limit;
5. mesh kernel vs plain, both on the card, same gate: `mesh_trace` (the
   walk) against `mesh_trace_reference` on the whole 1216x608 frame of
   the a380-class textured surface (127,749 triangles, 20 u8 1024x1024
   textures) at samples per lane 1, 4 and 16 (the main path's launch);
   `mesh_trace_brute` on the whole frame of the 2,097-triangle surface
   at the same camera, likewise; both routes on a 64x32 scene of
   textured, normal-mapped octahedra with an emissive sphere, a
   dielectric sphere and a DiffSpec triangle. Each kernel is timed at
   the main path's launch beside its plain version, both versions on a
   strided subset of 33,606 pixels in turns, and the host set-up
   (build_scene, MeshTables) on the host clock;
6. mesh main paths: Renderer(a380-class 1216x608, "cuda").render(16) (the
   walk) and Renderer(2,097-triangle surface, "cuda").render(16) (the
   brute route), each with the launch counts reset just before and read
   just after; finite images, paths/s with the card's name and power
   limit, a small frame of the a380-class scene on the card against the
   CPU under the tile gate, and a bitwise exact resume on the card.

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
MESH_KERNELS = {  # entry point -> (route, the TPU kernel it replaces)
    "mesh_trace": ("walk", "raytrace_tpu/ops/pallas/mesh_bounce_kernel.py:698"),
    "mesh_trace_brute": ("brute", "raytrace_tpu/ops/pallas/woop.py:268"),
}


def resized(scheme, width, height):
    """The scheme at another frame size, sharing its (large) members."""
    s = copy.copy(scheme)
    s.render_info = copy.copy(scheme.render_info)
    s.render_info.width, s.render_info.height = width, height
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


def mesh_phases(dev, card):
    """Phases 5 and 6; returns the mesh kernels' JSON records."""
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

    def parity(label, name, tables, xs, ys, spl, route, assured):
        """Kernel vs plain on the same lanes; returns the plain version's ms."""
        ours, k_ms = timed_run(mk.mesh_trace, tables, xs, ys, 7, spl, route, assured)
        ref, p_ms = timed_run(mk.mesh_trace_reference, tables, xs, ys, 7, spl, route, assured)
        for k in range(3):
            bad, e = lane_gate(ours[k], ref[k])
            err[name] = max(err[name], e)
            print(f"[parity] {label} {name} {xs.numel()} lanes spl={spl} channel {k}: "
                  f"bad-lane fraction {bad:.6f} max|d| {e:.3e}", flush=True)
            assert bad < 0.01, f"{label} {name} spl={spl}: {bad:.4f} of lanes differ"
        print(f"[parity] {label} {name} {xs.numel()} lanes spl={spl}: radiance mean "
              f"{[round(float(o.mean()) / spl, 6) for o in ours]}; kernel {k_ms:.3f} ms, "
              f"plain {p_ms:.3f} ms (one launch each) [{card}]", flush=True)
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

    # ---- 5. kernel vs plain on the card ----
    # the whole 1216x608 frame of each route at the main path's launch
    # shape (spl MESH_SPP) and at spl 1 and 4; the mixed octahedra on both
    err = {name: 0.0 for name in MESH_KERNELS}
    ms, plain_ms = {}, {}
    fx, fy = lanes(MESH_W, MESH_H, 1)
    for label, scheme, name in (("a380-class", a380, "mesh_trace"),
                                ("surface-2097", surface, "mesh_trace_brute")):
        scene, tables = setup(label, scheme)
        route = MESH_KERNELS[name][0]
        assert tables.route == route, f"{label} takes the {tables.route} route, not {route}"
        print(f"[parity] {label}: {scene.n_mesh_tris} triangles, {scene.n_clusters} clusters, "
              f"pool {scene.tex_pool.dtype} x {scene.tex_pool.size}, route {route}", flush=True)
        for spl in (1, 4, MESH_SPP):
            plain_ms[name] = parity(label, name, tables, fx, fy, spl, route, 5)
        # the main path's launch: the kernel timed over warm repetitions
        # beside the plain version's launch above
        ms[name] = timed(mk.mesh_trace, tables, fx, fy, MESH_SPP, route, 3)
        print(f"[timing] {name} {label} {MESH_W}x{MESH_H} spl={MESH_SPP}: kernel {ms[name]:.3f} "
              f"ms/launch ({MESH_W * MESH_H * MESH_SPP / ms[name] / 1e3:.1f} Mpaths/s), plain "
              f"{plain_ms[name]:.3f} ms/launch [{card}]", flush=True)
        # both versions on a strided subset, in turns plain, kernel, kernel, plain
        xs, ys = lanes(MESH_W, MESH_H, SUBSET_STRIDE)
        t = {"plain": [], "kernel": []}
        for kind, fn, reps in (("plain", mk.mesh_trace_reference, 1), ("kernel", mk.mesh_trace, 5),
                               ("kernel", mk.mesh_trace, 5),
                               ("plain", mk.mesh_trace_reference, 1)):
            t[kind].append(timed(fn, tables, xs, ys, 1, route, reps))
            print(f"[timing] {kind} {name} {label} subset of {xs.numel()} lanes spl=1: "
                  f"{t[kind][-1]:.3f} ms/launch [{card}]", flush=True)
        if route == "brute":  # the brute scene's frame on the walk: what the gate costs
            walk = timed(mk.mesh_trace, tables, fx, fy, MESH_SPP, "walk", 2)
            print(f"[timing] kernel mesh_trace (walk) {label} {MESH_W}x{MESH_H} spl={MESH_SPP}: "
                  f"{walk:.3f} ms/launch ({MESH_W * MESH_H * MESH_SPP / walk / 1e3:.1f} "
                  f"Mpaths/s) [{card}]", flush=True)
        del tables

    _, tables = setup("octahedra", octa_scheme(64, 32))
    xs, ys = lanes(64, 32, 1)
    for route, name in (("walk", "mesh_trace"), ("brute", "mesh_trace_brute")):
        for spl in (1, 4):
            parity("octahedra", name, tables, xs, ys, spl, route, 3)
    del tables

    # ---- 6. the mesh main paths ----
    launches = {}
    for label, scheme, name in (("a380-class", a380, "mesh_trace"),
                                ("surface-2097", surface, "mesh_trace_brute")):
        t0 = time.perf_counter()
        renderer = Renderer(scheme, device="cuda")
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

    small = resized(a380, 96, 48)
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

    return [{"name": name, "route": "cuda", "source": "raytrace_tpu_torch/csrc/mesh_kernel.cu",
             "replaces": replaces, "launches": launches[name], "max_abs_err": err[name],
             "ms": ms[name], "plain_ms": plain_ms[name]}
            for name, (_, replaces) in MESH_KERNELS.items()]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA device",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import numpy as np

    from raytrace_tpu_torch.kernels import build
    from raytrace_tpu_torch.models.camera import build_camera
    from raytrace_tpu_torch.models.scene import build_scene
    from raytrace_tpu_torch.models.walled import walled_scheme
    from raytrace_tpu_torch.ops import trace_kernel as tk
    from raytrace_tpu_torch.render.renderer import Renderer
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

    # ---- 2. build: one nvcc per source, started together ----
    t0 = time.perf_counter()
    names = ("trace_kernel", "mesh_kernel")
    with ThreadPoolExecutor(len(names)) as pool:
        builds = list(pool.map(build.build, names))
    print(f"[build] {len(names)} kernels in {time.perf_counter() - t0:.2f} s", flush=True)
    for built in builds:
        print(f"[build] {built.path.name}: nvcc {built.seconds:.2f} s", flush=True)
        for line in built.log.splitlines():
            if "ptxas" in line and any(k in line for k in ("registers", "spill", "smem",
                                                            "Compiling")):
                print(f"[build] {line.strip()}", flush=True)

    # ---- 3. kernel vs plain on the card ----
    def setup(scheme, width, height):
        scene = build_scene(scheme)
        tables = tk.SceneTables(scene, build_camera(scheme.cam, width, height),
                                scheme.render_info.rad_info.russ_roull_info.max_thres).to(dev)
        flat = torch.arange(width * height, dtype=torch.int32, device=dev)
        return tables, flat % width, flat // width

    def run(fn, tables, xs, ys, samp, assured, spl):
        return fn(xs, ys, samp, tables.sph, tables.ft, tables.cam_vec,
                  n_sph=tables.n_sph, n_ft=tables.n_ft, has_lens=tables.has_lens,
                  assured=assured, max_bounces=24, samples_per_lane=spl)

    max_err = 0.0
    cases = [("walled", walled_scheme(W, H), W, H, 5, 1), ("walled", walled_scheme(W, H), W, H, 5, 4),
             ("mixed", mixed_scheme(64, 32), 64, 32, 2, 1), ("mixed", mixed_scheme(64, 32), 64, 32, 2, 4)]
    for name, scheme, w, h, assured, spl in cases:
        tables, xs, ys = setup(scheme, w, h)
        samp = torch.full_like(xs, 7)
        ours = run(tk.trace_tiles, tables, xs, ys, samp, assured, spl)
        torch.cuda.synchronize()
        ref = run(tk.trace_tiles_reference, tables, xs, ys, samp, assured, spl)
        torch.cuda.synchronize()
        n_out = 9 if spl == 1 else 3  # miss records mean something only at spl == 1
        for k in range(n_out):
            bad, err = lane_gate(ours[k], ref[k])
            max_err = max(max_err, err)
            print(f"[parity] {name} {w}x{h} spl={spl} out{k}: bad-lane fraction {bad:.6f} "
                  f"max|d| {err:.3e}", flush=True)
            assert bad < 0.01, f"{name} spl={spl} output {k}: {bad:.4f} of lanes differ"
        print(f"[parity] {name} {w}x{h} spl={spl}: radiance mean "
              f"{[round(float(o.mean()) / spl, 5) for o in ours[:3]]}", flush=True)

    tables, xs, ys = setup(walled_scheme(W, H), W, H)
    samp = torch.zeros_like(xs)

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

    order = [("plain", tk.trace_tiles_reference, 1), ("kernel", tk.trace_tiles, 5),
             ("kernel", tk.trace_tiles, 5), ("plain", tk.trace_tiles_reference, 1)]
    times = {"plain": [], "kernel": []}
    for label, fn, reps in order:
        ms = timed(fn, reps)
        times[label].append(ms)
        print(f"[timing] {label} walled {W}x{H} spl={TIMING_SPL}: {ms:.3f} ms/launch "
              f"({W * H * TIMING_SPL / ms / 1e6:.3f} Gpaths/s) [{card}]", flush=True)
    kernel_ms = sum(times["kernel"]) / 2
    plain_ms = sum(times["plain"]) / 2

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

    kernels = [{
        "name": "trace_tiles",
        "route": "cuda",
        "source": "raytrace_tpu_torch/csrc/trace_kernel.cu",
        "replaces": "raytrace_tpu/ops/pallas/trace_kernel.py:722",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
    }]
    kernels += mesh_phases(dev, card)
    print(f"[done] all phases in {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
