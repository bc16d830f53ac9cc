#!/usr/bin/env python3
"""Threads per ray and occupancy of the port's two fused mesh entries, measured on the card.

    python3 scripts/torch_mesh_trace_groups.py

`raytrace_tpu_torch/csrc/mesh_kernel.cu` keeps one group size for each:
`kTraceGroup` (the group walk of `mesh_trace`) and `kBruteGroup` (the
cooperative scan of `mesh_trace_brute`). This script builds copies of the
source with both set to 8, 16 and 32 (`torch_mesh_hit_groups.build_variant`,
all at once), and copies with the other occupancy that each entry could
take (OCCUPANCY: 3 blocks of 256 threads a SM for `mesh_trace`, at 80
registers, against the committed 4 at 64; blocks of 512 threads for
`mesh_trace_brute` against the committed 1,024). It prints ptxas's
registers and spills for each, holds each copy's output bitwise against
the committed kernel's at the main path's launch (the whole 1216x608
frame at 16 samples per lane: the a380-class surface on the walk, the
2,097-triangle surface on the brute route), and times them with CUDA
events: the group sizes in turns 8, 16, 32, 32, 16, 8, each occupancy copy
in turns committed, copy, copy, committed; with the card's name and power
limit. chip_smoke.py runs the group sweep. Needs a CUDA card and nvcc;
prints no result without them.
"""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = (8, 16, 32)
OCCUPANCY = {  # copy -> (its constants, the case it runs)
    "kTraceBlocks=3": ({"kTraceBlocks": 3}, "a380-class"),
    "kBruteThreads=512": ({"kBruteThreads": 512}, "surface-2097"),
}
REPS = 2  # launches per turn, after a warm-up


def build_variant(g):
    """mesh_kernel.cu with both entries' group size set to g."""
    from torch_mesh_hit_groups import build_variant as build_copy

    return build_copy({"kTraceGroup": g, "kBruteGroup": g}, f"trace_g{g}")


def print_ptxas(variants):
    """ptxas's lines of each build ({G or name: Built})."""
    for key, built in variants.items():
        tag = f"G={key}" if isinstance(key, int) else key
        for line in built.log.splitlines():
            if "ptxas" in line and any(k in line for k in ("registers", "spill", "Compiling")):
                print(f"[build] {tag} {line.strip()}", flush=True)


def _launcher(variants):
    """launch(key, tables, xs, ys, route): one launch at 16 samples per lane
    through the build `variants[key]` (None: the committed kernel)."""
    import torch

    from raytrace_tpu_torch.kernels import build
    from raytrace_tpu_torch.ops import mesh_kernel as mk

    loaded = build._LOADED["mesh_kernel"]

    def launch(key, tables, xs, ys, route):
        build._LOADED["mesh_kernel"] = loaded if key is None else variants[key]
        try:
            return mk.mesh_trace(xs, ys, torch.zeros_like(xs), tables, route=route, assured=5,
                                 max_bounces=24, samples_per_lane=16)
        finally:
            build._LOADED["mesh_kernel"] = loaded

    return launch


def _turns(launch, keys, case):
    """Mean ms per launch of each build of `keys`, timed in the given turns."""
    import torch

    t = {}
    for key in keys:
        launch(key, *case)  # warm-up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            launch(key, *case)
        end.record()
        end.synchronize()
        t.setdefault(key, []).append(start.elapsed_time(end) / REPS)
    return {k: sum(v) / len(v) for k, v in t.items()}


def _same(launch, key, case, label):
    """Lanes on which build `key` differs from the committed kernel; none may."""
    import torch

    ref = torch.stack(launch(None, *case))
    diff = int((torch.stack(launch(key, *case)) != ref).any(0).sum())
    print(f"[groups] {label}: {diff} lanes differ from the committed kernel", flush=True)
    assert diff == 0, f"{label}: {diff} lanes differ"


def sweep(card, cases, variants):
    """cases: {label: (tables, xs, ys, route)}, each launched at 16 samples
    per lane; variants: {G: Built}. Each variant's radiance must equal the
    committed kernel's bitwise; then the variants are timed in turns.
    Returns {label: {G: mean ms per launch}}."""
    from raytrace_tpu_torch.ops import mesh_kernel as mk

    launch = _launcher(variants)
    result = {}
    for label, case in cases.items():
        for g in GROUPS:
            _same(launch, g, case, f"{label} {mk.ROUTES[case[3]]} G={g}")
        result[label] = _turns(launch, GROUPS + GROUPS[::-1], case)
        print(f"[groups] {label} {mk.ROUTES[case[3]]} {case[1].numel()} lanes spl=16, turns 8 16 "
              f"32 32 16 8: " + ", ".join(f"G={g} {ms:.3f} ms" for g, ms in result[label].items())
              + f" per launch [{card}]", flush=True)
    return result


def occupancy_sweep(card, cases, variants):
    """Each OCCUPANCY copy (variants: {name: Built}) on its case, bitwise
    against the committed kernel, then in turns committed, copy, copy,
    committed."""
    from raytrace_tpu_torch.ops import mesh_kernel as mk

    launch = _launcher(variants)
    for name, (_, label) in OCCUPANCY.items():
        case = cases[label]
        _same(launch, name, case, f"{label} {mk.ROUTES[case[3]]} {name}")
        ms = _turns(launch, (None, name, name, None), case)
        print(f"[occupancy] {label} {mk.ROUTES[case[3]]} spl=16: committed {ms[None]:.3f} ms, "
              f"{name} {ms[name]:.3f} ms per launch [{card}]", flush=True)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_mesh_trace_groups: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import chip_smoke as cs
    from raytrace_tpu_torch.kernels import build
    from raytrace_tpu_torch.models import procedural
    from raytrace_tpu_torch.models.camera import build_camera
    from raytrace_tpu_torch.models.config import ModelMember
    from raytrace_tpu_torch.models.scene import build_scene
    from raytrace_tpu_torch.ops import mesh_kernel as mk
    from torch_mesh_hit_groups import build_variant as build_copy

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    with ThreadPoolExecutor(len(GROUPS) + len(OCCUPANCY) + 1) as pool:
        committed = pool.submit(build.build, "mesh_kernel")
        groups = pool.map(build_variant, GROUPS)
        occupancy = pool.map(lambda kv: build_copy(kv[1][0], kv[0].replace("=", "")),
                             OCCUPANCY.items())
        variants = dict(zip(GROUPS, groups))
        copies = dict(zip(OCCUPANCY, occupancy))
        committed.result()
    print_ptxas({**variants, **copies})

    surface = procedural.a380_cam_scheme(cs.MESH_W, cs.MESH_H, cs.MESH_SPP)
    surface.scene_members.append(ModelMember(
        path="<2,097-triangle surface>", loaded=[procedural.make_mesh(2097, n_textures=0)]))
    flat = torch.arange(cs.MESH_W * cs.MESH_H, dtype=torch.int32, device=dev)
    xs, ys = flat % cs.MESH_W, flat // cs.MESH_W
    cases = {}
    for label, scheme, route in (("a380-class", procedural.a380_scheme(cs.MESH_W, cs.MESH_H),
                                  "walk"), ("surface-2097", surface, "brute")):
        cam = build_camera(scheme.cam, cs.MESH_W, cs.MESH_H)
        tables = mk.MeshTables(build_scene(scheme), cam,
                               scheme.render_info.rad_info.russ_roull_info.max_thres).to(dev)
        cases[label] = (tables, xs, ys, route)
    sweep(card, cases, variants)
    occupancy_sweep(card, cases, copies)
    return 0


if __name__ == "__main__":
    sys.exit(main())
