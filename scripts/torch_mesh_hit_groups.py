#!/usr/bin/env python3
"""Threads per ray of the port's `mesh_hit` CUDA entry, measured on the card.

    python3 scripts/torch_mesh_hit_groups.py

`raytrace_tpu_torch/csrc/mesh_kernel.cu` keeps one group size,
`kRayGroup`. This script builds copies of the source with 8, 16 and 32
threads per ray into `raytrace_tpu_torch/_build/groups/` (nvcc with the
package's flags, all at once), prints ptxas's registers and spills for
each, holds each against `mesh_hit_walk` on chip_smoke.py's two pools (a
131,072-ray pool cut from the a380-class frame's primary and secondary
rays, and the in-render pool of the cpu-semantics render(16)'s 20th
mesh_hit launch), and times them with CUDA events in turns per-thread, 8,
16, 32, 32, 16, 8, per-thread, with the card's name and power limit.
Needs a CUDA card and nvcc; prints no result without them.
"""
import ctypes
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUPS = (8, 16, 32)
GROUP_LINE = re.compile(r"constexpr int kRayGroup = \d+;")


def build_variant(g):
    """mesh_kernel.cu with kRayGroup = g, built like kernels/build.py."""
    from raytrace_tpu_torch.kernels import build

    src = (build.CSRC / "mesh_kernel.cu").read_text()
    if len(GROUP_LINE.findall(src)) != 1:
        raise RuntimeError("mesh_kernel.cu does not define kRayGroup once")
    out = build.BUILD_DIR / "groups"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / f"mesh_kernel_g{g}.cu", out / f"mesh_kernel_g{g}.so"
    cu.write_text(GROUP_LINE.sub(f"constexpr int kRayGroup = {g};", src))
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *build.EXTRA_FLAGS["mesh_kernel"],
           "-I", str(build.CSRC), "-o", str(so), str(cu)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building G={g}:\n{proc.stdout}{proc.stderr}")
    return build.Built(path=so, log=proc.stdout + proc.stderr, seconds=time.perf_counter() - t0,
                       lib=ctypes.CDLL(str(so)))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_mesh_hit_groups: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from raytrace_tpu_torch.kernels import build
    from raytrace_tpu_torch.models import procedural
    from raytrace_tpu_torch.ops import mesh_kernel as mk
    from raytrace_tpu_torch.render.integrator import CPU_GUARD

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    with ThreadPoolExecutor(len(GROUPS) + 1) as pool:
        committed = pool.submit(build.build, "mesh_kernel")
        variants = dict(zip(GROUPS, pool.map(build_variant, GROUPS)))
        committed.result()
    for g, built in variants.items():
        for line in built.log.splitlines():
            if "ptxas" in line and ("registers" in line or "spill" in line):
                print(f"[build] G={g} {line.strip()}", flush=True)

    a380_cpu = cs.variant(procedural.a380_scheme(cs.MESH_W, cs.MESH_H, cs.MESH_SPP),
                          use_gpu=False)
    scene, o, d, seed, _, n = cs.frame_rays(dev, a380_cpu)
    po, pd, ps = cs.frame_pool(o, d, seed, n)
    inr = cs.in_render_pool(a380_cpu)
    pools = {"frame pool": (po, pd, ps, CPU_GUARD, scene.mesh),
             "in-render pool": (inr["o"], inr["d"], inr["seed"], inr["t_min"], inr["tables"])}

    loaded = build._LOADED["mesh_kernel"]

    def with_group(g):
        def run(*args, **kw):
            build._LOADED["mesh_kernel"] = variants[g]
            return mk.mesh_hit(*args, **kw)
        return run

    def per_thread(*args, **kw):
        build._LOADED["mesh_kernel"] = loaded
        return mk._mesh_hit_per_thread(*args, **kw)

    try:
        for label, (ro, rd, rs, t_min, tables) in pools.items():
            ref = mk.mesh_hit_walk(ro, rd, rs, tables, t_min=t_min)
            for g in GROUPS:
                cs.hit_parity(f"{label} G={g}", with_group(g)(ro, rd, rs, tables, t_min=t_min),
                              ref, rs, t_min)
            turns = ([("per-thread", per_thread, 20)]
                     + [(f"G={g}", with_group(g), 20) for g in GROUPS + GROUPS[::-1]]
                     + [("per-thread", per_thread, 20)])
            ms = cs.time_hit_turns(label, (ro, rd, rs, t_min, tables), card, turns)
            print(f"[groups] {label}: " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
                  + f" per launch [{card}]", flush=True)
    finally:
        build._LOADED["mesh_kernel"] = loaded
    return 0


if __name__ == "__main__":
    sys.exit(main())
