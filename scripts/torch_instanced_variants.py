#!/usr/bin/env python3
"""Occupancy and ordering chunk of the port's `mesh_trace_instanced`, measured on the card.

    python3 scripts/torch_instanced_variants.py

`raytrace_tpu_torch/csrc/mesh_kernel.cu` keeps two constants for its
instanced entry: `kInstBlocks`, the resident blocks of 256 threads a SM
its launch bounds ask of ptxas (2: up to 128 registers; 4 is mesh_trace's
64), and `kInstChunk`, the instances its group slab-tests and orders
together. This script builds copies of the source with kInstBlocks 4
and 3 (the committed kernel has 2) and with kInstChunk 8 and 16 (it has
32) (`torch_mesh_hit_groups.build_variant`, all at once),
prints ptxas's registers and spills of each copy's instanced kernel, holds
each copy's output bitwise against the committed kernel's on the fleet
(procedural.fleet_scheme: 17 instances, 124,100 triangles, the whole
1216x608 frame at 16 samples per lane), and times the committed kernel,
the copies and the flattened walk (`mesh_trace`, route "walk") on that
launch in turns, forward then back, with the card's name and power limit.
Needs a CUDA card and nvcc; prints no result without them.
"""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COPIES = {"kInstBlocks=4": {"kInstBlocks": 4}, "kInstBlocks=3": {"kInstBlocks": 3},
          "kInstChunk=8": {"kInstChunk": 8}, "kInstChunk=16": {"kInstChunk": 16}}
KERNEL = "mesh_trace_kernelILb0ELb1ELb0ELb0E"  # the weyl, no-sky instanced instantiation
REPS = 2  # launches per turn, after a warm-up


def ptxas_lines(built):
    """ptxas's lines for the instanced kernel of a build."""
    lines = built.log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and KERNEL in line:
            return " | ".join(s.split("ptxas info    :")[-1].strip() for s in lines[i + 2:i + 4])
    return "not found"


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("torch_instanced_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import chip_smoke as cs
    from raytrace_tpu_torch.kernels import build
    from raytrace_tpu_torch.ops import mesh_kernel as mk
    from torch_mesh_hit_groups import build_variant

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    with ThreadPoolExecutor(len(COPIES) + 1) as pool:
        committed = pool.submit(build.build, "mesh_kernel")
        copies = dict(zip(COPIES, pool.map(lambda kv: build_variant(
            kv[1], kv[0].replace("=", "")), COPIES.items())))
        builds = {"committed": committed.result(), **copies}
    for key, built in builds.items():
        print(f"[build] {key}: {ptxas_lines(built)}", flush=True)

    dev = torch.device("cuda", 0)
    _, tables = cs.fleet_build(dev, card, cs.fleet_scheme(), "fleet")
    flat = torch.arange(cs.MESH_W * cs.MESH_H, dtype=torch.int32, device=dev)
    xs, ys, zero = flat % cs.MESH_W, flat // cs.MESH_W, torch.zeros_like(flat)
    loaded = build._LOADED["mesh_kernel"]

    def launch(key, route="instanced"):
        build._LOADED["mesh_kernel"] = builds.get(key, loaded)
        try:
            return torch.stack(mk.mesh_trace(xs, ys, zero, tables, route=route, assured=5,
                                             max_bounces=24, samples_per_lane=cs.MESH_SPP))
        finally:
            build._LOADED["mesh_kernel"] = loaded

    ref = launch("committed")
    for key in COPIES:
        differ = int((launch(key) != ref).any(0).sum())
        print(f"[variants] {key}: {differ} lanes differ from the committed kernel", flush=True)
        assert differ == 0, f"{key}: {differ} lanes differ"
    order = ["walk", "committed", *COPIES]
    t = {}
    for key in order + order[::-1]:
        route = "walk" if key == "walk" else "instanced"
        launch(key, route)  # warm-up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            launch(key, route)
        end.record()
        end.synchronize()
        t.setdefault(key, []).append(start.elapsed_time(end) / REPS)
    for key, v in t.items():
        ms = sum(v) / len(v)
        print(f"[variants] fleet {cs.MESH_W}x{cs.MESH_H} spl={cs.MESH_SPP} {key}: {ms:.3f} "
              f"ms/launch (turns {[round(x, 3) for x in v]}; {ms / (sum(t['walk']) / 2):.3f}x the "
              f"walk) [{card}]", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
