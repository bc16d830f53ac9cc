#!/usr/bin/env python3
"""Occupancy of the port's `mesh_trace_instanced`, measured on the card.

    python3 scripts/torch_instanced_variants.py [--large]

`raytrace_tpu_torch/csrc/mesh_kernel.cu` sets its instanced entry's
occupancy with `kInstBlocks`, the resident blocks of 256 threads a SM its
launch bounds ask of ptxas (2: up to 128 registers, 3: 80, 4: 64). This
script builds a copy of the source for every other value of 2, 3 and 4
(`torch_mesh_hit_groups.build_variant`, all at once with the committed
source), prints ptxas's registers, stack, spills and shared memory of
every instanced kernel of the committed build (`mesh_trace_kernel<inst=1>`
in its four instantiations and `mesh_trace_instanced_first_kernel`, the
first design) and of each copy's weyl no-sky instantiation, holds each
copy's output bitwise against the committed kernel's and the first
design's on the fleet (procedural.fleet_scheme: 17 instances, 124,100
triangles, the whole 1216x608 frame at 16 samples per lane), and times
the flattened walk (`mesh_trace`, route "walk"), the first design, the
committed kernel and the copies on that launch in turns, forward then
back, with the card's name and power limit. --large adds the same checks
and turns on the large fleet (FLEET_LARGE_ROWS: 144 instances, 1,051,200
triangles). Needs a CUDA card and nvcc; prints no result without them.
"""
import argparse
import itertools
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SWEEP = {"kInstBlocks": (2, 3, 4)}
KERNEL = "mesh_trace_kernelILb0ELb1ELb0ELb0E"  # the weyl, no-sky instanced instantiation
REPS = 2  # launches per turn, after a warm-up


def committed_values():
    """The committed source's value of each swept constant."""
    from raytrace_tpu_torch.kernels import build

    src = (build.CSRC / "mesh_kernel.cu").read_text()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", src).group(1)) for k in SWEEP}


def copies():
    """{tag: {constant: value}} of every swept combination but the committed one."""
    here = committed_values()
    out = {}
    for values in itertools.product(*SWEEP.values()):
        pair = dict(zip(SWEEP, values))
        if pair != here:
            out[",".join(f"{k}={v}" for k, v in pair.items())] = pair
    return out


def fmt(info):
    return (f"{info.get('registers')} registers, {info.get('stack')} B stack, "
            f"{info.get('spill_stores')} B spill stores, {info.get('spill_loads')} B spill loads, "
            f"{info.get('smem')} B static smem")


def turns(cs, label, tables, builds, keys, card):
    """The 16-spl launch of the whole frame by each key in turns, forward
    then back: "walk", "first" (the first design) or a build's tag."""
    import torch

    from raytrace_tpu_torch.kernels import build
    from raytrace_tpu_torch.ops import mesh_kernel as mk

    flat = torch.arange(cs.MESH_W * cs.MESH_H, dtype=torch.int32, device=tables.inst.device)
    xs, ys, zero = flat % cs.MESH_W, flat // cs.MESH_W, torch.zeros_like(flat)
    loaded = build._LOADED["mesh_kernel"]
    kw = dict(assured=5, max_bounces=24, samples_per_lane=cs.MESH_SPP)

    def launch(key):
        build._LOADED["mesh_kernel"] = builds.get(key, loaded)
        try:
            if key == "first":
                out = mk._mesh_trace_yardstick(xs, ys, zero, tables, route="instanced", **kw)
            else:
                out = mk.mesh_trace(xs, ys, zero, tables, route="walk" if key == "walk"
                                    else "instanced", **kw)
            return torch.stack(out)
        finally:
            build._LOADED["mesh_kernel"] = loaded

    ref = launch("committed")
    for key in keys:
        if key != "walk":
            differ = int((launch(key) != ref).any(0).sum())
            print(f"[variants] {label} {key}: {differ} lanes differ from the committed kernel",
                  flush=True)
            assert differ == 0, f"{label} {key}: {differ} lanes differ"
    t = {}
    for key in keys + keys[::-1]:
        launch(key)  # warm-up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            launch(key)
        end.record()
        end.synchronize()
        t.setdefault(key, []).append(start.elapsed_time(end) / REPS)
    walk = sum(t["walk"]) / 2
    for key, v in t.items():
        ms = sum(v) / len(v)
        print(f"[variants] {label} {cs.MESH_W}x{cs.MESH_H} spl={cs.MESH_SPP} {key}: {ms:.3f} "
              f"ms/launch (turns {[round(x, 3) for x in v]}; {ms / walk:.3f}x the walk) [{card}]",
              flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--large", action="store_true", help="also time the large fleet")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_instanced_variants: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import chip_smoke as cs
    from raytrace_tpu_torch.kernels import build
    from raytrace_tpu_torch.models import procedural
    from torch_mesh_hit_groups import build_variant

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    variants = copies()
    with ThreadPoolExecutor(len(variants) + 1) as pool:
        committed = pool.submit(build.build, "mesh_kernel")
        built = dict(zip(variants, pool.map(lambda kv: build_variant(
            kv[1], re.sub(r"[^A-Za-z0-9]+", "_", kv[0])), variants.items())))
        builds = {"committed": committed.result(), **built}
    print(f"[build] committed {committed_values()}", flush=True)
    for name, info in cs.inst_ptxas(builds["committed"].log).items():
        print(f"[build] committed {name}: {fmt(info)}", flush=True)
    for key in variants:
        info = {k: v for k, v in cs.ptxas_info(builds[key].log).items() if KERNEL in k}
        print(f"[build] {key} mesh_trace_kernel<inst=1>: "
              f"{fmt(next(iter(info.values()))) if info else 'not found'}", flush=True)

    dev = torch.device("cuda", 0)
    _, tables = cs.fleet_build(dev, card, cs.fleet_scheme(), "fleet")
    turns(cs, "fleet", tables, builds, ["walk", "first", "committed", *variants], card)
    if args.large:
        del tables
        _, tables = cs.fleet_build(dev, card, cs.fleet_scheme(rows=procedural.FLEET_LARGE_ROWS),
                                   "large fleet")
        turns(cs, "large fleet", tables, builds, ["walk", "first", "committed", *variants], card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
