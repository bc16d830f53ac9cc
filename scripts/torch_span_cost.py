#!/usr/bin/env python3
"""What the port's span recorder costs a benchmark cell, measured on the card.

    python3 scripts/torch_span_cost.py --workload a380-cpu-10spp --seed 7 --seconds 60

Builds the cell's Renderer as `benchmark.run` does (its scene, traffic,
warm call, one core and one torch thread), then runs its closed loop of
`render(samples=batch)` calls in blocks of --block calls, the recorder
(`raytrace_tpu_torch.utils.profiling`) off and on in turns (off, on, on,
off, ...), its records dropped after each block. Two runs of a cell
differ by several percent (PERF.md section 2) where two blocks of one
process do not, so the turns resolve a cost well under 1%. Prints one
JSON line: each mode's calls, Mpaths/s over its calls' summed wall time,
median and p95 ms a call; the median over adjacent (off, on) block pairs
of on's ms a call over off's, less one, as `cost_pct`; the garbage
collector's passes in each mode; the host ns of one span with the
recorder on and off; the card's name and power limit.
Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
import timeit

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def span_ns() -> dict:
    """Host ns of one empty span, the recorder off and on."""
    from raytrace_tpu_torch.utils import profiling

    def one():
        with profiling.span("x"):
            pass

    out = {}
    for mode in ("off", "on"):
        profiling.enable(mode == "on")
        n = 200_000
        out[mode] = min(timeit.repeat(one, number=n, repeat=3)) / n * 1e9
        profiling.reset()
    profiling.enable(False)
    return out


def main(argv=None) -> int:
    import numpy as np
    import torch

    from benchmark import run, scenes, traffic as tr
    from benchmark.system import System
    from raytrace_tpu_torch.utils import profiling

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--block", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    cell = run.cell_of(run.load_bench(), args.workload)
    raw = scenes.raw_scene(scenes.load_config(cell["config"]))
    traffic = tr.Images(tr.load_traffic(cell["traffic"]), args.seed)
    run._pin(0)
    system = System(raw, "cuda")
    pix = tr.check_pixels(raw.width, raw.height, cell["check"], args.seed)
    start = traffic.next_start()
    state = dict(pix=pix, prev=None, first=True, start=start, count=start)
    system.new_image(start)
    run._call(system, traffic, state)  # the warm call
    torch.cuda.synchronize()
    times = {"off": [], "on": []}
    collections = {"off": [0, 0, 0], "on": [0, 0, 0]}  # the garbage collector's, by generation
    pairs, block_ms = [], {}
    order, k = ("off", "on", "on", "off"), 0
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < args.seconds or k % 4:
        mode = order[k % 4]
        before = [g["collections"] for g in gc.get_stats()]
        profiling.enable(mode == "on")
        dts = [run._call(system, traffic, state)[0] for _ in range(args.block)]
        profiling.enable(False)
        for g, (b, a) in enumerate(zip(before, gc.get_stats())):
            collections[mode][g] += a["collections"] - b
        profiling.reset()
        times[mode] += dts
        block_ms[mode] = float(np.mean(dts)) * 1e3
        if k % 2:  # (off, on) or (on, off): a pair of adjacent blocks
            pairs.append(block_ms["on"] / block_ms["off"] - 1.0)
        k += 1
    paths = traffic.batch * raw.width * raw.height
    res = {m: dict(calls=len(v), mpaths_per_s=len(v) * paths / sum(v) / 1e6,
                   p50_ms=float(np.median(v)) * 1e3, p95_ms=float(np.percentile(v, 95)) * 1e3)
           for m, v in times.items()}
    res.update(workload=args.workload, seed=args.seed, block=args.block, pairs=len(pairs),
               cost_pct=100.0 * float(np.median(pairs)),
               cost_pct_quartiles=[100.0 * float(q) for q in np.quantile(pairs, [0.25, 0.75])],
               gc_collections=collections, span_ns=span_ns(),
               device=torch.cuda.get_device_name(0),
               card=subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                    "--format=csv,noheader"], capture_output=True,
                                   text=True).stdout.strip())
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
