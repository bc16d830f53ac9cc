"""The readings that the check's limits are set from, for one cell, in one
process on the card (its output: one JSON line, also written to --out):

- lower: `pixels_off_pct` of sound runs of the program, a short window of
  the cell's own traffic on each of `--seeds` seeds (run.run_rank, as a
  run of the benchmark does, checked calls and pixels drawn from each seed);
- upper: the control, the reference computed in bfloat16 (the precision
  below the float32 the renderer states) in the program's place: its batch
  sums against the float32 reference's, on `--control` seeds, for the
  pixels and samples of each seed's first checked image.

    python3 -m benchmark.limits --workload <cell> --seeds 12 --control 3 --seconds 3
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from . import check, run, scenes, traffic as tr
from .reference import scene as ref_scene


def control_reading(cell: dict, seed: int, device: str, overrides=None) -> float:
    cfg = dict(scenes.load_config(cell["config"]), **(overrides or {}).get("config", {}))
    raw = scenes.raw_scene(cfg, device)
    spec = dict(tr.load_traffic(cell["traffic"]), **(overrides or {}).get("traffic", {}))
    start = tr.Images(spec, seed).next_start()
    ys, xs = tr.check_pixels(raw.width, raw.height, cell["check"], seed)
    sums = {}
    for dt in (torch.float32, torch.bfloat16):
        ref = ref_scene.build(raw, device, dt)
        sums[dt] = check.reference_sums(ref, raw.use_gpu, ys, xs, start, int(spec["batch"]),
                                        assured=raw.assured_depth,
                                        max_bounces=raw.max_bounces).float().cpu().numpy()
    return check.pixels_off_pct(sums[torch.bfloat16], sums[torch.float32])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, default=12)
    ap.add_argument("--control", type=int, default=3)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--first-seed", type=int, default=3_000_000_000)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    bench = run.load_bench()
    cell = run.cell_of(bench, args.workload)
    if int(cell["chips"]) != 1:
        raise SystemExit("limits.py reads one-card cells; a multi-card cell's ranks render "
                         "the one-card cell's paths, summed")
    seeds = [args.first_seed + 7919 * i for i in range(args.seeds)]
    lower = []
    for s in seeds:
        t = time.perf_counter()
        res = run.run_rank(args.workload, s, args.seconds, False, bench=bench)
        lower.append(res["check"]["pixels_off_pct"]["value"])
        print(f"[limits] seed {s}: pixels_off_pct {lower[-1]} ({res['attempted']} calls, "
              f"{time.perf_counter() - t:.1f} s)", file=sys.stderr, flush=True)
    upper = []
    for s in seeds[:args.control]:
        upper.append(control_reading(cell, s, "cuda"))
        print(f"[limits] control seed {s}: pixels_off_pct {upper[-1]}", file=sys.stderr, flush=True)
    out = dict(workload=args.workload, card=torch.cuda.get_device_name(0), seeds=seeds,
               lower=lower, upper=upper, lower_reading=max(lower), upper_reading=min(upper))
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
