#!/usr/bin/env python3
"""A cell's program counters a call beside the reference's count of the
same work.

    python3 scripts/torch_cell_counters.py --workload <cell> --seed <n> --seconds <s>

Runs the cell as `python3 -m benchmark.spans` runs it (benchmark.spans.
run_cell: a `--trace 1` run with the program's span recorder on), prints
its result line, and then on standard error: the rise a call of each
counter that rose, in the window and in the traced calls
(`wavefront.sky_fetches`, `wavefront.lane_bounces`, `launches.*`, ...);
the reference's work on the check's pixels scaled to a call (run.py's
`_scaled`: lane-bounces, paths, the sky's fetches by face); and the ratio
of the program's counts to the reference's for the lane-bounces and the
sky's fetches. The idle by span is the result line's "spans". Needs a
CUDA card.
"""
import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--override", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import run, spans

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    kept = {}
    context, scaled = spans.context, run._scaled

    def context_kept(*a, **kw):
        kept["ctx"] = context(*a, **kw)
        return kept["ctx"]

    def scaled_kept(work, s):
        kept["work"] = scaled(work, s)
        return kept["work"]

    spans.context, run._scaled = context_kept, scaled_kept
    try:
        result = spans.run_cell(args.workload, args.seed, args.seconds, args.device,
                                json.loads(args.override) if args.override else None)
    finally:
        spans.context, run._scaled = context, scaled
    run._emit(dict(result))
    ctx, work = kept["ctx"], kept["work"]
    per_call = {}
    for part in ("window", "traced"):
        n = ctx["calls"][part]
        per_call[part] = {k: v / n for k, v in sorted(ctx["counters"][part].items()) if n and v}
        run._log(f"[counters] {part}, {n} calls, a call: "
                 + ", ".join(f"{k} {v:.1f}" for k, v in per_call[part].items()))
    fetches = sum(work["sky_fetches"].values())
    run._log(f"[work] the reference's, scaled to a call: lane_bounces {work['lane_bounces']:.1f}, "
             f"paths {work['paths']:.1f}, sky_fetches {fetches:.1f} "
             f"({json.dumps({k: round(v, 1) for k, v in work['sky_fetches'].items()})}), "
             f"by_branch {json.dumps({k: round(v, 1) for k, v in work['by_branch'].items()})}")
    for name, ref in (("wavefront.lane_bounces", work["lane_bounces"]),
                      ("wavefront.sky_fetches", fetches)):
        got = per_call["window"].get(name)
        if got is not None and ref:
            run._log(f"[work] {name}: the program's {got:.1f} a call, the reference's scaled "
                     f"{ref:.1f}, ratio {got / ref:.5f}")


if __name__ == "__main__":
    main()
