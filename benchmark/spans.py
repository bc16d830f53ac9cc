"""The program's own spans and counters over a run of a cell: the
per-layer metrics that read them, and the command that measures them.

    python3 -m benchmark.spans --workload <cell> --seed <n> --seconds <s>

runs the cell as `python3 -m benchmark.run ... --trace 1` runs it
(run.run_rank: set-up, the window, the traced calls, the check) with the
program's span recorder (raytrace_tpu_torch.utils.profiling) on from
the start, so set-up's spans are caught, and prints run.py's result line
with the metrics of READERS added under "metrics" and the clock's check
and the idle by span under "spans". The window is unprofiled, so the
host spans read there carry no profiler stretch; the device metrics lay
the traced calls' spans over the profiler's device intervals. Both are
on one clock: the recorder stamps time.time_ns, on which torch.profiler
stamps its host events (the clock check: each traced render.copy span
holds the host's cudaMemcpyAsync of that copy). The [window] line on
standard error, against a `--trace 0` run's, is the recorder's cost.

run.py neither switches the recorder on nor hands spans to
metrics/<name>.py, so the readers live here. Each takes the context
`context` builds:
  spans: [{name, start, end (us), parent (index or None), part}], part by
    start: "setup" (before the window's first call), "window", "traced"
    (until the last traced call ends) or "after";
  calls: {part: Renderer.render calls}; counters: {part: {name: rise}};
  device, host: the traced calls' profiler intervals [(name, start_us, end_us)].
"""
from __future__ import annotations

import argparse
import bisect
import json
import sys
from collections import defaultdict

from . import run, trace

HOST = ("render.add", "render.hook", "render.mean", "target.new")  # the host remainder
COPY_CALL = "cudaMemcpyAsync"


def self_us(spans) -> list:
    """Each span's duration less the part of it that its children cover."""
    kids = defaultdict(list)
    for s in spans:
        if s["parent"] is not None:
            kids[s["parent"]].append((None, s["start"], s["end"]))
    out = []
    for i, s in enumerate(spans):
        cover = trace.merged([(n, max(a, s["start"]), min(b, s["end"])) for n, a, b in kids[i]
                              if min(b, s["end"]) > max(a, s["start"])])
        out.append(s["end"] - s["start"] - sum(b - a for a, b in cover))
    return out


def _total(ctx, names, part, own=False) -> float:
    """us of the spans named in `names` within `part` (their self time with own)."""
    spans = ctx["spans"]
    times = self_us(spans) if own else [s["end"] - s["start"] for s in spans]
    return sum(t for s, t in zip(spans, times) if s["part"] == part and s["name"] in names)


def _has(ctx, name, part) -> bool:
    return any(s["name"] == name and s["part"] == part for s in ctx["spans"])


def _inside(cover, starts, t) -> bool:
    """Whether t lies in one of the sorted disjoint intervals `cover`."""
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and cover[i][1] >= t


def _gaps(ctx) -> list:
    busy = trace.merged(ctx["device"])
    return [(e0, s1) for (_, e0), (s1, _) in zip(busy, busy[1:]) if s1 > e0]


def host_ms_per_call(ctx):
    """renderer.host_ms_per_call: self time of the add, the hook, the mean
    and the new targets a window call."""
    n = ctx["calls"].get("window", 0)
    return _total(ctx, HOST, "window", own=True) / 1e3 / n if n else None


def launch_ms_per_iteration(ctx):
    """wavefront.launch_ms_per_iteration: the window's wavefront.launch
    time (a replay's host call) over its wavefront iterations."""
    its = ctx["counters"].get("window", {}).get("wavefront.iterations", 0)
    if not its or not _has(ctx, "wavefront.launch", "window"):
        return None
    return _total(ctx, ("wavefront.launch",), "window") / 1e3 / its


def graph_gap_us_per_iteration(ctx):
    """wavefront.graph_gap_us_per_iteration: the device's idle time between
    two consecutive kernels (neither a copy nor a memset) inside the
    traced calls' wavefront loops (their wavefront.launch and
    wavefront.flag spans), over those calls' iterations: the bubbles
    between a graph's kernels. An iteration ends with the flag's copy, so
    the wait for the host between two replays is not counted, wherever
    the host is meanwhile (the profiler stretches each graph launch)."""
    its = ctx["counters"].get("traced", {}).get("wavefront.iterations", 0)
    loop = trace.merged([(None, s["start"], s["end"]) for s in ctx["spans"] if s["part"] ==
                         "traced" and s["name"] in ("wavefront.launch", "wavefront.flag")])
    if not its or not loop or not ctx["device"]:
        return None
    starts = [a for a, _ in loop]
    total, end, kernel = 0.0, None, False
    for name, a, b in sorted(ctx["device"], key=lambda x: x[1]):
        is_kernel = not name.startswith((trace.COPY, trace.SET))
        if end is not None and a > end and kernel and is_kernel and \
                _inside(loop, starts, (end + a) / 2):
            total += a - end
        if end is None or b > end:
            end, kernel = b, is_kernel
    return total / its


def capture_s(ctx):
    """wavefront.capture_s: the CUDA graph captures' seconds in set-up."""
    if not _has(ctx, "wavefront.capture", "setup"):
        return None
    return _total(ctx, ("wavefront.capture",), "setup") / 1e6


def clusters_s(ctx):
    """scene.clusters_s: the cluster builds' seconds in set-up."""
    if not _has(ctx, "scene.clusters", "setup"):
        return None
    return _total(ctx, ("scene.clusters",), "setup") / 1e6


def launches_per_call(ctx):
    """kernels.launches_per_call: the CUDA entries' launches (the
    launches.* counters' rise) a window call."""
    n = ctx["calls"].get("window", 0)
    rise = ctx["counters"].get("window", {})
    got = [v for k, v in rise.items() if k.startswith("launches.")]
    return sum(got) / n if n and got and sum(got) else None


def _innermost(spans) -> list:
    """Sorted (start, end, name) pieces of time, each under the innermost
    of the nested spans [(name, start, end)] open there."""
    pieces, stack, t = [], [], None
    for name, a, b in sorted(spans, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][2] <= a:
            top = stack.pop()
            pieces.append((t, top[2], top[0]))
            t = top[2]
        if stack:
            pieces.append((t, a, stack[-1][0]))
        stack.append((name, a, b))
        t = a
    while stack:
        top = stack.pop()
        pieces.append((t, top[2], top[0]))
        t = top[2]
    return [p for p in pieces if p[1] > p[0]]


def idle_by_span(ctx) -> dict:
    """The traced calls' device idle seconds by the innermost program span
    open at each moment of it; a moment outside every span by the
    profiler's innermost host event there ("outside: <event>")."""
    pieces = _innermost([(s["name"], s["start"], s["end"]) for s in ctx["spans"]
                         if s["part"] == "traced"])
    starts = [a for a, _, _ in pieces]
    out, outside = defaultdict(float), []
    for a, b in _gaps(ctx):
        k, t = max(bisect.bisect_right(starts, a) - 1, 0), a
        while k < len(pieces) and pieces[k][0] < b:
            p0, p1, name = pieces[k]
            lo, hi = max(a, p0), min(b, p1)
            if hi > lo:
                if lo > t:
                    outside.append((t, lo))
                out[name] += (hi - lo) / 1e6
                t = hi
            k += 1
        if b > t:
            outside.append((t, b))
    for k, v in trace._label_gaps(outside, ctx["host"]).items():
        out[f"outside: {k}"] += v
    return dict(out)


def idle_unspanned_pct(ctx):
    """device.idle_unspanned_pct: the share of the traced calls' device
    idle time during which the host was inside no program span."""
    split = idle_by_span(ctx)
    idle = sum(split.values())
    if idle <= 0 or not any(s["part"] == "traced" for s in ctx["spans"]):
        return None
    return 100.0 * sum(v for k, v in split.items() if k.startswith("outside: ")) / idle


def copies_in_spans(ctx) -> tuple:
    """(traced render.copy spans, those that hold a host cudaMemcpyAsync
    event): the check that spans and the profiler share a clock."""
    calls = [(s, e) for n, s, e in ctx["host"] if n.startswith(COPY_CALL)]
    copies = [s for s in ctx["spans"] if s["part"] == "traced" and s["name"] == "render.copy"]
    held = sum(any(s["start"] <= a and b <= s["end"] for a, b in calls) for s in copies)
    return len(copies), held


READERS = {  # name: (unit, reader)
    "renderer.host_ms_per_call": ("ms", host_ms_per_call),
    "wavefront.launch_ms_per_iteration": ("ms", launch_ms_per_iteration),
    "wavefront.graph_gap_us_per_iteration": ("us", graph_gap_us_per_iteration),
    "wavefront.capture_s": ("s", capture_s),
    "scene.clusters_s": ("s", clusters_s),
    "kernels.launches_per_call": ("launches", launches_per_call),
    "device.idle_unspanned_pct": ("%", idle_unspanned_pct),
}


def _rise(a: dict, b: dict) -> dict:
    return {k: v - a.get(k, 0) for k, v in b.items()}


def context(records, snaps, n_window: int, device=(), host=()) -> dict:
    """The readers' context from the recorder's records (Span objects, in
    the order opened), the counters before the warm call and after each
    call (`snaps`: the warm call, the window's n_window calls, the traced
    calls), and the traced calls' profiler intervals."""
    renders = [r for r in records if r.name == "render"]
    inf = float("inf")
    t_window = renders[1].start / 1e3 if len(renders) > 1 else inf
    t_traced = renders[1 + n_window].start / 1e3 if len(renders) > 1 + n_window else inf
    t_end = renders[-1].end / 1e3 if renders else inf
    spans = []
    for r in records:
        s = r.start / 1e3
        part = ("setup" if s < t_window else "window" if s < t_traced else
                "traced" if s <= t_end else "after")
        spans.append(dict(name=r.name, start=s, end=r.end / 1e3, parent=r.parent, part=part))
    w0, w1 = min(1, len(snaps) - 1), min(1 + n_window, len(snaps) - 1)
    return dict(spans=spans,
                calls=dict(setup=min(len(renders), 1),
                           window=max(min(n_window, len(renders) - 1), 0),
                           traced=max(len(renders) - 1 - n_window, 0)),
                counters=dict(window=_rise(snaps[w0], snaps[w1]),
                              traced=_rise(snaps[w1], snaps[-1])),
                device=list(device), host=list(host))


def run_cell(cell: str, seed: int, seconds: float, device: str = "cuda",
             overrides: dict | None = None) -> dict:
    """run.run_rank's --trace 1 result for one card, with the recorder on
    from the start; adds READERS' metrics and "spans" (clock check, idle
    by span)."""
    from raytrace_tpu_torch.utils import profiling

    from . import system

    snaps, events = [], dict(device=[], host=[])
    collect, render = trace.collect, system.System.render

    def collect_kept(prof):  # the traced calls' intervals, for the readers too
        events["device"], events["host"] = collect(prof)
        return events["device"], events["host"]

    def render_counted(self, samples):
        img = render(self, samples)
        snaps.append(profiling.counters())
        return img

    profiling.reset()
    snaps.append(profiling.counters())
    profiling.enable()
    trace.collect, system.System.render = collect_kept, render_counted
    try:
        result = run.run_rank(cell, seed, seconds, True, device=device, overrides=overrides)
    finally:
        trace.collect, system.System.render = collect, render
        profiling.enable(False)
    ctx = context(profiling.records(), snaps, result["attempted"], **events)
    for name, (unit, read) in READERS.items():
        v = read(ctx)
        if v is not None:
            result["metrics"][name] = {"value": v, "unit": unit}
    n_copies, held = copies_in_spans(ctx)
    idle = sorted(idle_by_span(ctx).items(), key=lambda kv: -kv[1])
    result["spans"] = dict(copy_spans=n_copies, copy_spans_holding_their_copy=held,
                           records=len(ctx["spans"]), calls=ctx["calls"],
                           idle_by_span=[[k, v] for k, v in idle[:12]])
    run._log(f"[spans] {len(ctx['spans'])} spans; calls {ctx['calls']}; traced render.copy "
             f"spans holding their {COPY_CALL}: {held} of {n_copies}")
    run._log("[spans] traced device idle by innermost span (s): "
             + ", ".join(f"{k} {v:.6f}" for k, v in idle))
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--override", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        run._log("[device] this command needs a CUDA device")
        return 2
    return run._emit(run_cell(args.workload, args.seed, args.seconds, args.device,
                              json.loads(args.override) if args.override else None))


if __name__ == "__main__":
    sys.exit(main())
