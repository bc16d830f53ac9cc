"""The benchmark of raytrace_tpu_torch: one cell of BENCHMARK.json, one run.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A cell names a configuration (configs/<name>.json: the scene as it is
run), a traffic mix (traffic/<name>.json) and its cards; workloads/<cell>.json
holds its check (rows or pixels, calls, limits). The run builds the scene, warms
the Renderer with one call of the cell's batch, then measures a closed loop
of `render(samples=batch)` calls for `--seconds` (traffic.py), with
`--trace 1` profiles a few more calls, checks the calls it drew from the
seed against the plain reference (check.py), and prints one JSON line:
the cell's end-to-end metrics (`--trace 0`) or its per-layer metrics
(`--trace 1`), each read by metrics/<name>.py from the run's context,
and set-up's parts under "setup_parts" (nvcc's seconds among them, so a
checkout's first run, which builds the kernels, shows apart).
A cell of more than one card spawns one process a card (NCCL ranks
rendezvousing on a free local port); rank 0 prints the line. Each rank's
process keeps to one core, and torch to one CPU thread. The run needs
CUDA: without it, or with fewer cards than the cell asks for, it exits 2
and prints no result.
"""
from __future__ import annotations

import time

T0 = time.monotonic()  # the process's start, for setup_s

import argparse  # noqa: E402
import atexit  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import threading  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
FORBIDDEN = {"jax", "jaxlib", "flax", "raytrace_tpu"}
TRACE_SECONDS = 1.0  # the traced calls' length, at most TRACE_CALLS of them
TRACE_CALLS = (2, 40)
CHILD_TIMEOUT = 1150  # a rank's seconds, the first run's build included


def load_bench(root: Path = ROOT) -> dict:
    return json.loads((root.parent / "BENCHMARK.json").read_text())


def cell_of(bench: dict, name: str, root: Path = ROOT) -> dict:
    """The workload entry of BENCHMARK.json with workloads/<name>.json."""
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    return dict(entry, **json.loads((root / "workloads" / f"{name}.json").read_text()))


def metrics_of(bench: dict, cell: str, trace: bool) -> list:
    """The metrics a run of `cell` reports: its end-to-end metrics, or
    with trace its per-layer ones (those that list it, or list none)."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


def reader(name: str, root: Path = ROOT):
    """metrics/<name>.py's `read(ctx)`."""
    spec = importlib.util.spec_from_file_location("_bench_metric_" + name.replace(".", "_"),
                                                  root / "metrics" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in FORBIDDEN)


def _log(msg: str):
    print(msg, file=sys.stderr, flush=True)


SMI_QUERY = ["nvidia-smi", "--query-gpu=index,name,power.limit,power.draw,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"]


def _smi_start():
    """nvidia-smi's reading of the cards' clocks and power, started in the
    background (it takes seconds, which set-up need not wait for)."""
    try:
        proc = subprocess.Popen(SMI_QUERY, stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                                text=True)
    except OSError as e:
        return f"unavailable ({e})"
    atexit.register(lambda: proc.poll() is None and (proc.kill(), proc.wait()))
    return proc


def _smi(tag: str, proc=None):
    """Log the reading of `proc` (_smi_start), or take one now, on standard
    error."""
    proc = _smi_start() if proc is None else proc
    if isinstance(proc, str):
        out = proc
    else:
        try:
            out = proc.communicate(timeout=20)[0].strip()
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            out = "unavailable (timed out)"
    for line in out.splitlines() or [out]:
        _log(f"[smi {tag}] {line}")


def _pin(rank: int):
    """Keep each rank's process on one core of its own (the host loop's
    timing then does not follow the scheduler's moves), and torch's CPU
    work to one thread."""
    import os

    import torch

    cpus = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {cpus[(2 + 2 * rank) % len(cpus)]})
    torch.set_num_threads(1)


# --- one rank --------------------------------------------------------------

class _Ctl:
    """Rank 0's decisions, broadcast to every rank over a gloo group."""

    def __init__(self, world: int):
        import torch
        import torch.distributed as dist

        self.world = world
        self.group = None
        if world > 1:
            self.group = dist.new_group(backend="gloo") if dist.get_backend() != "gloo" \
                else dist.group.WORLD
        self._t = torch.zeros(1, dtype=torch.int64)

    def decide(self, value: int) -> int:
        if self.world == 1:
            return value
        import torch.distributed as dist

        self._t[0] = value
        dist.broadcast(self._t, src=0, group=self.group)
        return int(self._t[0])

    def gather(self, obj) -> list:
        if self.world == 1:
            return [obj]
        import torch.distributed as dist

        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out


def _call(system, traffic, state):
    """One call of the client: render a batch, start the next image once
    this one has its samples. The client counts the samples it asked for
    (the target's count is the program's). Returns (seconds, record)."""
    before = state["count"]
    t = time.perf_counter()
    img = system.render(traffic.batch)
    dt = time.perf_counter() - t
    state["count"] += traffic.batch
    ys, xs = state["pix"]
    rec = dict(before=before, after=state["count"], first=state["first"],
               pix=img[ys, xs], prev=state["prev"])
    state["prev"], state["first"] = rec["pix"], False
    if state["count"] - state["start"] >= traffic.image_spp:
        state["start"] = state["count"] = traffic.next_start()
        system.new_image(state["start"])
        state["prev"], state["first"] = None, True
    return dt, rec


def run_rank(cell_name: str, seed: int, seconds: float, trace: bool, *, rank: int = 0,
             world: int = 1, device: str = "cuda", port: int = 0, t0: float = T0,
             overrides: dict | None = None, bench: dict | None = None):
    """One rank's run; rank 0 returns the result dict, the others None."""
    import numpy as np
    import torch

    from . import check, scenes, traffic as tr
    from .reference import paths as ref_paths
    from .reference import scene as ref_scene
    from .system import System

    bench = bench or load_bench()
    cell = cell_of(bench, cell_name)
    _pin(rank)
    smi = _smi_start() if rank == 0 else None  # the cards' clocks and power, before the run
    t_imports = time.monotonic()
    if world > 1:
        import torch.distributed as dist

        if device == "cuda":
            torch.cuda.set_device(rank)
        dist.init_process_group("nccl" if device == "cuda" else "gloo",
                                init_method=f"tcp://127.0.0.1:{port}", world_size=world, rank=rank)
    ctl = _Ctl(world)
    cfg = dict(scenes.load_config(cell["config"]), **(overrides or {}).get("config", {}))
    raw = scenes.raw_scene(cfg, device)
    spec = dict(tr.load_traffic(cell["traffic"]), **(overrides or {}).get("traffic", {}))
    traffic = tr.Images(spec, seed)
    sync = torch.cuda.synchronize if device == "cuda" else (lambda: None)

    t_system = time.monotonic()
    system = System(raw, device)
    _log(f"[setup] driver {system.driver}, scene and Renderer {system.build_s:.3f} s")
    pix = tr.check_pixels(raw.width, raw.height, cell["check"], seed)
    # the warm call, on an image of its own: it builds the kernels and
    # captures the wavefront's graph for the batch's shape
    warm = tr.Images(spec, seed + 1)
    wstate = dict(pix=pix, prev=None, first=True, start=warm.next_start())
    wstate["count"] = wstate["start"]
    system.new_image(wstate["start"])
    t_warm = time.monotonic()
    _call(system, warm, wstate)
    sync()
    start = traffic.next_start()
    state = dict(pix=pix, prev=None, first=True, start=start, count=start)
    system.new_image(start)
    setup_s = time.monotonic() - t0
    # set-up's parts, in order (scene_s and sky_written_s, the harness's
    # writing of the sky's faces, lie in system_s; making the faces lies in
    # inputs_s); a checkout's first run also builds the kernels (nvcc)
    # inside the warm call, which `kernels_built_s` takes out
    setup_parts = dict(imports_s=t_imports - t0, inputs_s=t_system - t_imports,
                       system_s=t_warm - t_system, scene_s=system.build_s,
                       warm_call_s=time.monotonic() - t_warm, kernels_built_s=system.nvcc_s(),
                       sky_written_s=system.sky_written_s)
    _log("[setup] " + ", ".join(f"{k} {v:.3f}" for k, v in setup_parts.items())
         + f"; setup_s {setup_s:.3f}")
    if smi is not None:
        _smi("before", smi)

    # ---- the window ----
    times, recs = [], []
    w0 = time.perf_counter()
    while True:
        dt, rec = _call(system, traffic, state)
        times.append(dt)
        recs.append(rec)
        if ctl.decide(int(time.perf_counter() - w0 >= seconds)):
            break
    window_s = time.perf_counter() - w0
    if rank == 0:
        q = np.quantile(times, [0, 0.05, 0.25, 0.5, 0.75, 0.95, 1]) * 1e3
        ends = np.cumsum(times)
        parts = [np.asarray(times)[(ends > window_s * k / 5) & (ends <= window_s * (k + 1) / 5)]
                 for k in range(5)]
        fifths = [float(np.median(p)) * 1e3 if len(p) else float("nan") for p in parts]
        _log(f"[window] {len(times)} calls in {window_s:.3f} s; ms a call at quantiles 0, .05, "
             f".25, .5, .75, .95, 1: {' '.join(f'{v:.3f}' for v in q)}; medians of the "
             f"window's fifths: {' '.join(f'{v:.3f}' for v in fifths)}")
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    # ---- the traced calls ----
    summary, traced = None, {}
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        from . import trace as trc

        med = float(np.median(times))
        n = ctl.decide(min(TRACE_CALLS[1], max(TRACE_CALLS[0], math.ceil(TRACE_SECONDS / med))))
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
        iters = 0
        sync()
        with profile(activities=acts) as prof:
            p0 = time.perf_counter()
            for _ in range(n):
                with record_function("bench.call"):
                    _call(system, traffic, state)
                iters += system.iterations()
            sync()
            p1 = time.perf_counter()
        t_parse = time.perf_counter()
        summary = trc.summarize(*trc.collect(prof))
        _log(f"[trace] {n} calls, {p1 - p0:.4f} s traced, the trace read in "
             f"{time.perf_counter() - t_parse:.2f} s")
        traced = dict(calls=n, window_s=p1 - p0, iterations=iters)
    per_rank = ctl.gather(dict(peak=peak, busy_s=summary["busy_s"] if summary else None,
                               window_s=traced.get("window_s")))
    build_s = system.build_s
    n_pix = raw.width * raw.height
    del system
    if world > 1:
        import torch.distributed as dist

        dist.destroy_process_group()
    if rank != 0:
        return None

    # ---- the check, after the program's state is freed ----
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    g = tr.check_draws(seed)
    n_calls = len(recs)
    picks = sorted(g.choice(n_calls - 1, size=min(int(cell["check"]["calls"]) - 1, n_calls - 1),
                            replace=False).tolist()) + [n_calls - 1]
    ys, xs = pix
    ref = ref_scene.build(raw, device)
    work = ref_paths.new_work() if trace else None
    worst, failed = 0.0, 0
    limit = float(cell["check"]["limits"]["pixels_off_pct"])
    for i, k in enumerate(picks):
        r = recs[k]
        ref_sum = check.reference_sums(
            ref, raw.use_gpu, ys, xs, r["before"], r["after"] - r["before"],
            assured=raw.assured_depth, max_bounces=raw.max_bounces,
            work=work if i == 0 else None).cpu().numpy()
        sums, slack = check.program_sums(r["pix"], r["after"], None if r["first"] else r["prev"],
                                         r["before"])
        off = check.pixels_off_pct(sums, ref_sum, slack)
        _log(f"[check] call {k} (samples {r['before']}..{r['after'] - 1}): pixels off "
             f"{off:.4f}% of {len(ys)}")
        worst = max(worst, off)
        failed += off > limit
    check_s = time.perf_counter() - t_check
    _log(f"[check] {len(picks)} calls in {check_s:.2f} s")
    _smi("after")

    # ---- the metrics ----
    scale = n_pix / len(ys) / world  # the checked pixels' work -> a rank's call
    ctx = dict(
        times=times, window_s=window_s, setup_s=setup_s, batch=traffic.batch, pixels=n_pix,
        world=world, build_s=build_s, summary=summary, traced=traced,
        work=None if work is None else _scaled(work, scale),
        scene=dict(n_sph=len(raw.spheres), pixels=n_pix, table_bytes=_table_bytes(ref),
                   dls_emitters=len(ref.emitters) if ref.dir_light_samp else 0))
    metrics = {}
    for m in metrics_of(bench, cell_name, trace):
        v = reader(m["name"])(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    bad = forbidden_modules()
    dev = dict(platform="gpu" if device == "cuda" else device,
               kind=torch.cuda.get_device_name(0) if device == "cuda" else device,
               count=world, memory_peak_bytes=max(p["peak"] for p in per_rank))
    if trace:
        dev.update(busy_s=sum(p["busy_s"] for p in per_rank) / world,
                   window_s=sum(p["window_s"] for p in per_rank) / world)
    result = dict(correct=(failed == 0 and not bad), attempted=n_calls, failed=failed,
                  metrics=metrics, device=dev)
    if trace:
        from . import trace as trc

        result["breakdown"] = dict(device_ops=trc.top_ops(summary),
                                   idle_gaps=[[k, v] for k, v in summary["idle_gaps"]])
    result["setup_parts"] = setup_parts
    result["check"] = {"pixels_off_pct": {"value": worst, "limit": limit}}
    result["_forbidden"] = bad
    return result


def _scaled(work: dict, s: float) -> dict:
    return {k: ({b: n * s for b, n in v.items()} if isinstance(v, dict) else v * s)
            for k, v in work.items()}


def _table_bytes(ref) -> float:
    if ref.mesh is None:
        return 0.0
    m = ref.mesh
    return float(sum(t.numel() * t.element_size() for t in m["tables"].values())
                 + m["textures"].numel())


# --- the command -----------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(args, world: int, child=None) -> tuple[int, str]:
    """Run `world` ranks of this command; returns (exit code, rank 0's
    last line). A rank that fails ends the others at once."""
    port = _free_port()
    cmd = child or [sys.executable, "-m", "benchmark.run"]
    base = ["--workload", args.workload, "--seed", str(args.seed), "--seconds",
            str(args.seconds), "--trace", str(args.trace), "--world", str(world),
            "--port", str(port), "--t0", repr(T0), "--device", args.device]
    if args.override:
        base += ["--override", args.override]
    procs, out = [], []
    try:
        for r in range(world):
            procs.append(subprocess.Popen(cmd + base + ["--rank", str(r)], cwd=ROOT.parent,
                                          stdout=subprocess.PIPE if r == 0 else subprocess.DEVNULL,
                                          text=True))
        reader_t = threading.Thread(target=lambda: out.extend(procs[0].stdout), daemon=True)
        reader_t.start()
        deadline = time.monotonic() + CHILD_TIMEOUT
        while True:
            codes = [p.poll() for p in procs]
            if any(c not in (None, 0) for c in codes):
                _log(f"[launch] a rank failed: exit codes {codes}")
                return 1, ""
            if all(c == 0 for c in codes):
                reader_t.join(timeout=30)
                return 0, (out[-1].strip() if out else "")
            if time.monotonic() > deadline:
                _log("[launch] the ranks ran past their time")
                return 1, ""
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()


def _emit(result: dict) -> int:
    """Print the result line (stdout) and the check's numbers (stderr, last)."""
    bad = result.pop("_forbidden", [])
    if bad:
        _log(f"[modules] the process holds {bad}: no result")
        return 3
    line = json.dumps(result)
    print(line, flush=True)
    for k, v in result["check"].items():
        _log(f"[check] {k} {v['value']} limit {v['limit']}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank of a multi-card cell (set by `launch`)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    ap.add_argument("--override", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    overrides = json.loads(args.override) if args.override else None

    if args.rank is not None:  # a rank that `launch` started
        res = run_rank(args.workload, args.seed, args.seconds, bool(args.trace), rank=args.rank,
                       world=args.world, device=args.device, port=args.port,
                       t0=args.t0 if args.t0 is not None else T0, overrides=overrides)
        if res is None:
            return 0
        bad = forbidden_modules()
        if bad:
            _log(f"[modules] rank 0 holds {bad}: no result")
            return 3
        res.pop("_forbidden", None)
        print(json.dumps(res), flush=True)
        return 0

    bench = load_bench()
    cell = cell_of(bench, args.workload)
    chips = int(cell["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        _log(f"[device] the cell needs {chips} CUDA device(s); torch.cuda.is_available() is "
             f"{torch.cuda.is_available()}, device_count() {torch.cuda.device_count()}")
        return 2
    if chips == 1:
        return _emit(run_rank(args.workload, args.seed, args.seconds, bool(args.trace),
                              overrides=overrides, bench=bench))
    code, line = launch(args, chips)
    if code or not line:
        return code or 1
    result = json.loads(line)
    result["_forbidden"] = forbidden_modules()
    return _emit(result)


if __name__ == "__main__":
    sys.exit(main())
