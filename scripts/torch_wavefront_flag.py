#!/usr/bin/env python3
"""How often the port's graphed wavefront reads its flag, measured on the card.

    python3 scripts/torch_wavefront_flag.py

`raytrace_tpu_torch/render/wavefront.Lanes` replays its step's CUDA
graph (STEP_ITERATIONS iterations) and reads the any-lane-active flag
after each replay, so the device waits for the host between steps.
This script holds that loop (k1) against three others on the a380-class
1216x608 frame in cpu semantics at 16 samples (the Renderer's one batch of render(16), its
lane pool of 131,072): a flag read every 2 and every 4 replays (k2, k4)
and a flag read one replay behind, the next replay already queued
(lagged). A replay on a drained pool is a no-op, so every loop gives the
same image and device counts, bitwise; the extra replays still launch
mesh_hit. Prints, in turns k1, lagged, k2, k4, k4, k2, lagged, k1, each
batch's wall ms (host clock, ending in a sync), its replays and mesh_hit
launches; then k1 once more with CUDA events around each replay (the
sum of the replays' device spans against the batch's wall: the rest is
the host between replays and the batch's start and sum; and the host's
time inside the replay calls, the graph's launch), then the same batch
as the Renderer renders it (render(16) into a fresh target: the batch,
its copy to the host, the target's add and the mean image) in turns with
k1's run, k1 timed again, and, on a drained pool, a replay's device ms (CUDA events over
100 back to back) and its wall ms with a flag read after each. Each
turn's line carries the clocks, power, temperature and clock event
reasons that nvidia-smi sampled every 100 ms while it ran (Clocks). With the card's name and
power limit. Needs a CUDA card and nvcc.

The turns were written when a replay was one iteration; the step of
STEP_ITERATIONS iterations a replay supersedes the k2 and k4 turns (here
they read the flag once every 2 and 4 steps).
"""
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TURNS = ("k1", "lagged", "k2", "k4", "k4", "k2", "lagged", "k1")
RUNS = 3  # batches a turn
REPLAYS = 100


class Clocks:
    """nvidia-smi's SM and memory clocks (MHz), power draw (W),
    temperature (C) and clock event reasons (a bitmask), sampled every 100
    ms while the `with` block runs; `str()` gives the medians and ranges
    and the reasons seen."""

    FIELDS = "clocks.sm,clocks.mem,power.draw,temperature.gpu,clocks_event_reasons.active"

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={self.FIELDS}", "--format=csv,noheader,nounits",
             "-lms", "100"], stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=10)
        rows = [line.split(", ") for line in out.splitlines()]
        self.rows = [r for r in rows if len(r) == 5]

    def __str__(self):
        if not self.rows:
            return "clocks not sampled"
        import numpy as np

        values = np.array([[float(v) for v in r[:4]] for r in self.rows]).T
        parts = [f"{name} {np.median(v):.0f} ({v.min():.0f}-{v.max():.0f})" for name, v in
                 zip(("SM MHz", "memory MHz", "W", "C"), values)]
        return ", ".join(parts) + f", reasons {sorted({r[4] for r in self.rows})}"


def variants():
    import torch

    from raytrace_tpu_torch.render import wavefront as wf

    class Every(wf.Lanes):
        """A flag read every k replays."""
        k = 1

        def _loop(self, step, sample_base):
            self._start(sample_base)
            while bool(self.flag):
                for _ in range(self.k):
                    step()
            return self._image()

    class Lagged(wf.Lanes):
        """The flag of replay n read once replay n + 1 is queued."""

        def _loop(self, step, sample_base):
            self._start(sample_base)
            if bool(self.flag):
                host = torch.zeros((2,), dtype=torch.bool).pin_memory()
                done = [torch.cuda.Event(), torch.cuda.Event()]
                n = 0
                while True:
                    step()
                    host[n % 2].copy_(self.flag, non_blocking=True)
                    done[n % 2].record()
                    if n:
                        done[(n - 1) % 2].synchronize()
                        if not bool(host[(n - 1) % 2]):
                            break
                    n += 1
            return self._image()

    class Timed(wf.Lanes):
        """k1 with CUDA events around each replay, and the host's seconds
        inside each replay call (the graph's launch)."""
        spans, host_s = [], 0.0

        def _replay(self):
            if self.graph is None:
                return super()._replay()
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            t0 = time.perf_counter()
            super()._replay()
            self.host_s += time.perf_counter() - t0
            b.record()
            self.spans.append((a, b))

    def every(k):
        return type(f"Every{k}", (Every,), {"k": k})

    return {"k1": wf.Lanes, "k2": every(2), "k4": every(4), "lagged": Lagged,
            "k1 timed": Timed}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_wavefront_flag: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from raytrace_tpu_torch.models import procedural
    from raytrace_tpu_torch.ops import mesh_kernel as mk
    from raytrace_tpu_torch.render.renderer import Renderer

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    scheme = procedural.a380_scheme(1216, 608, 16)
    scheme.render_info.use_gpu = False
    r = Renderer(scheme, device="cuda")
    args = (r.tables, r.params, r._xs, r._ys, 16, r.width, r.pool)
    pools = {name: cls(*args) for name, cls in variants().items()}
    replays = {}
    for name, lanes in pools.items():
        real = lanes._replay

        def counted(real=real, name=name):
            replays[name] += 1
            real()

        lanes._replay = counted
        replays[name] = 0
        lanes.run(0)  # captures the graph
    ref, ref_stats = None, None
    walls = {}
    for name in TURNS:
        lanes = pools[name]
        with Clocks() as clocks:
            for _ in range(RUNS):
                replays[name] = 0
                mk.LAUNCHES["mesh_hit"] = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                img = lanes.run(0)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                walls.setdefault(name, []).append(ms)
                stats = lanes.stats()
                if ref is None:
                    ref, ref_stats = img, stats
                assert torch.equal(img, ref) and stats == ref_stats, f"{name}: differs"
        print(f"[flag] {name}: {', '.join(f'{w:.3f}' for w in walls[name][-RUNS:])} ms wall, "
              f"{stats['iterations']} iterations, {replays[name]} replays, "
              f"{mk.LAUNCHES['mesh_hit']} mesh_hit launches; {clocks} [{card}]", flush=True)
    for name, v in walls.items():
        print(f"[flag] {name}: median {np.median(v):.3f} ms of {len(v)} batches, image and stats "
              f"bitwise k1's [{card}]", flush=True)

    def timed(when):
        lanes = pools["k1 timed"]
        for _ in range(RUNS):
            lanes.spans, lanes.host_s = [], 0.0
            with Clocks() as clocks:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                img = lanes.run(0)
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
            spans = sum(a.elapsed_time(b) for a, b in lanes.spans)
            assert torch.equal(img, ref)
            print(f"[flag] k1 timed ({when}): {ms:.3f} ms wall, {len(lanes.spans)} replays "
                  f"spanning {spans:.3f} ms of the device ({spans / len(lanes.spans):.4f} a "
                  f"replay), the rest {ms - spans:.3f} ms; the host inside the replay calls "
                  f"{lanes.host_s * 1e3:.3f} ms; {clocks} [{card}]", flush=True)

    timed("before the Renderer's capture")
    from raytrace_tpu_torch.render.target import RenderTarget

    r.render(progress=False, samples=16)  # the Renderer's own lanes and graph
    whole = {}
    for kind in ("run", "render", "render", "run"):
        with Clocks() as clocks:
            for _ in range(RUNS):
                r.target = RenderTarget(r.width, r.height)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if kind == "run":
                    pools["k1"].run(0)
                else:
                    r.render(progress=False, samples=16)  # ends in the mean image on the host
                torch.cuda.synchronize()
                whole.setdefault(kind, []).append((time.perf_counter() - t0) * 1e3)
        print(f"[flag] {kind}: {', '.join(f'{w:.3f}' for w in whole[kind][-RUNS:])} ms; "
              f"{clocks} [{card}]", flush=True)
    print(f"[flag] in turns: Lanes.run {np.median(whole['run']):.3f} ms, Renderer.render(16) "
          f"{np.median(whole['render']):.3f} ms (medians of {2 * RUNS}) [{card}]", flush=True)
    timed("after it")

    lanes = pools["k1"]  # drained: every replay a no-op
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with Clocks() as clocks:
        torch.cuda.synchronize()
        start.record()
        for _ in range(REPLAYS):
            lanes.graph.replay()
        end.record()
        end.synchronize()
        t0 = time.perf_counter()
        for _ in range(REPLAYS):
            lanes.graph.replay()
            bool(lanes.flag)
        wall = (time.perf_counter() - t0) * 1e3 / REPLAYS
    print(f"[flag] a replay on a drained pool: {start.elapsed_time(end) / REPLAYS:.4f} ms of "
          f"device time back to back, {wall:.4f} ms wall with a flag read after each; {clocks} "
          f"[{card}]",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
