"""Profiling helpers: wall-clock phases, a paths/s meter and a
torch.profiler trace.

Port of `raytrace_tpu/utils/profiling.py`. The reference's observability
is Instant timers and indicatif bars (SURVEY.md section 5): `Phases`
gives the same per-phase wall clock, `Throughput` the render loop's
paths/s, and `trace` wraps torch.profiler (the JAX package's wraps
jax.profiler) for a Chrome trace of the host and the card.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional


class Phases:
    """Accumulates named wall-clock phases; print with report()."""

    def __init__(self):
        self.totals: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] = self.totals.get(name, 0.0) + time.perf_counter() - t0

    def report(self) -> str:
        total = sum(self.totals.values()) or 1.0
        lines = [
            f"  {k:24s} {v:8.2f}s ({100*v/total:4.1f}%)"
            for k, v in sorted(self.totals.items(), key=lambda kv: -kv[1])
        ]
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the block with torch.profiler (the CPU, and the card when
    CUDA is available) and export a Chrome trace (chrome://tracing,
    Perfetto) into log_dir as trace-<pid>-<ns>.json; yields the profiler.
    Does nothing, and yields None, when log_dir is None."""
    if log_dir is None:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


class Throughput:
    """Paths/s meter for render loops."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.paths = 0

    def add(self, n_paths: int):
        self.paths += n_paths

    @property
    def mpaths_per_s(self) -> float:
        dt = time.perf_counter() - self.t0
        return self.paths / dt / 1e6 if dt > 0 else 0.0
