"""The comparison that decides `correct`, held against what it must
catch, at a size that a test run holds: the control (the reference in
bfloat16, in the program's place) and the faults a cell can have, planted
under a run of the harness (which skips its look for a card)."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import limits, run
from benchmark.tests.tiny import overrides

CELLS = ["walled-gpu-20000spp", "a380-gpu-10spp", "a380-cpu-10spp"]
REPO = Path(__file__).resolve().parents[2]


def install(fault: str):
    """Break the program's timed path: `unchanged` (a render leaves its
    target as it was), `half` (half of the batch rendered, the sum
    doubled), `altered` (every answer 1% off where it is produced),
    `exchange` (no all-reduce between the ranks), `crash` (rank 1 fails)."""
    from raytrace_tpu_torch.render import renderer as rr

    if fault == "unchanged":
        rr.Renderer.render = lambda self, samples=None, **kw: self.target.mean_image()
        return
    if fault == "exchange":
        torch.distributed.all_reduce = lambda *a, **kw: None
        return
    if fault == "crash":
        init = rr.Renderer.__init__

        def crashing(self, *a, **kw):
            if torch.distributed.is_initialized() and torch.distributed.get_rank() == 1:
                raise RuntimeError("a planted failure")
            init(self, *a, **kw)
        rr.Renderer.__init__ = crashing
        return
    init = rr.Renderer.__init__

    def broken(self, *a, **kw):
        init(self, *a, **kw)
        step = self._step

        def half(*args, n_samples, **kws):
            k = max(1, n_samples // 2)
            return step(*args, n_samples=k, **kws) * (n_samples / k)

        def altered(*args, **kws):
            return step(*args, **kws) * 1.01

        self._step = {"half": half, "altered": altered}[fault]
    rr.Renderer.__init__ = broken


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_the_limit(cell):
    limit = run.cell_of(run.load_bench(), cell)["check"]["limits"]["pixels_off_pct"]
    reading = limits.control_reading(run.cell_of(run.load_bench(), cell), 11, "cpu",
                                     overrides(cell))
    assert reading > limit


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", [None, "unchanged", "half", "altered"])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    from raytrace_tpu_torch.render import renderer as rr

    monkeypatch.setattr(rr.Renderer, "__init__", rr.Renderer.__init__)
    monkeypatch.setattr(rr.Renderer, "render", rr.Renderer.render)
    if fault:
        install(fault)
    res = run.run_rank(cell, 77, 0.3, False, device="cpu", overrides=overrides(cell))
    assert res["correct"] == (fault is None), res["check"]


def _four_card_copy(root: Path) -> Path:
    """A copy of the benchmark with a four-card cell of walled added as
    files and an entry: the launcher's path, which no committed cell takes
    yet (PERF.md, Open questions)."""
    shutil.copytree(REPO / "benchmark", root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"].append(dict(name="walled-4", config="walled", traffic="preview-4x4",
                                   chips=4, why="a test"))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    (root / "benchmark" / "traffic" / "preview-4x4.json").write_text(
        json.dumps({"batch": 4, "image_spp": 8}))
    (root / "benchmark" / "workloads" / "walled-4.json").write_text(json.dumps(
        {"check": {"rows": 16, "calls": 3, "limits": {"pixels_off_pct": 2.5}}}))
    return root


def _launch(fault, tmp_path):
    """run.launch of four gloo ranks on the CPU, in the copy; returns its
    (exit code, rank 0's line)."""
    root = _four_card_copy(tmp_path)
    child = None if fault is None else [sys.executable, "-m", "benchmark.tests.fault_rank", fault]
    code = ("import argparse, json, sys\nfrom benchmark import run\n"
            "args = argparse.Namespace(workload='walled-4', seed=5, seconds=0.3, trace=0, "
            f"device='cpu', override={json.dumps(json.dumps(overrides('walled-preview')))})\n"
            f"print(json.dumps(run.launch(args, 4, child={child!r})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True, text=True,
                         timeout=900, env=dict(os.environ, PYTHONPATH=f"{root}:{REPO}"))
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("fault", [None, "exchange", "unchanged", "half", "altered"])
def test_four_ranks_on_the_cpu(fault, tmp_path):
    """Four gloo ranks of a four-card cell: rank 0's line is correct only
    when the batch is summed over every rank."""
    code, line = _launch(fault, tmp_path)
    assert code == 0
    res = json.loads(line)
    assert res["correct"] == (fault is None), res["check"]
    assert res["device"]["count"] == 4


def test_a_failing_rank_ends_the_run(tmp_path):
    code, line = _launch("crash", tmp_path)
    assert code != 0 and line == ""
