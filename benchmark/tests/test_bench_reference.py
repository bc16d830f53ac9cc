"""The benchmark's plain reference against the program's CPU path at a
tiny size, and what the benchmark's processes import."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark import check, scenes
from benchmark import traffic as tr
from benchmark.reference import paths
from benchmark.reference import scene as ref_scene
from benchmark.tests.tiny import overrides

REPO = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "flax", "raytrace_tpu")


def _raw(config: str, cell: str):
    return scenes.raw_scene(dict(scenes.load_config(config), **overrides(cell)["config"]))


@pytest.mark.parametrize("config,cell", [("walled", "walled-gpu-20000spp"),
                                         ("a380", "a380-gpu-10spp"),
                                         ("a380-cpu", "a380-cpu-10spp")])
def test_reference_equals_the_program_on_the_cpu(config, cell):
    """The program's batch sums (Renderer.render on the CPU: the fused
    kernels' plain versions, the wavefront's eager loop) equal the
    reference's on every pixel, bit for bit, on a resumed target."""
    from benchmark.system import System

    raw = _raw(config, cell)
    system = System(raw, "cpu")
    start, n = 123_456_789, 3
    system.new_image(start)
    img = system.render(n)
    ys, xs = tr.row_pixels(np.arange(raw.height), raw.width)
    ref = check.reference_sums(ref_scene.build(raw, "cpu"), raw.use_gpu, ys, xs, start, n,
                               assured=raw.assured_depth, max_bounces=raw.max_bounces)
    prog = system.renderer.target.acc.reshape(raw.height, raw.width, 3)
    assert np.array_equal(prog.reshape(-1, 3), ref.numpy())
    sums, slack = check.program_sums(img, system.count, None, start)
    assert check.pixels_off_pct(sums, ref.numpy(), slack) == 0.0
    assert (ref.numpy() > 0).mean() > 0.005  # the frame is not black


def test_work_counts():
    """The counts the rooflines divide: every lane-bounce has one kind,
    walk tests only where a mesh is, near roots only in the fused form."""
    for config, cell, fused in (("a380", "a380-gpu-10spp", True),
                                ("a380-cpu", "a380-cpu-10spp", False),
                                ("walled", "walled-gpu-20000spp", True)):
        raw = _raw(config, cell)
        work = paths.new_work()
        ys, xs = tr.row_pixels(np.arange(4), raw.width)
        check.reference_sums(ref_scene.build(raw, "cpu"), raw.use_gpu, ys, xs, 7, 2,
                             assured=raw.assured_depth, max_bounces=raw.max_bounces, work=work)
        assert work["paths"] == 2 * 4 * raw.width
        assert sum(work["by_branch"].values()) == work["lane_bounces"] >= work["paths"]
        assert (work["tri"] > 0) == bool(raw.primitives) == (work["slab"] > 0)
        assert work["near_roots"] > 0 if config == "walled" else fused or not work["near_roots"]


def _modules(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport json, sys\n"
                          "print(json.dumps(sorted(sys.modules)))"], cwd=REPO,
                         capture_output=True, text=True, check=True, timeout=600)
    return {m.split(".")[0] for m in json.loads(out.stdout.strip().splitlines()[-1])}


def test_a_run_loads_no_jax_nor_the_jax_package():
    """A run of a cell (on the CPU, at a tiny size) holds no module whose
    top-level name is jax, jaxlib, flax or raytrace_tpu (raytrace_tpu_torch
    is another name)."""
    mods = _modules(
        "from benchmark import run\nfrom benchmark.tests.tiny import overrides\n"
        "run.run_rank('a380-cpu-10spp', 5, 0.2, True, device='cpu', "
        "overrides=overrides('a380'))")
    assert "raytrace_tpu_torch" in mods
    assert not mods & set(FORBIDDEN)


def test_the_reference_loads_nothing_of_the_program():
    mods = _modules(
        "from benchmark import scenes, check\nfrom benchmark.reference import scene\n"
        "from benchmark.tests.tiny import overrides\n"
        "raw = scenes.raw_scene(dict(scenes.load_config('a380'), **overrides('a380')['config']))\n"
        "check.reference_sums(scene.build(raw, 'cpu'), True, [0], [0], 0, 1, assured=5, "
        "max_bounces=24)")
    assert "torch" in mods
    assert not mods & {*FORBIDDEN, "raytrace_tpu_torch"}
