"""The walled scene in cpu semantics (the benchmark's `walled-cpu`
configuration) through the port's normal path on the CPU, against the
benchmark's plain reference, and the per-layer readers of its cell
(`walled-cpu-16spp`) on synthetic traces: the wavefront's idle per
iteration and the bounce entries' roofline shares."""
from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest
import torch

import benchmark
from benchmark import check, run, scenes, trace
from benchmark import traffic as tr
from benchmark.reference import paths
from benchmark.reference import scene as ref_scene
from benchmark.reference.camera import primary
from benchmark.reference.geometry import sphere_roots
from benchmark.tests.tiny import overrides

REPO = Path(__file__).resolve().parents[1]
CELL, CONFIG = "walled-cpu-16spp", "walled-cpu"
START = 1_987_654_321  # a resumed target's count, near the top of the sample ids
# a dielectric sphere around the camera (at o = (0, -1, 0)), clear of the
# scene's spheres: every primary ray leaves it through its far root
AROUND_CAMERA = {"c": [0.0, -1.0, 0.0], "r": 3.0, "rgb": [1, 1, 1],
                 "mat": {"divert_ray": {"Dielectric": {"n_out": 1.0, "n_in": 1.3}}}}


def test_benchmark_is_the_repository_package():
    """`from benchmark import ...` under the tier-1 command finds the
    repository's benchmark/, and the cell's files by their names."""
    assert Path(benchmark.__file__).resolve().parent == REPO / "benchmark"
    bench = run.load_bench()
    cell = run.cell_of(bench, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (CONFIG, "image-16spp", 1)
    assert tr.load_traffic("image-16spp") == {"batch": 16, "image_spp": 16}
    walled, cpu = scenes.load_config("walled"), scenes.load_config(CONFIG)
    # the configuration is walled's with the CPU backend's semantics
    assert {k for k in walled if walled[k] != cpu.get(k)} == {"source", "assumed", "use_gpu"}
    assert cpu["use_gpu"] is False and cpu["assumed"][:2] == walled["assumed"]
    names = {m["name"] for m in run.metrics_of(bench, CELL, True)}
    assert names == {"wavefront.idle_us_per_iteration", "bounce_prims_roofline",
                     "bounce_shade_roofline"}


def test_published_size_takes_the_wavefront():
    """At its published 1200x600 the configuration takes the wavefront's
    driver and its 131,072-lane pool (the Renderer built, nothing rendered)."""
    from benchmark.system import System

    raw = scenes.raw_scene(scenes.load_config(CONFIG))
    system = System(raw, "cpu")
    assert (raw.width, raw.height, raw.use_gpu) == (1200, 600, False)
    assert system.driver == "wavefront"
    assert system.renderer.pool == 1 << 17


@pytest.mark.parametrize("inside", [False, True], ids=["walled", "camera-in-dielectric"])
def test_the_port_equals_the_reference(inside):
    """Renderer.render on the CPU (the wavefront's eager loop) on a target
    resumed at START: its batch sums equal integrator_paths' on every
    pixel, bit for bit, and the check reads 0.0. With a dielectric sphere
    around the camera every primary ray meets it from inside, where the
    CPU backend's least positive root (the far one) is a hit and the GPU
    backend's near root is none."""
    from benchmark.system import System

    cfg = dict(scenes.load_config(CONFIG), **overrides(CELL)["config"])
    if inside:
        cfg["spheres"] = cfg["spheres"] + [AROUND_CAMERA]
    raw = scenes.raw_scene(cfg)
    system = System(raw, "cpu")
    assert system.driver == "wavefront"
    n = int(overrides(CELL)["traffic"]["batch"])
    system.new_image(START)
    img = system.render(n)
    ys, xs = tr.row_pixels(np.arange(raw.height), raw.width)
    ref = ref_scene.build(raw, "cpu")
    sums = check.reference_sums(ref, raw.use_gpu, ys, xs, START, n, assured=raw.assured_depth,
                                max_bounces=raw.max_bounces).numpy()
    prog = system.renderer.target.acc.reshape(-1, 3)
    assert np.array_equal(prog, sums)
    got, slack = check.program_sums(img, system.count, None, START)
    assert check.pixels_off_pct(got, sums, slack) == 0.0
    assert (sums > 0).any(axis=1).mean() > 0.05  # the frame is lit
    if inside:
        samples = torch.full((xs.size,), START, dtype=torch.int64)
        _, o, d = primary(ref.cam, torch.from_numpy(xs), torch.from_numpy(ys), samples,
                          torch.float32, fused=False)
        c = tuple(torch.tensor([[v]]) for v in AROUND_CAMERA["c"])
        r = torch.tensor([[AROUND_CAMERA["r"]]])
        far, near = (sphere_roots(o, d, c, r, m)[0] for m in ("cpu", "gpu"))
        assert bool((far > 2.0).all() & (far < 4.0).all())  # the far root, about r away
        assert bool((near >= 3e38).all())  # the near root lies behind the camera


def test_the_cell_runs_on_the_cpu():
    """A run of the cell at the tiny size: no checked call off, its check
    0.0, its end-to-end metrics reported; the readers of its per-layer
    metrics find no device there and report nothing. (`correct` also asks
    that the process hold no JAX, which this one does: the tests' conftest
    imports it; test_bench_reference.py runs a cell in a process of its own.)"""
    seed = 2**31 + 4_000_037
    res = run.run_rank(CELL, seed, 0.2, False, device="cpu", overrides=overrides(CELL))
    assert res["failed"] == 0 and res["check"]["pixels_off_pct"]["value"] == 0.0
    assert set(res["metrics"]) == {"setup_s", "mpaths_per_s", "update_ms_p95"}
    res = run.run_rank(CELL, seed, 0.2, True, device="cpu", overrides=overrides(CELL))
    assert res["failed"] == 0 and res["metrics"] == {}


# --- the readers, on synthetic traces -------------------------------------

PRIMS = "void (anonymous namespace)::bounce_prims_kernel(BounceArgs)"
SHADE = "void (anonymous namespace)::bounce_shade_kernel(BounceArgs)"
ASSIGN = "void (anonymous namespace)::lanes_assign_kernel(AssignArgs)"


def _summary(prims_us=3.0, shade_us=6.0, assign_us=4.0, iterations=4, calls=2):
    """`calls` calls of `iterations` iterations each: every iteration a
    bounce_prims, a bounce_shade and a lanes_assign launch back to back,
    then a 10 us gap; a call ends in a 20 us copy."""
    dev, t = [], 0.0
    for _ in range(calls):
        for _ in range(iterations):
            for name, us in ((PRIMS, prims_us), (SHADE, shade_us), (ASSIGN, assign_us)):
                dev.append((name, t, t + us))
                t += us
            t += 10.0
        dev.append(("Memcpy DtoH (Device -> Pageable)", t, t + 20.0))
        t += 120.0
    return trace.summarize(dev, [])


def _work(lane_bounces=100_000):
    br = {"miss": 0.2, "diffuse": 0.4, "mirror": 0.1, "dielectric": 0.1, "roulette": 0.2}
    return dict(lane_bounces=lane_bounces, paths=lane_bounces // 4, near_roots=0, slab=0, tri=0,
                by_branch={b: lane_bounces * br.get(b, 0.0) for b in paths.BRANCHES})


def _ctx(summary, work=None, iterations=8, calls=2, times=(0.001,) * 5):
    return dict(summary=summary, work=work if work is not None else _work(),
                scene=dict(n_sph=13, pixels=1200 * 600, table_bytes=0.0),
                traced=dict(calls=calls, iterations=iterations), times=list(times),
                window_s=sum(times))


def test_idle_us_per_iteration_arithmetic():
    s = _summary()  # busy (4 x 13 + 20) us a call
    ctx = _ctx(s, iterations=8, times=[0.0004, 0.0003, 0.0005])
    read = run.reader("wavefront.idle_us_per_iteration")
    # the window's median call 400 us, less 72 us busy, over 4 iterations a call
    assert s["busy_s"] == pytest.approx(2 * 72e-6)
    assert read(ctx) == pytest.approx((400.0 - 72.0) / 4)
    assert read(_ctx(s, iterations=0)) is None  # no iteration ran
    assert read(_ctx(None)) is None
    assert read(_ctx(trace.summarize([], []))) is None  # no device work


def test_bounce_rooflines_arithmetic():
    """The bound from the reference's work by the documented counts, over
    the entry's device time a traced call."""
    work, n_sph = _work(), 13
    s = _summary()
    ctx = _ctx(s, work)
    lb, br = work["lane_bounces"], work["by_branch"]
    prims = max(lb * n_sph * 24 / 33.5e12, (lb * 57 + n_sph * 16) / 3.35e12)
    assert run.reader("bounce_prims_roofline")(ctx) == pytest.approx(100 * prims / 12e-6)
    ops = (br["miss"] * 22 + br["roulette"] * 41 + br["diffuse"] * 103 + br["mirror"] * 70
           + br["dielectric"] * 93)
    nbytes = (lb * 126 + (br["diffuse"] + br["mirror"] + br["dielectric"]) * 24
              + work["paths"] * 20 + n_sph * 57)
    shade = max(ops / 33.5e12, nbytes / 3.35e12)
    assert run.reader("bounce_shade_roofline")(ctx) == pytest.approx(100 * shade / 24e-6)


@pytest.mark.parametrize("name,kernel", [("bounce_prims_roofline", "prims_us"),
                                         ("bounce_shade_roofline", "shade_us")])
def test_bounce_roofline_yardstick_is_the_reference_work(name, kernel):
    """The bound depends on the reference's work and the scene alone: the
    share times the entry's time stays the same when only the entry's time,
    its launch count or another kernel's time moves; nothing where the
    entry did not run or no work was counted."""
    read = run.reader(name)
    base = read(_ctx(_summary()))
    assert 0.0 < base < 100.0
    for kw, scale in (({kernel: {"prims_us": 3.0, "shade_us": 6.0}[kernel] * 2.5}, 1 / 2.5),
                      ({"assign_us": 40.0}, 1.0)):
        assert read(_ctx(_summary(**kw))) == pytest.approx(base * scale)
    # the same device time in twice the launches
    halves = dict(prims_us=1.5, shade_us=3.0, assign_us=2.0, iterations=8)
    assert read(_ctx(_summary(**halves))) == pytest.approx(base)
    # twice the lane-bounces, twice the bound (the sphere columns, read once, aside)
    assert read(_ctx(_summary(), _work(200_000))) == pytest.approx(2 * base, rel=1e-4)
    absent = trace.summarize([(ASSIGN, 0.0, 4.0)], [])
    assert read(_ctx(absent)) is None  # the entry did not run
    assert read(_ctx(_summary(), work=_work(0))) is None  # no lane-bounce counted
    assert read(dict(_ctx(_summary()), work=None)) is None  # an untraced context
    assert read(_ctx(None)) is None
