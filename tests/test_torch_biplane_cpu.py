"""biplane in cpu semantics (the benchmark's `biplane-cpu` configuration)
through the port's normal path on the CPU, against the benchmark's plain
reference: the wavefront's miss record and the sky's term at the retire,
bit for bit, and the port's count of the sky's fetches against the
reference's; and the reader of the cell's (`biplane-cpu-200spp`)
bounce_shade share with the sky, on synthetic traces."""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest

from benchmark import check, run, scenes, trace
from benchmark import traffic as tr
from benchmark.reference import paths
from benchmark.reference import scene as ref_scene
from benchmark.tests.tiny import overrides

CELL, CONFIG = "biplane-cpu-200spp", "biplane-cpu"
START = 1_987_654_321  # a resumed target's count, near the top of the sample ids
N = 3


def _system(config: str, drop_sky: bool = False):
    """The tiny configuration's System on the CPU, its target resumed at
    START; with drop_sky, the built Renderer's cube map dropped."""
    from benchmark.system import System

    raw = scenes.raw_scene(dict(scenes.load_config(config), **overrides(config)["config"]))
    system = System(raw, "cpu")
    if drop_sky:
        tables = system.renderer.tables
        tables.sky = None
        tables.mesh.sky = None
    system.new_image(START)
    return raw, system


@pytest.fixture(scope="module")
def frame():
    """render(N) of the tiny biplane-cpu frame (64x32, 600 triangles,
    16^2 faces) and the reference's sums and work on every pixel."""
    raw, system = _system(CONFIG)
    img = system.render(N)
    ys, xs = tr.row_pixels(np.arange(raw.height), raw.width)
    work = paths.new_work()
    ref = check.reference_sums(ref_scene.build(raw, "cpu"), raw.use_gpu, ys, xs, START, N,
                               assured=raw.assured_depth, max_bounces=raw.max_bounces,
                               work=work).numpy()
    return SimpleNamespace(raw=raw, system=system, img=img, ref=ref, work=work)


def test_the_cell_is_biplane_in_cpu_semantics():
    """The cell's files by their names: biplane's configuration with the
    CPU backend's semantics and its source, one whole 200-spp image a
    call, and the per-layer metrics a traced run reports."""
    bench = run.load_bench()
    cell = run.cell_of(bench, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (CONFIG, "image-200spp", 1)
    assert cell["check"]["rows"] == 16 and cell["check"]["calls"] == 3
    assert tr.load_traffic("image-200spp") == {"batch": 200, "image_spp": 200}
    gpu, cpu = scenes.load_config("biplane"), scenes.load_config(CONFIG)
    assert {k for k in gpu if gpu[k] != cpu.get(k)} == {"source", "recorded", "use_gpu"}
    assert set(cpu) == set(gpu) and cpu["use_gpu"] is False and cpu["reduced"] == []
    assert cpu["recorded"][:-1] == gpu["recorded"][:-1] and "293 s" in cpu["recorded"][-1]
    names = {m["name"] for m in run.metrics_of(bench, CELL, True)}
    assert names == {"mesh_hit_roofline", "wavefront.assign_pct",
                     "wavefront.kernels_per_iteration", "wavefront.idle_us_per_iteration",
                     "device.idle_pct", "scene.build_s", "bounce_shade_sky_roofline"}
    assert "bounce_shade_sky_roofline" not in {m["name"] for m in run.metrics_of(
        bench, "walled-cpu-16spp", True)}


def test_the_port_equals_the_reference(frame):
    """Renderer.render on the CPU (the wavefront's eager loop, the sky's
    term added from the miss record at the retire) on a target resumed at
    START: its batch sums equal integrator_paths' on every pixel, bit for
    bit, and the check reads 0.0; the frame is lit and its paths fetch
    both faces whose uvs are scaled."""
    assert frame.system.driver == "wavefront"
    prog = frame.system.renderer.target.acc.reshape(-1, 3)
    assert np.array_equal(prog, frame.ref)
    got, slack = check.program_sums(frame.img, frame.system.count, None, START)
    assert check.pixels_off_pct(got, frame.ref, slack) == 0.0
    assert (frame.ref > 0).any(axis=1).mean() > 0.5
    assert frame.work["sky_fetches"]["pos_x"] > 0 and frame.work["sky_fetches"]["neg_y"] > 0


def test_without_the_sky_the_check_fails(frame):
    """The planted fault: the built Renderer's cube map dropped, so the
    paths that leave the scene add nothing. Most pixels differ, the check
    reads far above the cell's limit, and nothing fetched the sky."""
    _, system = _system(CONFIG, drop_sky=True)
    img = system.render(N)
    prog = system.renderer.target.acc.reshape(-1, 3)
    assert (prog != frame.ref).any(axis=1).mean() > 0.5
    got, slack = check.program_sums(img, system.count, None, START)
    limit = run.cell_of(run.load_bench(), CELL)["check"]["limits"]["pixels_off_pct"]
    assert check.pixels_off_pct(got, frame.ref, slack) > 10 * limit
    assert system.renderer.stats["sky_fetches"] == 0


def test_sky_fetches_are_the_reference_count(frame):
    """Renderer.stats["sky_fetches"] (the wavefront's device count) is the
    reference's count of the same paths' fetches, over every face; a
    scene without a sky counts none."""
    stats = frame.system.renderer.stats
    assert stats["sky_fetches"] == sum(frame.work["sky_fetches"].values()) > 0
    assert stats["lane_bounces"] == frame.work["lane_bounces"]
    _, walled = _system("walled-cpu")
    walled.render(1)
    assert walled.renderer.driver == "wavefront"
    assert walled.renderer.stats["sky_fetches"] == 0 < walled.renderer.stats["lane_bounces"]


def test_the_cell_runs_on_the_cpu():
    """A run of the cell at the tiny size, with a large seed: no checked
    call off, its check 0.0, its end-to-end metrics reported; traced, the
    readers of its per-layer metrics find no device and report nothing
    but the host's clock around the scene's build."""
    seed = 2**31 + 4_000_037
    res = run.run_rank(CELL, seed, 0.2, False, device="cpu", overrides=overrides(CELL))
    assert res["failed"] == 0 and res["check"]["pixels_off_pct"]["value"] == 0.0
    assert set(res["metrics"]) == {"setup_s", "mpaths_per_s", "update_ms_p95"}
    res = run.run_rank(CELL, seed, 0.2, True, device="cpu", overrides=overrides(CELL))
    assert res["failed"] == 0 and set(res["metrics"]) == {"scene.build_s"}


# --- the reader, on synthetic traces --------------------------------------

SHADE = "void (anonymous namespace)::bounce_shade_kernel(BounceArgs)"
HIT = "void (anonymous namespace)::mesh_hit_kernel<16>(MeshHitArgs)"


def _summary(shade_us=20.0, hit_us=50.0, iterations=4, calls=2):
    """`calls` calls of `iterations` iterations each: a mesh_hit and a
    bounce_shade launch back to back, then a 10 us gap."""
    dev, t = [], 0.0
    for _ in range(calls):
        for _ in range(iterations):
            for name, us in ((HIT, hit_us), (SHADE, shade_us)):
                dev.append((name, t, t + us))
                t += us
            t += 10.0
    return trace.summarize(dev, [])


def _work(lane_bounces=1_000_000, fetches=700_000):
    br = {"miss": 0.7, "diffuse": 0.02, "mirror": 0.0, "dielectric": 0.0, "roulette": 0.01,
          "mesh": 0.27}
    faces = dict(zip(paths.FACES, (0.1, 0.3, 0.1, 0.2, 0.2, 0.1)))
    return dict(lane_bounces=lane_bounces, paths=lane_bounces * 3 // 4, near_roots=0, slab=0,
                tri=0, by_branch={b: lane_bounces * br[b] for b in paths.BRANCHES},
                sky_fetches={f: fetches * faces[f] for f in paths.FACES})


def _ctx(summary, work=None, calls=2, table_bytes=1e7):
    return dict(summary=summary, work=_work() if work is None else work,
                scene=dict(n_sph=1, pixels=1200 * 600, table_bytes=table_bytes),
                traced=dict(calls=calls, iterations=8))


def test_bounce_shade_sky_roofline_arithmetic():
    """The bound by the reader's documented counts: bounce_shade_roofline's
    meshless branches, the mesh hit's 179 and 3 more draws a lane-bounce
    of a mesh scene, SKY_INSTR a fetch; the meshless bytes plus the mesh
    hit's and the miss record's. Over bounce_shade's time a traced call."""
    work = _work()
    br, lb, n = work["by_branch"], work["lane_bounces"], sum(work["sky_fetches"].values())
    ops = (br["miss"] * 22 + br["roulette"] * 41 + br["diffuse"] * 103 + br["mirror"] * 70
           + br["dielectric"] * 93 + br["mesh"] * 179 + lb * 3 + n * 46)
    nbytes = (lb * (126 + 24 + 4) + (br["diffuse"] + br["mirror"] + br["dielectric"]
                                     + br["mesh"]) * 24
              + br["mesh"] * 12 + work["paths"] * 20 + 57 + n * 24)
    bound = max(ops / 33.5e12, nbytes / 3.35e12)
    read = run.reader("bounce_shade_sky_roofline")
    assert read(_ctx(_summary())) == pytest.approx(100 * bound / 80e-6)
    # a meshless scene: no draws or gid read added
    flat = max((ops - lb * 3) / 33.5e12, (nbytes - lb * 4) / 3.35e12)
    assert read(_ctx(_summary(), table_bytes=0.0)) == pytest.approx(100 * flat / 80e-6)


def test_bounce_shade_sky_roofline_yardstick_is_the_reference_work():
    """The share moves with bounce_shade's time alone: not with another
    kernel's, nor with how its time splits into launches; nothing where
    the work fetched no sky, bounce_shade did not run, or no work was
    counted."""
    read = run.reader("bounce_shade_sky_roofline")
    base = read(_ctx(_summary()))
    assert 0.0 < base < 100.0
    assert read(_ctx(_summary(shade_us=50.0))) == pytest.approx(base * 20.0 / 50.0)
    assert read(_ctx(_summary(hit_us=500.0))) == pytest.approx(base)
    assert read(_ctx(_summary(shade_us=10.0, hit_us=25.0, iterations=8))) == pytest.approx(base)
    assert read(_ctx(_summary(), work=_work(fetches=0))) is None
    no_key = {k: v for k, v in _work().items() if k != "sky_fetches"}
    assert read(_ctx(_summary(), work=no_key)) is None
    assert read(_ctx(trace.summarize([(HIT, 0.0, 50.0)], []))) is None
    assert read(dict(_ctx(_summary()), work=None)) is None
    assert read(_ctx(None)) is None
