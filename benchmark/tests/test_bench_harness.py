"""The harness on the CPU: the end-to-end metrics' arithmetic, the trace's
reduction on a synthetic profiler table, the cells, configurations and
metrics found by file name, and the command's refusals."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from benchmark import run, trace

REPO = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def test_rate_over_the_window_and_p95_over_every_call():
    times = [0.010] * 95 + [0.050] * 5
    ctx = dict(times=times, window_s=2.0, batch=10, pixels=1000, setup_s=3.5)
    assert run.reader("mpaths_per_s")(ctx) == pytest.approx(100 * 10 * 1000 / 2.0 / 1e6)
    assert run.reader("update_ms_p95")(ctx) == pytest.approx(np.percentile(times, 95) * 1e3)
    assert run.reader("update_ms_p95")(ctx) > 10.0  # the slow tail counts
    assert run.reader("setup_s")(ctx) == 3.5


def _synthetic():
    """Two calls of 10 ms: a kernel, a device-to-host copy, a gap under the
    host's add (no host event) and one under a stream synchronize."""
    dev = [("void ns::trace_tiles_kernel<false, false>(Launch)", 0, 6000),
           ("Memcpy DtoH (Device -> Pageable)", 6000, 8000),
           ("void ns::trace_tiles_kernel<false, false>(Launch)", 10000, 16000),
           ("Memcpy DtoH (Device -> Pageable)", 16000, 18000),
           ("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
            18000, 18500)]
    host = [("bench.call", 0, 9000), ("cudaStreamSynchronize", 500, 7900),
            ("cudaMemcpyAsync", 5900, 8400), ("bench.call", 9500, 19500)]
    return trace.summarize(dev, host)


def test_idle_share_and_copy_time_from_a_synthetic_table():
    s = _synthetic()
    assert s["busy_s"] == pytest.approx(0.0165)
    assert s["device_s"] == pytest.approx(0.0165)
    ctx = dict(summary=s, traced=dict(calls=2, window_s=0.020, iterations=0),
               times=[0.01] * 10, window_s=0.1)
    # busy 8.25 ms a traced call against 10 ms a call of the window
    assert run.reader("device.idle_pct")(ctx) == pytest.approx(17.5)
    # the first copy's host call ends 0.4 ms after its record, the second lies in none
    assert run.reader("renderer.dtoh_ms_per_call")(ctx) == pytest.approx(2.2)
    assert trace.copies_s(s, trace.DTOH) == pytest.approx(0.004)
    assert run.reader("dist.allreduce_ms_per_call")(ctx) == pytest.approx(0.25)
    assert trace.kernel_s(s, "trace_tiles_kernel") == (pytest.approx(0.012), 2)
    assert trace.kernel_s(s, "trace_tiles") == (0.0, 0)  # a symbol is matched whole
    assert run.reader("wavefront.assign_pct")(ctx) is None  # no wavefront ran
    assert run.reader("wavefront.kernels_per_iteration")(ctx) is None
    assert dict(s["idle_gaps"]) == pytest.approx({"bench.call": 0.002})


def test_roofline_divides_the_reference_work_by_the_kernel_time():
    from benchmark import roofline

    work = dict(lane_bounces=1e9, near_roots=2e9, slab=0, tri=0, paths=1e8,
                by_branch={b: 2e8 for b in ("miss", "diffuse", "mirror", "dielectric",
                                            "roulette")} | {"mesh": 0})
    scene = dict(n_sph=13, pixels=720000, table_bytes=0.0)
    ctx = dict(summary=_synthetic(), work=work, scene=scene, traced=dict(calls=2))
    bound = roofline.call_bound_s("trace_tiles", work, scene)
    assert run.reader("trace_tiles_roofline")(ctx) == pytest.approx(100 * bound / 0.006)
    assert run.reader("mesh_trace_roofline")(ctx) is None  # no mesh_trace ran


def test_new_cell_config_and_metric_are_found_by_their_files(tmp_path):
    """A cell, a configuration, a traffic mix and a per-layer metric added
    as new files plus entries in BENCHMARK.json, without editing any file
    the benchmark has: run in a copy, the new cell renders and reports the
    new metric."""
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    root = tmp_path / "benchmark"
    cfg = json.loads((root / "configs" / "walled.json").read_text())
    cfg.update(width=40, height=20, source="a test's own scene",
               mesh={"kind": "small_surface", "n_tris": 600})
    (root / "configs" / "walled-small.json").write_text(json.dumps(cfg))
    (root / "meshes" / "small_surface.py").write_text(  # a mesh kind of its own
        "from benchmark import scenes\n\n\ndef make(m):\n"
        "    return scenes.mesh_primitives(dict(kind='displaced_sphere', n_tris=m['n_tris'], "
        "n_textures=1, tex_size=8, radius=2.0, seams=20, texture_seed=5, "
        "rgb_factor=[0.5, 0.6, 0.7], metal=0.2, rough=0.5))\n")
    (root / "traffic" / "two-spp.json").write_text(json.dumps({"batch": 2, "image_spp": 2}))
    (root / "workloads" / "walled-small-2spp.json").write_text(json.dumps(
        {"check": {"rows": 4, "calls": 2, "limits": {"pixels_off_pct": 1.0}}}))
    (root / "metrics" / "calls.count.py").write_text(
        "def read(ctx):\n    return float(len(ctx['times']))\n")
    bench["configs"].append(dict(name="walled-small", source="a test", reduced=[],
                                 file="benchmark/configs/walled-small.json", why="a test"))
    bench["workloads"].append(dict(name="walled-small-2spp", config="walled-small",
                                   traffic="two-spp", chips=1, why="a test"))
    bench["end_to_end"].append(dict(name="calls.count", unit="calls", better="higher",
                                    bound=0.1, source="host_clock",
                                    workloads=["walled-small-2spp"]))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json\nfrom benchmark import run\n"
            "r = run.run_rank('walled-small-2spp', 3, 0.3, False, device='cpu')\n"
            "r.pop('_forbidden')\nprint(json.dumps(r))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600, env={"PYTHONPATH": f"{tmp_path}:{REPO}",
                                                       "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["metrics"]["calls.count"]["value"] == res["attempted"] > 0
    assert res["setup_parts"]["scene_s"] > 0  # the mesh made it into the scene
    assert set(res["metrics"]) == {"setup_s", "mpaths_per_s", "update_ms_p95", "calls.count"}
    assert list(res)[-1] == "check"


def test_check_pixels_rows_or_drawn_over_the_frame():
    from benchmark import traffic as tr

    ys, xs = tr.check_pixels(7, 5, {"rows": 2}, 3)
    assert len(ys) == 14 and len(set(ys.tolist())) == 2 and xs.tolist() == list(range(7)) * 2
    ys, xs = tr.check_pixels(1200, 600, {"pixels": 1024}, 3)
    flat = ys * 1200 + xs
    assert len(set(flat.tolist())) == 1024 and (np.diff(flat) > 0).all()
    assert ys.min() < 10 and ys.max() > 590  # one from each band, over the whole frame
    again = tr.check_pixels(1200, 600, {"pixels": 1024}, 3)
    assert (again[0] == ys).all() and (again[1] == xs).all()
    assert not (tr.check_pixels(1200, 600, {"pixels": 1024}, 4)[1] == xs).all()


def test_rad_info_flags_reach_the_program_and_the_reference_refuses_its_gaps():
    """dir_light_samp reaches the program's scheme and the reference's
    scene, with the emissive spheres it aims at; debug_single_ray, which
    the reference does not follow, is refused."""
    from benchmark import scenes
    from benchmark.reference import scene as ref_scene
    from benchmark.system import scheme_of
    from benchmark.tests.tiny import overrides

    raw = scenes.raw_scene(dict(scenes.load_config("walled-cpu-dls"),
                                **overrides("walled")["config"]))
    assert scheme_of(raw).render_info.rad_info.dir_light_samp is True
    ref = ref_scene.build(raw, "cpu")
    assert ref.dir_light_samp and ref.emitters == (7, 8) and ref.mesh is None
    raw.rad_info = {"dir_light_samp": False}
    assert scheme_of(raw).render_info.rad_info.dir_light_samp is False
    assert not ref_scene.build(raw, "cpu").dir_light_samp
    raw.rad_info = {"debug_single_ray": True}
    assert scheme_of(raw).render_info.rad_info.debug_single_ray is True
    with pytest.raises(NotImplementedError, match="debug_single_ray"):
        ref_scene.build(raw, "cpu")
    raw.rad_info = {"a_flag_of_no_scheme": False}
    with pytest.raises(NotImplementedError, match="a_flag_of_no_scheme"):
        ref_scene.build(raw, "cpu")


def test_bounce_bounds_without_shadow_work_are_the_plain_ones():
    """With no pending hit, shadow ray or emitter counted, the bounce
    entries' bounds are the formulas of a render without direct-light
    sampling, to the bit; with it, they add a flag a live lane and the
    pending lanes' records, rays and terms by their documented counts."""
    work = dict(lane_bounces=123_456.7, paths=31_234.5, near_roots=0, slab=0, tri=0,
                dls_pending=0, shadow_rays=0, dls_hits=0,
                by_branch={"miss": 2e4, "diffuse": 5.1e4, "mirror": 1.3e4, "dielectric": 1.7e4,
                           "roulette": 2.2e4, "mesh": 0})
    lb, br, n = work["lane_bounces"], work["by_branch"], 13
    prims = max(lb * n * 24 / 33.5e12, (lb * 57 + n * 16) / 3.35e12)
    ops = (br["miss"] * 22 + br["roulette"] * 41 + br["diffuse"] * 103 + br["mirror"] * 70
           + br["dielectric"] * 93)
    nbytes = (lb * 126 + (br["diffuse"] + br["mirror"] + br["dielectric"]) * 24
              + work["paths"] * 20 + n * 57)
    shade = max(ops / 33.5e12, nbytes / 3.35e12)
    bounds = {m: run.reader(m).__globals__["bound_s"]
              for m in ("bounce_prims_roofline", "bounce_shade_roofline")}
    scene = dict(n_sph=n, pixels=720000, table_bytes=0.0, dls_emitters=0)
    assert bounds["bounce_prims_roofline"](work, scene) == prims
    assert bounds["bounce_shade_roofline"](work, scene) == shade
    dls = dict(work, dls_pending=6e4, shadow_rays=4e4, dls_hits=3e4)
    scene = dict(scene, dls_emitters=2)
    assert bounds["bounce_prims_roofline"](dls, scene) == pytest.approx(max(
        (lb * n * 24 + 6e4 * 2 * 21 + 4e4 * n * 24) / 33.5e12,
        (lb * 57 + n * 16 + lb * 1 + 6e4 * (48 + 2 * 17)) / 3.35e12))
    assert bounds["bounce_shade_roofline"](dls, scene) == pytest.approx(max(
        (ops + 6e4 * 2 * 24 + 3e4 * 6) / 33.5e12, (nbytes + lb * 2 + 6e4 * (80 + 2)) / 3.35e12))
    # nothing pending: DLS costs a live lane its flags alone
    idle = dict(work, dls_pending=0)
    assert bounds["bounce_prims_roofline"](idle, scene) == pytest.approx(
        (lb * 58 + n * 16) / 3.35e12)


def test_fused_bounds_without_a_sky_are_the_plain_ones():
    """trace_tiles' and mesh_trace's bounds of a scene without a sky, its
    counts absent or 0, are the formulas of the bounds without one, to the
    bit; a sky adds SKY_INSTR a fetch, of any face."""
    from benchmark import roofline
    from benchmark.reference import paths

    br = {"miss": 2e4, "diffuse": 5.1e4, "mirror": 1.3e4, "dielectric": 1.7e4, "roulette": 2.2e4,
          "mesh": 3.3e4}
    work = dict(lane_bounces=1.567e5, paths=3.1e4, near_roots=4.4e5, slab=9.1e6, tri=2.3e6,
                by_branch=br)
    scene = dict(n_sph=5, pixels=720000, table_bytes=3.1e8)
    lb = work["lane_bounces"]
    tiles_ops = (lb * 5 * 13 + 4.4e5 * 4 + 2e4 * 3 + 5.1e4 * 66 + 1.3e4 * 32 + 1.7e4 * 35
                 + 2.2e4 * 26 + 3.1e4 * 20)
    tiles = max(tiles_ops / 33.5e12, (5 * 60 + 720000 * 24) / 3.35e12)
    mesh_ops = (lb * 5 * 18 + 9.1e6 * 25 + 2.3e6 * 55 + 3.3e4 * 204
                + (5.1e4 + 1.3e4 + 1.7e4 + 2.2e4) * 93 + 2e4 * 3 + 3.1e4 * 20)
    mesh = max(mesh_ops / 33.5e12, (3.1e8 + 720000 * 24) / 3.35e12)
    for w in (work, dict(work, sky_fetches={f: 0 for f in paths.FACES})):
        assert roofline.call_bound_s("trace_tiles", w, scene) == tiles
        assert roofline.call_bound_s("mesh_trace", w, scene) == mesh
    sky = dict(work, sky_fetches=dict({f: 0 for f in paths.FACES}, pos_z=1.5e4, neg_y=4e3))
    assert roofline.call_bound_s("trace_tiles", sky, dict(scene, pixels=7200)) == \
        pytest.approx((tiles_ops + 1.9e4 * 46) / 33.5e12)
    assert roofline.call_bound_s("mesh_trace", sky, dict(scene, table_bytes=0)) == \
        pytest.approx((mesh_ops + 1.9e4 * 46) / 33.5e12)
    call = run._scaled(dict(paths.new_work(), paths=10, sky_fetches=sky["sky_fetches"]), 100.0)
    assert (call["paths"], call["sky_fetches"]["neg_y"]) == (1000.0, 4e5)


def test_raw_scene_refuses_an_unknown_key():
    """A key of no kind the harness knows (a sky under another name, say)
    is refused, not dropped."""
    from benchmark import scenes

    cfg = scenes.load_config("biplane")
    cfg["skybox"] = cfg.pop("sky")
    with pytest.raises(ValueError, match="skybox"):
        scenes.raw_scene(cfg)


def _command(args, cwd=REPO, env=None):
    return subprocess.run([sys.executable, "-m", "benchmark.run", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=600, env=env)


def test_the_command_needs_cuda():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    out = _command(["--workload", "walled-gpu-20000spp", "--seed", "1", "--seconds", "1",
                    "--trace", "0"])
    assert out.returncode == 2 and out.stdout.strip() == ""


def test_the_command_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark."""
    shutil.copytree(REPO / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    out = _command(["--workload", "a380-gpu-10spp", "--seed", "1", "--seconds", "1", "--trace",
                    "0"], cwd=tmp_path, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    out = _command(["--workload", "walled-gpu-20000spp", "--seed", "4000000001",
                    "--seconds", "2", "--trace", "1"])
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and res["device"]["platform"] == "gpu"
    assert {"renderer.dtoh_ms_per_call", "trace_tiles_roofline"} <= set(res["metrics"])
    assert 0 < res["metrics"]["trace_tiles_roofline"]["value"] <= 100
