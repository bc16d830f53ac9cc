"""The benchmark's plain reference against the program's CPU path at a
tiny size, and what the benchmark's processes import."""
from __future__ import annotations

import dataclasses
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
                                         ("a380-cpu", "a380-cpu-10spp"),
                                         ("walled-cpu-dls", "walled-cpu-dls-16spp"),
                                         ("a380-cpu-dls", "a380-cpu-dls-10spp"),
                                         ("biplane", "biplane-gpu-200spp"),
                                         ("biplane", "biplane-cpu")])
def test_reference_equals_the_program_on_the_cpu(config, cell):
    """The program's batch sums (Renderer.render on the CPU: the fused
    kernels' plain versions, the wavefront's eager loop, with direct-light
    sampling's shadow rays where the configuration turns it on, and the
    sky the program decoded from the faces' files where it has one: at
    the fused kernels' misses, in the wavefront's resolve with
    `biplane-cpu`) equal the reference's on every pixel, bit for bit,
    on a resumed target. In a sky scene the sky shows: without it most
    pixels' sums differ."""
    from benchmark.system import System

    raw = _raw(config, cell)
    system = System(raw, "cpu")
    start, n = 123_456_789, 3
    system.new_image(start)
    img = system.render(n)
    ys, xs = tr.row_pixels(np.arange(raw.height), raw.width)
    sums_of = lambda scene: check.reference_sums(
        ref_scene.build(scene, "cpu"), raw.use_gpu, ys, xs, start, n,
        assured=raw.assured_depth, max_bounces=raw.max_bounces).numpy()
    ref = sums_of(raw)
    prog = system.renderer.target.acc.reshape(raw.height, raw.width, 3)
    assert np.array_equal(prog.reshape(-1, 3), ref)
    sums, slack = check.program_sums(img, system.count, None, start)
    assert check.pixels_off_pct(sums, ref, slack) == 0.0
    assert (ref > 0).mean() > 0.005  # the frame is not black
    assert (raw.sky is not None) == (config == "biplane")
    if raw.sky is not None:
        assert (sums_of(dataclasses.replace(raw, sky=None)) != ref).any(axis=1).mean() > 0.5


def test_work_counts():
    """The counts the rooflines divide: every lane-bounce has one kind,
    walk tests only where a mesh is, near roots only in the fused form,
    shadow rays, and rays that reach their emitter, only where direct-light
    sampling casts them: walled's two lights, not a380's sun, which is its
    one sphere and whose hits cast no ray; pending hits only where it is
    on. Turning it on leaves the other counts of a path that casts nothing
    as they were. Sky fetches only in a sky scene, one a miss in the fused
    form, of every face whose uv scales are not (1, 1), so that the check
    holds their arithmetic; the same scene without its sky fetches nothing
    and counts the rest alike."""
    counts = {}
    for config, cell, fused in (("a380", "a380-gpu-10spp", True),
                                ("a380-cpu", "a380-cpu-10spp", False),
                                ("walled", "walled-gpu-20000spp", True),
                                ("walled-cpu", "walled-cpu-16spp", False),
                                ("walled-cpu-dls", "walled-cpu-dls-16spp", False),
                                ("a380-cpu-dls", "a380-cpu-dls-10spp", False),
                                ("biplane", "biplane-gpu-200spp", True),
                                ("biplane", "biplane-cpu", False)):
        raw = _raw(config, cell)
        work = paths.new_work()
        n_rows = 4 if raw.sky is None else raw.height  # a sky scene's every face
        ys, xs = tr.row_pixels(np.arange(n_rows), raw.width)
        sums = lambda scene, work: check.reference_sums(
            ref_scene.build(scene, "cpu"), raw.use_gpu, ys, xs, 7, 2, assured=raw.assured_depth,
            max_bounces=raw.max_bounces, work=work)
        sums(raw, work)
        counts[config] = work
        assert work["paths"] == 2 * n_rows * raw.width
        assert sum(work["by_branch"].values()) == work["lane_bounces"] >= work["paths"]
        assert (work["tri"] > 0) == bool(raw.primitives) == (work["slab"] > 0)
        assert work["near_roots"] > 0 if config == "walled" else fused or not work["near_roots"]
        casts = config == "walled-cpu-dls"
        assert (work["shadow_rays"] > 0) == (work["dls_hits"] > 0) == casts
        assert work["dls_hits"] <= work["shadow_rays"] <= 2 * work["dls_pending"]
        assert work["dls_pending"] < work["lane_bounces"]
        if not config.endswith("-dls"):
            assert work["dls_pending"] == 0
        fetches = work["sky_fetches"]
        if raw.sky is None:
            assert set(fetches.values()) == {0}
            continue
        assert not fused or sum(fetches.values()) == work["by_branch"]["miss"]
        scaled = [f for f, sc in zip(paths.FACES, raw.sky["scales"]) if sc != (1.0, 1.0)]
        assert scaled and all(fetches[f] > 0 for f in scaled), fetches
        bare = paths.new_work()
        sums(dataclasses.replace(raw, sky=None), bare)
        assert bare == dict(work, sky_fetches={f: 0 for f in paths.FACES})
    a380 = {k: v for k, v in counts["a380-cpu-dls"].items() if k != "dls_pending"}
    assert a380 == {k: v for k, v in counts["a380-cpu"].items() if k != "dls_pending"}
    off, on = counts["walled-cpu"], counts["walled-cpu-dls"]
    assert {k: on[k] for k in ("paths", "lane_bounces", "by_branch")} == \
        {k: off[k] for k in ("paths", "lane_bounces", "by_branch")}


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
    """Nor do the mesh and sky kinds that make its inputs."""
    mods = _modules(
        "from benchmark import scenes, check\nfrom benchmark.reference import scene\n"
        "from benchmark.tests.tiny import overrides\n"
        "for c in ('a380', 'biplane'):\n"
        "    raw = scenes.raw_scene(dict(scenes.load_config(c), **overrides(c)['config']))\n"
        "    check.reference_sums(scene.build(raw, 'cpu'), True, [0], [0], 0, 1, assured=5, "
        "max_bounces=24)")
    assert "torch" in mods
    assert not mods & {*FORBIDDEN, "raytrace_tpu_torch"}


def test_the_program_decodes_the_sky_texel_for_texel(tmp_path, monkeypatch):
    """The sky pool that the program's build_scene decodes from the faces'
    files that system.py writes holds grid_faces' faces texel for texel,
    face after face in the upstream's order, with their sizes and uv
    scales; the files are gone once the scene is built."""
    import tempfile

    from benchmark.system import System

    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    cfg = dict(scenes.load_config("biplane"), width=8, height=4,
               mesh=overrides("biplane")["config"]["mesh"])
    raw = scenes.raw_scene(dict(cfg, sky=dict(cfg["sky"], size=130)))
    system = System(raw, "cpu")
    assert list(tmp_path.iterdir()) == [] and system.sky_written_s > 0
    scene = system.renderer.scene
    faces = raw.sky["faces"].numpy()
    assert faces.shape == (6, 130, 130, 3) and len({f.tobytes() for f in faces}) == 6
    assert faces[2][64].max() <= 16 + 23 < faces[2][65].max()  # a grid line, and a row beside it
    pool = scene.sky_pool.astype(np.int64)  # one u32 a texel, R | G << 8 | B << 16
    texels = np.stack([pool & 0xFF, (pool >> 8) & 0xFF, (pool >> 16) & 0xFF], axis=-1)
    assert np.array_equal(texels, faces.reshape(-1, 3))
    assert scene.cm_offsets.tolist() == [i * 130 * 130 * 3 for i in range(6)]
    assert scene.cm_dims.tolist() == [[130, 130]] * 6
    assert scene.cm_uv_scales.tolist() == [[1, 1], [1, 1], [1, 1], [-1, 1], [0.75, -1.25], [1, 1]]
