"""The span recorder (`utils/profiling.py`) on the CPU: nothing recorded
while it is off; with it on, a render's spans (the batches' step and
add, the mean and its one copy) under one call id, the wavefront's flag reads and
launches, the scene build's phases and the Renderer's tables, the writer
thread's hook on a stack of its own, the counters (the kernels' LAUNCHES
read where they are), self time, the clock torch.profiler's host events
share, and the CLI's --spans file."""
import json
import sys
import threading
import time

import pytest
import torch

from raytrace_tpu_torch import cli
from raytrace_tpu_torch.models import procedural
from raytrace_tpu_torch.models.config import ModelMember
from raytrace_tpu_torch.models.scene import build_scene
from raytrace_tpu_torch.models.walled import walled_scheme
from raytrace_tpu_torch.ops import bounce_kernel as bk
from raytrace_tpu_torch.ops import mesh_kernel as mk
from raytrace_tpu_torch.ops import trace_kernel as tk
from raytrace_tpu_torch.render import wavefront as wf
from raytrace_tpu_torch.render.renderer import Renderer
from raytrace_tpu_torch.utils import profiling


@pytest.fixture
def recorder():
    profiling.reset()
    profiling.enable()
    try:
        yield profiling
    finally:
        profiling.enable(False)
        profiling.reset()


def _named(recs, name):
    return [r for r in recs if r.name == name]


def test_off_records_nothing():
    profiling.reset()
    assert not profiling.enabled()
    assert profiling.span("a") is profiling.span("b", name="x") is profiling.call("render")
    with profiling.span("a") as s:
        assert s is None
    Renderer(walled_scheme(16, 8), device="cpu").render(samples=2, batch=1, progress=False)
    profiling.count("render.calls")
    profiling.interval("x", 0, 1)
    assert profiling.records() == []
    assert not any(k for k in profiling.counters() if not k.startswith("launches."))


def test_render_batches_under_one_call(recorder):
    r = Renderer(walled_scheme(16, 8), device="cpu")
    recorder.reset()
    r.render(samples=3, batch=1, progress=False)
    recs = recorder.records()
    top, = _named(recs, "render")
    assert top.parent is None and top.attrs == dict(samples=3, batch=1, driver=r.driver)
    assert {x.call for x in recs} == {top.call}
    kids = [x.name for x in recs if x.parent == top.index]
    assert kids == ["render.step", "render.add"] * 3 + ["render.mean"]
    mean, = _named(recs, "render.mean")
    assert [x.name for x in mean.children] == ["render.copy"]
    assert all(top.start <= x.start <= x.end <= top.end for x in recs)
    assert recorder.span("kernels.build", name="trace_kernel").attrs == {"name": "trace_kernel"}
    c = recorder.counters()
    assert c["render.calls"] == 1 and c["render.batches"] == 3
    assert c["render.dtoh_bytes"] == 16 * 8 * 3 * 4  # the mean, once
    assert c["target.syncs"] == 0
    r.render(samples=1, progress=False)  # a new call, a new id
    assert _named(recorder.records(), "render")[1].call != top.call


def test_cpu_wavefront_flag_and_launch_a_loop_trip(recorder):
    r = Renderer(walled_scheme(16, 8), device="cpu", mode="cpu")
    assert r.driver == "wavefront"
    recorder.reset()
    r.render(samples=2, batch=1, progress=False)
    recs = recorder.records()
    batches = _named(recs, "wavefront.batch")
    assert len(batches) == 2 and all(recs[b.parent].name == "render.step" for b in batches)
    for b in batches:
        kids = [x.name for x in recs if x.parent == b.index]
        trips = kids.count("wavefront.launch")
        assert kids == ["wavefront.flag", "wavefront.launch"] * trips + \
            ["wavefront.flag", "wavefront.image", "wavefront.stats"]
    c = recorder.counters()
    assert c["wavefront.launches"] == len(_named(recs, "wavefront.launch"))
    # a launch is a step of STEP_ITERATIONS iterations; those past a batch's
    # last live one are counted apart
    launched = wf.STEP_ITERATIONS * c["wavefront.launches"]
    assert c["wavefront.iterations"] == r.stats["iterations"]
    assert launched == c["wavefront.iterations"] + c["wavefront.drained_iterations"]
    assert 0 <= c["wavefront.drained_iterations"] < 2 * wf.STEP_ITERATIONS
    assert c["wavefront.lane_bounces"] == r.stats["lane_bounces"]
    assert not _named(recs, "wavefront.capture")  # the CPU loop captures no graph


def test_launches_are_the_kernels_counts_read_in_place(recorder):
    c = recorder.counters()
    for mod in (tk, mk, bk):
        assert {k: c[f"launches.{k}"] for k in mod.LAUNCHES} == mod.LAUNCHES
    mk.LAUNCHES["mesh_hit"] += 3
    try:
        assert recorder.counters()["launches.mesh_hit"] == c["launches.mesh_hit"] + 3
    finally:
        mk.LAUNCHES["mesh_hit"] -= 3


def test_self_time_is_duration_less_the_childrens_cover(recorder):
    with recorder.span("p"):
        recorder.interval("c1", 10, 30)
        recorder.interval("c2", 20, 50)  # overlaps c1: counted once
        recorder.interval("c3", 90, 120)  # runs past its parent's end
    p = recorder.records()[0]
    p.start, p.end = 0, 100
    assert [c.parent for c in p.children] == [p.index] * 3
    assert recorder.self_ns(p) == 100 - 40 - 10
    assert recorder.self_ns(p.children[0]) == 20


def test_hook_runs_nest_on_the_writer_threads_stack(recorder):
    seen = []
    r = Renderer(walled_scheme(16, 8), device="cpu")
    recorder.reset()
    r.render(samples=3, batch=1, progress=False,
             update_hook=lambda t: (seen.append(t.count), time.sleep(0.01)))
    recs = recorder.records()
    top, = _named(recs, "render")
    runs = _named(recs, "hook.run")
    assert runs and len(runs) == len(seen)
    assert all(x.parent is None and x.tid != top.tid and x.call == top.call for x in runs)
    assert [recs[x.parent].name for x in _named(recs, "render.hook")] == ["render"] * 3


def test_scene_build_phases_and_the_renderers_tables(recorder, tmp_path):
    scheme = walled_scheme(16, 8)
    scheme.scene_members.append(ModelMember(path="<surface>", loaded=[
        procedural.make_mesh(256, n_textures=1, tex_size=8)]))
    scheme.scene_members.append(procedural.sky_cubemap(str(tmp_path), size=8))
    scene = build_scene(scheme)
    Renderer(scheme, device="cpu", scene=scene)
    recs = recorder.records()
    build, = _named(recs, "scene.build")
    assert [x.name for x in recs if x.parent == build.index] == \
        ["scene.meshes", "scene.clusters", "scene.instancing", "scene.sky"]
    init, = _named(recs, "renderer.init")
    assert [x.name for x in recs if x.parent == init.index] == ["target.new", "renderer.tables"]
    assert all(x.call is None for x in recs)  # outside any render call


def test_spans_share_the_profilers_host_clock(recorder):
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recorder.span("outer"):
            time.sleep(0.002)
            with record_function("inner.range"):
                torch.ones(64).sum()
            time.sleep(0.002)
    s, = recorder.records()
    ev, = [e for e in prof.profiler.kineto_results.events() if e.name() == "inner.range"]
    start = ev.start_ns() if hasattr(ev, "start_ns") else ev.start_us() * 1000
    dur = ev.duration_ns() if hasattr(ev, "duration_ns") else ev.duration_us() * 1000
    assert s.start <= start and start + dur <= s.end


def test_cli_spans_flag_writes_the_trace(recorder, tmp_path):
    recorder.enable(False)
    path = tmp_path / "spans.json"
    yml = tmp_path / "s.yml"
    yml.write_text(
        "render_info: {width: 16, height: 8, samps_per_pix: 2,\n"
        "  rad_info: {russ_roull_info: {assured_depth: 3, max_thres: 0.5}}}\n"
        "cam: {d: [0, 0, -5], o: [0, -1, 0], up: [0, 1, 0], screen_width: 10, screen_height: 5}\n"
        "scene_members:\n"
        "- !Sphere {c: [0, 10, -15], r: 5, coloring: !Solid [0, 0, 0],\n"
        "   mat: {divert_ray: Diff, emissive: [5, 5, 5]}}\n")
    cli.main([str(yml), "--device", "cpu", "--out", str(tmp_path / "o.png"), "--spans",
              str(path)])
    assert not recorder.enabled()  # off again after the command
    doc = json.loads(path.read_text())
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"renderer.init", "scene.build", "render", "render.step", "render.copy",
            "render.hook", "hook.run", "render.mean"} <= names
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in doc["traceEvents"])
    ts = [e["ts"] for e in doc["traceEvents"]]
    assert abs(ts[0] / 1e6 - time.time()) < 600  # time.time_ns's scale, in us
    assert doc["counters"]["render.calls"] == 1 and "launches.trace_tiles" in doc["counters"]
    assert cli._rank_path(str(path)) == str(path)  # no process group: the path as given


def test_finished_spans_leave_nothing_for_the_garbage_collector(recorder):
    """A long run's records must not grow the collector's full passes."""
    import gc

    for _ in range(100):
        with recorder.span("a", samples=3):
            with recorder.span("b"):
                pass
    gc.collect()  # a span without attrs at the first pass, one with attrs at the next
    assert not any(gc.is_tracked(v) for n, v in zip(range(200), recorder._spans.values())
                   if v[0] == "b")
    gc.collect()
    assert not any(gc.is_tracked(v) for v in recorder._spans.values())
    assert len(recorder.records()) == 200


def test_spans_of_two_threads_keep_their_own_parents(recorder):
    """Threads opening spans at once: each span's parent is the span its
    own thread had open, and every index is its place in records()."""
    def work(tag):
        for _ in range(200):
            with recorder.span(f"{tag}.outer"):
                with recorder.span(f"{tag}.inner"):
                    pass

    threads = [threading.Thread(target=work, args=(f"t{i}",)) for i in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    recs = recorder.records()
    assert len(recs) == 4 * 200 * 2 and [x.index for x in recs] == list(range(len(recs)))
    for x in recs:
        if x.name.endswith(".inner"):
            assert recs[x.parent].name == x.name.replace("inner", "outer")
            assert recs[x.parent].tid == x.tid
        else:
            assert x.parent is None
