"""The readers of the program's spans (benchmark/spans.py) on a synthetic
run, and the harness on the CPU: a --trace 0 run leaves the recorder off,
and the spans command reports the host's readers."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark import spans

REPO = Path(__file__).resolve().parents[2]


def _records():
    """A run in ns: set-up (the scene build with its clusters, the warm
    call capturing the graph), one window call (two flag reads around a
    launch, the copy, the add, the mean, a new target after it), one
    traced call (a flag read, the copy)."""
    rows = [("scene.build", 0, 1_000_000, None), ("scene.clusters", 100_000, 400_000, 0),
            ("render", 2_000_000, 3_000_000, None), ("wavefront.capture", 2_100_000, 2_600_000, 2),
            ("render", 10_000_000, 20_000_000, None),
            ("render.step", 10_000_000, 15_000_000, 4),
            ("wavefront.flag", 10_000_000, 10_100_000, 5),
            ("wavefront.launch", 10_100_000, 10_150_000, 5),
            ("wavefront.flag", 10_150_000, 14_000_000, 5),
            ("render.copy", 15_000_000, 16_000_000, 4), ("render.add", 16_000_000, 18_000_000, 4),
            ("render.mean", 18_000_000, 19_000_000, 4),
            ("target.new", 20_500_000, 21_000_000, None),
            ("render", 30_000_000, 40_000_000, None),
            ("wavefront.flag", 30_000_000, 36_000_000, 13),
            ("render.copy", 36_000_000, 38_000_000, 13)]
    return [SimpleNamespace(name=n, start=s, end=e, parent=p) for n, s, e, p in rows]


def _context():
    snaps = [{"launches.mesh_hit": 0, "wavefront.iterations": 0},
             {"launches.mesh_hit": 1, "wavefront.iterations": 1},
             {"launches.mesh_hit": 4, "wavefront.iterations": 2},
             {"launches.mesh_hit": 7, "wavefront.iterations": 4}]
    device = [("mesh_hit_kernel", 30_000, 32_000), ("bounce_shade_kernel", 33_000, 35_000),
              ("Memcpy DtoH (Device -> Pageable)", 36_500, 37_000),
              ("trace_tiles_kernel", 41_000, 42_000), ("mesh_hit_kernel", 44_000, 45_000)]
    host = [("cudaMemcpyAsync", 36_400, 37_100), ("cudaMemcpyAsync", 10_010, 10_090),
            ("bench.call", 40_500, 46_000)]
    return spans.context(_records(), snaps, 1, device, host)


def test_context_parts_calls_and_counters():
    ctx = _context()
    assert [s["part"] for s in ctx["spans"]] == ["setup"] * 4 + ["window"] * 9 + ["traced"] * 3
    assert ctx["calls"] == dict(setup=1, window=1, traced=1)
    assert ctx["counters"]["window"] == {"launches.mesh_hit": 3, "wavefront.iterations": 1}
    assert ctx["counters"]["traced"] == {"launches.mesh_hit": 3, "wavefront.iterations": 2}
    assert spans.self_us(ctx["spans"])[4] == pytest.approx(10_000 - 5_000 - 1_000 - 2_000 - 1_000)


def test_each_reader_on_a_synthetic_run():
    ctx = _context()
    got = {name: read(ctx) for name, (_, read) in spans.READERS.items()}
    # add 2 ms + mean 1 ms + the new target 0.5 ms, one window call
    assert got["renderer.host_ms_per_call"] == pytest.approx(3.5)
    assert got["wavefront.launch_ms_per_iteration"] == pytest.approx(0.05)
    # one gap between two kernels in the loop (32-33 ms), over 2 iterations; the
    # gaps next to the flag's copy are the host's, not the graph's
    assert got["wavefront.graph_gap_us_per_iteration"] == pytest.approx(500.0)
    assert got["wavefront.capture_s"] == pytest.approx(0.0005)
    assert got["scene.clusters_s"] == pytest.approx(0.0003)
    assert got["kernels.launches_per_call"] == pytest.approx(3.0)
    # idle 1 + 1.5 + 4 + 2 ms; 40-41 and 42-44 ms lie outside every span
    assert got["device.idle_unspanned_pct"] == pytest.approx(100 * 3.0 / 8.5)
    # each moment of idle under the innermost span then: 35-36.5 ms is 1 ms of
    # the flag read and 0.5 of the copy; 37-41 ms 1 of the copy, 2 of render
    assert spans.idle_by_span(ctx) == pytest.approx(
        {"wavefront.flag": 0.002, "render.copy": 0.0015, "render": 0.002,
         "outside: bench.call": 0.003})
    assert spans.copies_in_spans(ctx) == (1, 1)


def test_readers_find_nothing_where_the_program_recorded_nothing():
    ctx = spans.context([], [{}], 5)
    assert all(read(ctx) is None for _, read in spans.READERS.values())
    # spans but no device trace (a CPU run): the device's readers say nothing
    ctx = spans.context(_records(), [{}] * 4, 1)
    assert spans.graph_gap_us_per_iteration(ctx) is None
    assert spans.idle_unspanned_pct(ctx) is None
    assert spans.host_ms_per_call(ctx) == pytest.approx(3.5)


def _python(code: str, timeout: int = 600):
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=timeout)


def test_a_trace_0_run_leaves_the_recorder_off():
    code = ("import json\nfrom benchmark import run\nfrom benchmark.tests.tiny import overrides\n"
            "from raytrace_tpu_torch.utils import profiling\n"
            "r = run.run_rank('a380-cpu-10spp', 5, 0.3, False, device='cpu', "
            "overrides=overrides('a380-cpu-10spp'))\n"
            "print(json.dumps([r['correct'], profiling.enabled(), len(profiling.records()), "
            "{k: v for k, v in profiling.counters().items() if not k.startswith('launches.')}]))")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, False, 0, {}]


def test_the_spans_command_reports_the_host_readers_on_the_cpu():
    code = ("import json\nfrom benchmark import spans\nfrom benchmark.tests.tiny import overrides\n"
            "from raytrace_tpu_torch.utils import profiling\n"
            "r = spans.run_cell('a380-cpu-10spp', 6, 0.5, device='cpu', "
            "overrides=overrides('a380-cpu-10spp'))\n"
            "r.pop('_forbidden')\nprint(json.dumps([r, profiling.enabled()]))")
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    res, on = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] and not on
    m = res["metrics"]
    assert {"renderer.host_ms_per_call", "wavefront.launch_ms_per_iteration",
            "scene.clusters_s", "scene.build_s"} <= set(m)
    assert m["scene.clusters_s"]["value"] < m["scene.build_s"]["value"]
    assert "wavefront.capture_s" not in m  # the CPU loop captures no graph
    assert res["spans"]["calls"]["window"] == res["attempted"]
