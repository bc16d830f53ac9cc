"""The wavefront's iteration over static buffers (`wavefront.Lanes`), the
body the card captures as a CUDA graph and the CPU runs eagerly: an
iteration on a drained pool changes nothing, one pool reused over
batches is bitwise fresh calls (the first sample id is a device
buffer), the device's iteration and lane-bounce counts are the loop's,
the dense sky resolve is bitwise the gather form, and on a card the
graph's replays are bitwise the eager loop. Cases: walled in cpu
semantics, the 2,097-triangle surface in cpu semantics with direct-light
sampling (mesh_hit and the shadow rays), outdoor spheres under a sky in
cpu semantics. No JAX: the card test runs where the JAX package does not
(`python -m pytest --noconftest -m cuda tests/test_torch_wavefront_graph.py`)."""
import copy

import numpy as np
import pytest
import torch

from raytrace_tpu_torch.models import procedural
from raytrace_tpu_torch.models.config import ModelMember
from raytrace_tpu_torch.models.walled import walled_scheme
from raytrace_tpu_torch.ops import mesh_kernel as mk
from raytrace_tpu_torch.render import wavefront as wf
from raytrace_tpu_torch.render.integrator import resolve_sky, resolve_sky_dense
from raytrace_tpu_torch.render.renderer import Renderer

W, H, N_SAMPLES, POOL = 32, 16, 2, 256
CASES = ("cpu", "dls-mesh", "sky")


def _scheme(case, face_dir):
    if case == "cpu":
        return walled_scheme(W, H, assured=2)
    if case == "sky":
        return procedural.outdoor_scheme(procedural.sky_cubemap(str(face_dir), size=16), W, H)
    s = procedural.a380_cam_scheme(W, H)
    s.scene_members.append(ModelMember(path="<2,097-triangle surface>",
                                       loaded=[procedural.make_mesh(2097, n_textures=0)]))
    s.render_info = copy.copy(s.render_info)
    s.render_info.rad_info = copy.copy(s.render_info.rad_info)
    s.render_info.rad_info.dir_light_samp = True
    return s


def _renderer(case, face_dir, device="cpu"):
    r = Renderer(_scheme(case, face_dir), device=device, mode="cpu", samples_per_launch=2)
    assert r.driver == "wavefront"
    return r


def _lanes(r, n_samples=N_SAMPLES, pool=POOL):
    return wf.Lanes(r.tables, r.params, r._xs, r._ys, n_samples, r.width, pool)


def _buffers(lanes):
    """Every buffer an iteration writes, but the slots' discard row (a
    scratch row that the lanes that do not retire overwrite)."""
    return [*wf._leaves(lanes.st), lanes.unit, lanes.q, lanes.iters, lanes.lane_bounces,
            lanes.flag, lanes.slots[:lanes.n_work]]


@pytest.mark.parametrize("case", CASES)
def test_iteration_on_a_drained_pool_changes_nothing(case, tmp_path):
    r = _renderer(case, tmp_path)
    lanes = _lanes(r)
    lanes.run(0)
    assert not bool(lanes.flag) and int(lanes.q) == lanes.n_work
    before = [b.clone() for b in _buffers(lanes)]
    stats = lanes.stats()
    lanes._iteration()
    for a, b in zip(before, _buffers(lanes)):
        assert torch.equal(a, b)
    assert lanes.stats() == stats


@pytest.mark.parametrize("case", ("cpu", "sky"))
def test_one_pool_over_batches_is_bitwise_fresh_calls(case, tmp_path):
    """One cached Lanes over batches at sample ids 0, 5 and 9 gives what
    three fresh calls give, stats included; a third batch shape evicts
    the oldest pool."""
    r = _renderer(case, tmp_path)
    args = (r.tables, r.params, r._xs, r._ys)
    cache = {}
    for base in (0, 5, 9):
        img, st = wf.wavefront_batch(*args, base, N_SAMPLES, r.width, POOL, return_stats=True,
                                     cache=cache)
        ref, ref_st = wf.wavefront_batch(*args, base, N_SAMPLES, r.width, POOL,
                                         return_stats=True)
        assert torch.equal(img, ref) and st == ref_st
    assert len(cache) == 1
    for n in (1, 3):
        wf.wavefront_batch(*args, 0, n, r.width, POOL, cache=cache)
    assert len(cache) == wf.CACHED_LANES and all(k[4] in (1, 3) for k in cache)


def test_renderer_batches_through_one_pool_are_fresh_calls(tmp_path):
    """render(6, batch=2): three batches through one Lanes, bitwise the
    render whose every batch takes a new one."""
    a, b = _renderer("sky", tmp_path), _renderer("sky", tmp_path)
    a.render(progress=False, samples=6, batch=2)
    assert len(a._lanes) == 1
    for _ in range(3):
        b._lanes.clear()
        b.render(progress=False, samples=2)
    np.testing.assert_array_equal(a.target.acc, b.target.acc)


@pytest.mark.parametrize("case", CASES)
def test_device_counts_are_the_loops(case, tmp_path):
    r = _renderer(case, tmp_path)
    lanes = _lanes(r)
    calls, active = [0], [0]
    body = lanes._iteration

    def counted():
        calls[0] += 1
        active[0] += int(lanes.st["active"].sum())
        body()

    lanes._iteration = counted
    lanes.run(3)
    assert lanes.stats() == {"iterations": calls[0], "lane_bounces": active[0]}
    assert calls[0] > 1 and active[0] >= r.width * r.height * N_SAMPLES


def test_dense_sky_resolve_is_the_gather(tmp_path):
    """resolve_sky_dense against resolve_sky(lanes=) on lanes that resolve,
    lanes that missed but do not retire, lanes that never missed (miss_d
    0: their sky must be looked up at a unit direction, not at 0/0)."""
    r = _renderer("sky", tmp_path)
    scene = r.tables
    g, n = np.random.default_rng(7), 4096
    f32 = lambda a: torch.from_numpy(a.astype(np.float32))
    missed = g.uniform(size=n) < 0.5
    L = tuple(f32(g.uniform(0, 2, n)) for _ in range(3))
    md = tuple(f32(np.where(missed, g.normal(size=n), 0.0)) for _ in range(3))
    mw = tuple(f32(np.where(missed, g.uniform(0.05, 1, n), 0.0)) for _ in range(3))
    lanes = torch.from_numpy(g.uniform(size=n) < 0.5)
    real, looked_up = scene.sky.sample, []

    def sample(*d):
        looked_up.append(torch.stack(d))
        return real(*d)

    scene.sky.sample = sample
    try:
        dense = resolve_sky_dense(scene, L, md, mw, lanes)
    finally:
        del scene.sky.sample
    (d,) = looked_up
    assert d.shape == (3, n) and bool(((d * d).sum(0) > 0).all())
    ref = resolve_sky(scene, L, md, mw, lanes=lanes)
    for k in range(3):
        assert torch.equal(dense[k], ref[k])
    resolved = torch.from_numpy(missed) & lanes
    assert 0 < int(resolved.sum()) < n and not torch.equal(dense[0][resolved], L[0][resolved])


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_graph_replays_are_bitwise_the_eager_loop(case, tmp_path):
    """On the card: render(4) through the captured graph against the eager
    loop (Lanes._run_eager), bitwise, with the same stats and mesh_hit
    launches; then three batches through one graph against fresh ones."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the graph is captured on the card)")
    out = {}
    for kind in ("graphed", "eager"):
        r = _renderer(case, tmp_path, "cuda")
        real = wf.Lanes.run
        if kind == "eager":
            wf.Lanes.run = wf.Lanes._run_eager
        try:
            for k in mk.LAUNCHES:
                mk.LAUNCHES[k] = 0
            img = r.render(progress=False, samples=4)
            out[kind] = (img, dict(r.stats), dict(mk.LAUNCHES))
        finally:
            wf.Lanes.run = real
        assert all(lanes.graph is not None for lanes in r._lanes.values()) == (kind == "graphed")
    (img, st, n), (img_e, st_e, n_e) = out["graphed"], out["eager"]
    np.testing.assert_array_equal(img, img_e)
    assert st == st_e and n == n_e and (n["mesh_hit"] > 0) == (case == "dls-mesh")
    a, b = _renderer(case, tmp_path, "cuda"), _renderer(case, tmp_path, "cuda")
    a.render(progress=False, samples=6, batch=2)
    for _ in range(3):
        b._lanes.clear()
        b.render(progress=False, samples=2)
    np.testing.assert_array_equal(a.target.acc, b.target.acc)
