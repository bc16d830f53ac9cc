"""The wavefront's iteration over static buffers (`wavefront.Lanes`), and
its step of STEP_ITERATIONS of them, the body the card captures as a
CUDA graph and the CPU runs eagerly: a step on a drained pool changes
nothing, steps of 1, 2 and 8 iterations are bitwise one another, one
pool reused over batches is bitwise fresh calls (the first sample id is
a device buffer), the device's iteration and lane-bounce counts are the
loop's live iterations, the dense sky resolve is bitwise the gather
form, and on a card the graph's replays are bitwise the eager loop. Cases: walled in cpu
semantics, the 2,097-triangle surface in cpu semantics with direct-light
sampling (mesh_hit and the shadow rays), outdoor spheres under a sky in
cpu semantics.

The refill (`bounce_kernel.lanes_assign`): its plain version bitwise the
torch assign it was factored from (kept below) on lane states built by
hand, with the counts it took over; on the card the entry bitwise its
plain version on in-render states, the graphed render bitwise the graph
with the plain assign in its place, and a replay's kernels counted by the
profiler. No JAX: the card tests run where the JAX package does not
(`python -m pytest --noconftest -m cuda tests/test_torch_wavefront_graph.py`)."""
import copy
import gc
import weakref

import numpy as np
import pytest
import torch

from raytrace_tpu_torch.models import procedural
from raytrace_tpu_torch.models.config import ModelMember
from raytrace_tpu_torch.models.walled import walled_scheme
from raytrace_tpu_torch.ops import bounce_kernel as bk
from raytrace_tpu_torch.ops import mesh_kernel as mk
from raytrace_tpu_torch.ops import raygen, rng
from raytrace_tpu_torch.render import wavefront as wf
from raytrace_tpu_torch.render.integrator import resolve_sky, resolve_sky_dense
from raytrace_tpu_torch.render.renderer import Renderer

W, H, N_SAMPLES, POOL = 32, 16, 2, 256
CASES = ("cpu", "dls-mesh", "sky")


def _scheme(case, face_dir):
    """walled ("cpu"), outdoor spheres under a sky ("sky"), the
    2,097-triangle surface with direct-light sampling ("dls-mesh") or
    without ("mesh")."""
    if case == "cpu":
        return walled_scheme(W, H, assured=2)
    if case == "sky":
        return procedural.outdoor_scheme(procedural.sky_cubemap(str(face_dir), size=16), W, H)
    s = procedural.a380_cam_scheme(W, H)
    s.scene_members.append(ModelMember(path="<2,097-triangle surface>",
                                       loaded=[procedural.make_mesh(2097, n_textures=0)]))
    s.render_info = copy.copy(s.render_info)
    s.render_info.rad_info = copy.copy(s.render_info.rad_info)
    s.render_info.rad_info.dir_light_samp = case == "dls-mesh"
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
    """A whole step (STEP_ITERATIONS iterations) on a drained pool."""
    r = _renderer(case, tmp_path)
    lanes = _lanes(r)
    lanes.run(0)
    assert not bool(lanes.flag) and int(lanes.q) == lanes.n_work
    before = [b.clone() for b in _buffers(lanes)]
    stats = lanes.stats()
    lanes._step()
    for a, b in zip(before, _buffers(lanes)):
        assert torch.equal(a, b)
    assert lanes.stats() == stats


def _batch_at(r, k):
    """A fresh pool's batch at sample id 3 through steps of k iterations:
    its image, stats() and buffers; the flag read once a step (steps: the
    live iterations over k, rounded up)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(wf, "STEP_ITERATIONS", k)
        lanes = _lanes(r)
        img = lanes.run(3)
        stats = lanes.stats()
        assert lanes.steps == -(-stats["iterations"] // k)
        return img, stats, [b.clone() for b in _buffers(lanes)]


@pytest.fixture(scope="module")
def one_iteration_a_step(tmp_path_factory):
    """case -> (its Renderer, _batch_at(renderer, 1)), made once a case."""
    made = {}

    def get(case):
        if case not in made:
            r = _renderer(case, tmp_path_factory.mktemp(case))
            made[case] = r, _batch_at(r, 1)
        return made[case]

    return get


@pytest.mark.parametrize("k", (1, 2, 8))
@pytest.mark.parametrize("case", CASES)
def test_k_iterations_a_step_are_bitwise_one(case, k, one_iteration_a_step):
    """A batch through steps of k iterations against steps of one, each on
    a fresh pool: the image, stats() and every buffer bitwise; at k = 8
    the pool drains mid-step. Batches over one pool: below."""
    r, (img, stats, bufs) = one_iteration_a_step(case)
    img_k, stats_k, bufs_k = _batch_at(r, k)
    assert torch.equal(img, img_k) and stats == stats_k
    for a, b in zip(bufs, bufs_k):
        assert torch.equal(a, b)
    if k == 8:
        assert stats["iterations"] % k


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
    """The device counts the iterations that found a live lane; the loop
    runs whole steps, so it calls the iteration fewer than
    STEP_ITERATIONS times more."""
    r = _renderer(case, tmp_path)
    lanes = _lanes(r)
    calls, live, active = [0], [0], [0]
    body = lanes._iteration

    def counted():
        calls[0] += 1
        n = int(lanes.st["active"].sum())
        live[0] += n > 0
        active[0] += n
        body()

    lanes._iteration = counted
    lanes.run(3)
    assert lanes.stats() == {"iterations": live[0], "lane_bounces": active[0]}
    assert calls[0] == wf.STEP_ITERATIONS * lanes.steps
    assert 0 <= calls[0] - live[0] < wf.STEP_ITERATIONS
    assert live[0] > 1 and active[0] >= r.width * r.height * N_SAMPLES


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


# --- the refill -----------------------------------------------------------------


def _parent_assign(self, new):
    """Lanes._assign as it was before lanes_assign, verbatim (the counts
    were added at the next iteration's start)."""
    st, where = self.st, torch.where
    n_work, n_pix = self.n_work, self.n_pix
    need = ~new["active"]
    ranks = torch.cumsum(need.to(torch.int64), 0)
    ids = self.q + ranks - 1
    valid = need & (ids < n_work)
    self.q.copy_(torch.clamp(self.q + ranks[-1], max=n_work))
    ids = ids.clamp(0, max(n_work - 1, 0))
    pix = ids % n_pix
    x, y = self.xs[pix], self.ys[pix]
    state0, ro0, rd0 = raygen.generate_paths(
        rng.init_state(x, y, self.sample_base + ids // n_pix), x, y, self.scene.cam,
        self.scene.has_lens, self.params.generator)
    z, one = self.zeros, self.ones
    fresh = dict(ro=ro0, rd=rd0, L=(z, z, z), ci=(one, one, one), inten=one, rng=state0,
                 bounce=torch.zeros_like(st["bounce"]))
    if self.sky:  # a fresh work unit must not inherit a miss record (:287-288)
        fresh.update(miss_d=(z, z, z), miss_w=(z, z, z))
    for k, v in fresh.items():
        for out, a, b in zip(wf._leaves((st[k],)), wf._leaves((v,)), wf._leaves((new[k],))):
            where(valid, a, b, out=out)
    if self.dls:  # nor a pending direct-light term
        torch.logical_and(new["dls"]["active"], ~valid, out=st["dls"]["active"])
    where(valid, ids, self.unit, out=self.unit)
    torch.logical_or(new["active"], valid, out=st["active"])
    self.flag.copy_(st["active"].any())


# the refill's states: (scheme case, Renderer keywords, share of dead lanes,
# where q stands: "start" 0, "mid" a third of the way, "short" fewer work
# units left than dead lanes)
ASSIGN_STATES = {
    "none-dead": ("cpu", {}, 0.0, "mid"),
    "all-dead": ("cpu", {}, 1.0, "start"),
    "queue-runs-out": ("cpu", {}, 0.5, "short"),
    "sky": ("sky", {}, 0.4, "mid"),
    "dls": ("dls-mesh", {}, 0.4, "mid"),
    "pcg": ("cpu", dict(generator="pcg"), 0.4, "mid"),
    "lens": ("lens", {}, 0.4, "mid"),
}


def _hand_state(lanes, dead, g):
    """A lane state of random values (every float field, stream, bounce
    count, flag and unit drawn) with `dead` of its lanes dead."""
    n = lanes.pool
    st = wf._clone(lanes.st)
    for t in wf._leaves(st):
        if t.dtype == torch.float32:
            t.copy_(torch.from_numpy(g.normal(size=n).astype(np.float32)))
        elif t.dtype == torch.bool:
            t.copy_(torch.from_numpy(g.uniform(size=n) < 0.5))
        elif t.dtype == torch.int32:
            t.copy_(torch.from_numpy(g.integers(0, 6, n).astype(np.int32)))
        else:
            t.copy_(torch.from_numpy(g.integers(0, 1 << 32, n)))
    st["active"].copy_(torch.from_numpy(g.uniform(size=n) >= dead))
    return st


def _assign_pair(case, tmp_path, src):
    """Two Lanes on one hand-built state (q, sample_base, units and counts
    included), and the source states the refill reads: the buffers
    themselves, or a separate tree (as Lanes._torch_iteration hands it)."""
    kind, kw, dead, where = ASSIGN_STATES[case]
    if kind == "lens":
        scheme = walled_scheme(W, H, assured=2)
        scheme.cam.lens_r = 0.15
        r = Renderer(scheme, device="cpu", mode="cpu", samples_per_launch=2)
    else:
        r = Renderer(_scheme(kind, tmp_path), device="cpu", mode="cpu", samples_per_launch=2,
                     **kw)
    g = np.random.default_rng(sorted(ASSIGN_STATES).index(case))
    pair = [_lanes(r), _lanes(r)]
    base = _hand_state(pair[0], dead, g)
    new = _hand_state(pair[0], dead, g) if src == "separate" else None
    n_dead = int((~(base if new is None else new)["active"]).sum())
    q = {"start": 0, "mid": pair[0].n_work // 3, "short": pair[0].n_work - n_dead // 2}[where]
    unit = torch.from_numpy(g.integers(0, pair[0].n_work, pair[0].pool))
    for lanes in pair:
        for dst, v in zip(wf._leaves(lanes.st), wf._leaves(base)):
            dst.copy_(v)
        lanes.unit.copy_(unit)
        lanes.q.fill_(q)
        lanes.sample_base.fill_(7)
        lanes.iters.fill_(3)
        lanes.lane_bounces.fill_(1000)
    srcs = [lanes.st if new is None else wf._clone(new) for lanes in pair]
    return pair, srcs, n_dead, q


@pytest.mark.parametrize("src", ("buffers", "separate"))
@pytest.mark.parametrize("case", sorted(ASSIGN_STATES))
def test_assign_plain_version_is_the_torch_assign(case, src, tmp_path):
    """assign_reference (lanes_assign on CPU tensors) against the torch
    assign it was factored from: every buffer, unit, q and flag bitwise;
    iters and lane_bounces raised by the lanes active after the refill."""
    (old, new), (src_old, src_new), n_dead, q = _assign_pair(case, tmp_path, src)
    fresh = ~src_new["active"]  # the dead lanes, refilled if the queue lasts
    pending = src_new["dls"]["active"].clone() if "dls" in src_new else None
    _parent_assign(old, src_old)
    new._assign(src_new)
    for a, b in zip(wf._leaves(old.st), wf._leaves(new.st)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b in ((old.unit, new.unit), (old.q, new.q), (old.flag, new.flag)):
        assert torch.equal(a, b)
    active = int(new.st["active"].sum())
    assert int(new.iters) == 3 + int(active > 0) and int(new.lane_bounces) == 1000 + active
    n_fresh = min(n_dead, new.n_work - q)
    assert int(new.q) == min(q + n_dead, new.n_work) and active == new.pool - n_dead + n_fresh
    assert {"none-dead": n_dead == 0, "all-dead": n_fresh == new.pool,
            "queue-runs-out": 0 < n_fresh < n_dead}.get(case, 0 < n_fresh == n_dead)
    fresh &= new.st["active"]
    if "miss_d" in new.st:  # the refilled lanes' miss records are cleared
        assert all(bool((t[fresh] == 0).all()) for t in new.st["miss_w"] + new.st["miss_d"])
    if "dls" in new.st:  # and their pending direct-light terms
        assert bool(pending[fresh].any())
        assert not bool(new.st["dls"]["active"][fresh].any())


def test_assign_args_follow_the_cu_struct():
    """ops/bounce_kernel.AssignArgs lays out csrc/bounce_kernel.cu's
    AssignArgs field by field (an array [k] as k fields, the camera row
    as one)."""
    import re
    from pathlib import Path

    src = (Path(bk.__file__).parent.parent / "csrc" / "bounce_kernel.cu").read_text()
    body = re.search(r"struct AssignArgs \{(.*?)\};", src, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    names = []
    for decl in filter(str.strip, body.split(";")):
        decl = re.sub(r"^\s*(const\s+)?(unsigned\s+)?(long long|\w+)\s*", "", decl)
        for part in decl.split(","):
            m = re.fullmatch(r"\s*\**\s*(\w+)(?:\[(\d+)\])?\s*", part)
            n = int(m.group(2) or 0)
            names += ([m.group(1)] if not n or m.group(1) == "cam"
                      else [f"{m.group(1)}{c}" for c in range(n)])
    assert names == [k for k, _ in bk.AssignArgs._fields_]


def test_lanes_assign_refuses_other_devices(tmp_path):
    r = _renderer("cpu", tmp_path)
    lanes = _lanes(r)
    meta = lanes.unit.to("meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        bk.lanes_assign(r.tables, r.params, lanes.st, lanes.st, meta, lanes.xs, lanes.ys,
                        lanes.n_work, (lanes.q, lanes.sample_base, lanes.iters,
                                       lanes.lane_bounces, lanes.flag))


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


@pytest.mark.cuda
def test_capture_outlasts_a_graph_freed_by_the_collector(tmp_path):
    """On the card: a dead reference cycle that holds another Lanes (and its
    CUDA graph) becomes garbage inside a capture, with the cyclic collector
    set to run every few allocations: the capture runs with the collector
    off, so the other graph is destroyed after it (destroying a graph while
    this thread captures would invalidate the capture), and the batch is
    bitwise a fresh pool's."""
    _card()
    r = _renderer("cpu", tmp_path, "cuda")
    thresholds = gc.get_threshold()
    gc.collect()
    gc.freeze()  # the process's objects out of the collector's way
    gc.collect()  # and out of the oldest generation's count, which gates its collections
    try:
        old = _lanes(r)
        old.run(0)  # captures its graph
        doomed = [[old]]
        doomed[0].append(doomed[0])  # a cycle: only the collector frees it
        gone = weakref.ref(old)
        del old
        lanes, freed_in_capture = _lanes(r), []
        real = lanes._iteration

        def iteration():
            capturing = torch.cuda.is_current_stream_capturing()
            if capturing:
                doomed.clear()
            real()
            if capturing:
                freed_in_capture.append(gone() is None)

        lanes._iteration = iteration
        gc.set_threshold(1, 1, 1)
        img = lanes.run(0)
        gc.set_threshold(*thresholds)
        gc.collect()
        assert freed_in_capture and not any(freed_in_capture)
        assert gone() is None and lanes.graph is not None
    finally:
        gc.set_threshold(*thresholds)
        gc.unfreeze()
    assert torch.equal(img, _lanes(r).run(0))


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: lanes_assign builds with nvcc and runs on the card")


def _entry_renderer(case, face_dir):
    """The card's Renderer of an entry case: the a380-class frame at 152x76
    (12 blocks of the entry), with direct-light sampling, walled with a
    lens and pcg, outdoor spheres under a sky."""
    kw = {}
    if case.startswith("a380-class"):
        scheme = procedural.a380_scheme(152, 76)
        scheme.render_info.rad_info.dir_light_samp = case.endswith("DLS")
    elif case == "walled lens pcg":
        scheme = walled_scheme(96, 48, assured=2)
        scheme.cam.lens_r = 0.15
        kw = dict(generator="pcg")
    else:
        scheme = procedural.outdoor_scheme(procedural.sky_cubemap(str(face_dir), size=16), 96, 48)
    return Renderer(scheme, device="cuda", mode="cpu", samples_per_launch=2, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ("a380-class", "a380-class DLS", "walled lens pcg", "sky"))
def test_assign_entry_is_its_plain_version(case, tmp_path):
    """On the card: every refill of a batch (the start's all-dead pool, each
    iteration's, the queue running out), the entry against its plain
    version on copies of the state, bitwise: the state read from the
    buffers themselves, and from a separate tree into buffers that hold
    another state."""
    _card()
    r = _entry_renderer(case, tmp_path)
    lanes = wf.Lanes(r.tables, r.params, r._xs, r._ys, 2, r.width, r.pool)
    assert lanes.pool > 1024
    real, seen = lanes._assign, {"refills": 0, "short": 0}

    def both(new):
        queue = (lanes.q, lanes.sample_base, lanes.iters, lanes.lane_bounces, lanes.flag)
        other = wf._clone(lanes.st)
        for t in wf._leaves(other):
            t.copy_(t.flip(0))
        for separate in (False, True):
            outs = []
            for fn in (bk.lanes_assign, bk.assign_reference):
                st = wf._clone(other if separate else new)
                src = wf._clone(new) if separate else st
                unit, qs = lanes.unit.clone(), tuple(t.clone() for t in queue)
                n0 = bk.LAUNCHES["lanes_assign"]
                fn(r.tables, r.params, src, st, unit, lanes.xs, lanes.ys, lanes.n_work, qs)
                assert bk.LAUNCHES["lanes_assign"] - n0 == (fn is bk.lanes_assign)
                outs.append([*wf._leaves(st), unit, *qs])
            for a, b in zip(*outs):
                assert a.dtype == b.dtype and torch.equal(a, b)
        seen["refills"] += 1
        seen["short"] += int(lanes.q) + int((~new["active"]).sum()) > lanes.n_work
        real(new)

    lanes._assign = both
    lanes._start(11)
    while bool(lanes.flag):
        lanes._iteration()
    assert seen["refills"] > 3 and seen["short"] > 0


def _steps_of_batches(monkeypatch) -> list:
    """The steps of every batch whose stats() are read from here on (a
    Renderer reads each batch's), in order."""
    steps, real = [], wf.Lanes.stats

    def stats(self):
        steps.append(self.steps)
        return real(self)

    monkeypatch.setattr(wf.Lanes, "stats", stats)
    return steps


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_graphed_render_is_the_plain_assign_graph(case, tmp_path, monkeypatch):
    """On the card: render(4) in batches of 2 through the graph with the
    entry against the same graph with the plain assign captured in its
    place: images bitwise, stats equal, every other launch count equal;
    bounce_shade and lanes_assign launched once an iteration of every
    step (STEP_ITERATIONS a replay), lanes_assign once more a batch."""
    _card()
    out, k = {}, wf.STEP_ITERATIONS
    steps = _steps_of_batches(monkeypatch)
    for kind in ("entry", "plain"):
        if kind == "plain":
            monkeypatch.setattr(bk, "lanes_assign", bk.assign_reference)
        r = _renderer(case, tmp_path, "cuda")
        for counts in (mk.LAUNCHES, bk.LAUNCHES):
            for key in counts:
                counts[key] = 0
        steps.clear()
        img = r.render(progress=False, samples=4)
        assert all(lanes.graph is not None for lanes in r._lanes.values()) and len(steps) == 2
        out[kind] = (img, dict(r.stats), dict(mk.LAUNCHES, **bk.LAUNCHES), sum(steps))
    (img, st, n, n_steps), (img_p, st_p, n_p, n_steps_p) = out["entry"], out["plain"]
    np.testing.assert_array_equal(img, img_p)
    assert st == st_p and n_steps == n_steps_p and n.pop("lanes_assign") == k * n_steps + 2
    assert n_p.pop("lanes_assign") == 0 and n == n_p and n["bounce_shade"] == k * n_steps
    assert 0 <= k * n_steps - st["iterations"] < 2 * k


@pytest.mark.cuda
@pytest.mark.parametrize("case", ("cpu", "mesh"))
def test_graph_replay_kernels_counted_by_the_profiler(case, tmp_path):
    """On the card: the kernels of one replay of a captured step, by
    torch.profiler: the launches the graph holds (the refill's two
    kernels), at most 5 an iteration (walled: bounce_prims, bounce_shade
    and the refill's; the surface: mesh_hit besides), each entry once an
    iteration of the step."""
    _card()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    r = _renderer(case, tmp_path, "cuda")
    r.render(progress=False, samples=2)  # captures the graph
    (lanes,) = r._lanes.values()
    held = sum(lanes.graph_launches.values()) + lanes.graph_launches["lanes_assign"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        lanes.graph.replay()
        torch.cuda.synchronize()
    kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith(("Memcpy", "Memset"))]
    k = wf.STEP_ITERATIONS
    assert len(kernels) == held <= 5 * k, kernels
    assert sum("lanes_" in name for name in kernels) == 2 * k
    assert all(n == k for n in lanes.graph_launches.values()), lanes.graph_launches
