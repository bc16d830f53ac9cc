"""Wavefront path tracing with lane regeneration.

Port of `raytrace_tpu/render/wavefront.py::wavefront_batch` (:61-300).
A fixed pool of lanes runs the integrator's bounce, and every iteration
(`Lanes._iteration`):

  1. one bounce for the whole pool (the same formulas and the same
     per-(pixel, sample) streams as `trace_paths`): the sphere /
     free-triangle hit (`ops/bounce_kernel.bounce_prims`), the mesh hit
     (`mesh_hit`), with direct-light sampling each emitter's shadow rays
     (in a scene without mesh triangles inside bounce_prims' own launch,
     whose hit is then the merged one; in a mesh scene through the same
     two, a launch of each an emitter), then the shading
     (`bounce_kernel.bounce_shade`, which also does step 2); the CUDA
     kernels on the card, the integrator's pieces (`prims_hit`,
     `merge_mesh`, `shadow_ray`, `shade_step`) on the CPU;
  2. the per-lane bounce cap kills lanes at max_depth bounces (and with
     them a pending direct-light term, as trace_paths drops pendings at
     its loop's end); lanes whose path ended retire their radiance, with
     the cube map's term where the path missed (trace_paths' post-loop
     resolve, :212-230, in its dense form `resolve_sky_dense`), and those
     that fetched the sky are counted on the device;
  3. dead lanes take the next work units off a queue counter: ranked by
     a prefix sum over the pool, handed out sample-major over the
     tile-ordered pixel table, seeded from (x, y, sample) and raygen'd
     in place, with a cleared direct-light state and miss record
     (`bounce_kernel.lanes_assign`: its CUDA entry on the card, the torch
     assign on the CPU), and the lanes active after it are counted.

The JAX driver runs that loop as one `lax.while_loop` on the device
(:296). Here the lane state lives in static buffers (`Lanes`), allocated
once per (scene, params, pixel tables, n_samples, width, pool), and
`_iteration` writes every result back into them in place, so its inputs
and outputs keep their addresses. The loop's unit is a step
(`Lanes._step`): STEP_ITERATIONS iterations one after another. On CUDA
tensors one step is captured once as a CUDA graph and replayed; the host
reads one flag (any lane active) after each replay, so it waits on the
device once a step, and counts nothing itself: the iterations,
lane-bounces and sky fetches are counted on the device. An iteration on
a drained pool changes nothing, so the iterations a step runs past the
pool's last live one cost only their kernels' early exits (at most
STEP_ITERATIONS - 1 a batch). Every value that differs between batches
(the first sample id) is a device buffer, written before the batch's
replays. On CPU tensors the same `_step` runs eagerly in the same loop,
so the CPU tests run the body the card captures. A cached `Lanes`
assumes that the scene's tensors keep their storage and its Python
constants (the camera row, the emitters) do not change between calls.

Not ported: `sort_lanes` (measured a loss on the TPU, :105-115), `ablate`
(profiling stubs) and the sky resolve's 8192-lane tiles under `lax.cond`
(a TPU gather trick, :228-248): the sky is sampled on every lane and
kept where a retiring lane missed.

Accumulation is deterministic, without atomics: a retiring lane writes
its radiance into its work unit's own (sample, pixel) slot (each unit
retires exactly once; lanes that do not retire write a discard row), and
the slots are summed over the samples in order, 0, 1, ..., as
`renderer.sample_batch` sums. So two runs, a resumed render, and the
graphed and eager loops are bitwise equal on the card too. The slots
take n_samples * n_pix * 12 bytes.
"""
from __future__ import annotations

import gc
import time

import torch

from ..ops import bounce_kernel as bk
from ..ops import mesh_kernel as mk
from ..utils import profiling
from .integrator import (IntegratorParams, _bounce_step, init_lanes, max_depth, mesh_of,
                         resolve_sky_dense, tracks_miss, uses_dls)

CACHED_LANES = 2  # a render's batch shapes: its full chunk and its last
STEP_ITERATIONS = 8  # the iterations of a step: a graph replay, one flag read after it
_COUNTS = (mk.LAUNCHES, bk.LAUNCHES)  # the launch counts a graph's replays add to


def _leaves(tree):
    """The tensors of a lane-state tree (dicts of tensors, tuples and
    dicts), in a fixed order."""
    for v in (tree.values() if isinstance(tree, dict) else tree):
        if isinstance(v, (dict, tuple)):
            yield from _leaves(v)
        else:
            yield v


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return tuple(_clone(v) for v in tree)
    return tree.clone()


class Lanes:
    """The lane pool of `wavefront_batch` for one (scene, params, pixel
    tables, n_samples, width, pool), in static buffers: the lane state of
    `init_lanes` (`st`), each lane's work unit, the queue counter, the
    (sample, pixel) slots, the batch's first sample id, the device's
    iteration, lane-bounce and sky-fetch counts (`sky_fetches`: the
    retiring lanes that fetched the sky, 0 without one) and the
    any-lane-active flag. On the card the step's CUDA graph is captured
    at the first replay and kept (`graph`, with the kernel launches it
    holds, `graph_launches`: STEP_ITERATIONS iterations' worth, and the
    host seconds of its capture and instantiation, `capture_s`). `steps`
    is the last batch's steps (replays on the card): it launched
    STEP_ITERATIONS * steps iterations, and the launch counts
    (mk.LAUNCHES, bk.LAUNCHES) count every one, those past the pool's
    last live iteration too."""

    def __init__(self, scene, params: IntegratorParams, xs_tab, ys_tab, n_samples: int,
                 width: int, pool: int):
        if params.differentiable:
            raise ValueError("the wavefront does not take a differentiable render")
        self.scene, self.params = scene, params
        self.xs, self.ys = xs_tab, ys_tab
        self.dev = dev = xs_tab.device
        self.n_samples, self.n_pix = n_samples, xs_tab.numel()
        self.n_work = self.n_pix * n_samples
        self.pool = pool
        self.cap = max_depth(params)
        self.dls = uses_dls(scene, params)
        self.sky = tracks_miss(scene, params)
        self.flat = (ys_tab * width + xs_tab).long()
        self.zeros = torch.zeros((pool,), dtype=torch.float32, device=dev)
        self.ones = torch.ones_like(self.zeros)
        self.st = _clone(self._fresh())  # init_lanes shares tensors between fields
        i64 = dict(dtype=torch.int64, device=dev)
        self.unit = torch.zeros((pool,), **i64)
        self.discard = torch.full((pool,), self.n_work, **i64)  # the slots' discard row
        self.q, self.sample_base = torch.zeros((), **i64), torch.zeros((), **i64)
        self.iters, self.lane_bounces = torch.zeros((), **i64), torch.zeros((), **i64)
        self.sky_fetches = torch.zeros((), **i64)
        self.flag = torch.zeros((), dtype=torch.bool, device=dev)
        self.slots = torch.zeros((self.n_work + 1, 3), dtype=torch.float32, device=dev)
        self.shadow = None
        if self.dls:  # each emitter's shadow-ray flags and mesh gids (bounce_shade's input)
            n_emit = len(scene.emitters)
            self.shadow = (
                torch.tensor(scene.emitters, dtype=torch.int32, device=dev),
                torch.zeros((n_emit, pool), dtype=torch.bool, device=dev),
                torch.zeros((n_emit, pool), dtype=torch.int32, device=dev)
                if scene.n_mesh_tris else None)
        self.graph, self.graph_launches, self.capture_s = None, {}, None
        self.steps = 0

    def _fresh(self):
        """The lane state of an empty pool (every lane dead)."""
        z, one = self.zeros, self.ones
        st = init_lanes(self.scene, self.params, (z, z, z), (z, z, one),
                        torch.zeros((self.pool,), dtype=torch.int64, device=self.dev))
        st["active"] = torch.zeros_like(st["active"])
        return st

    def _start(self, sample_base: int):
        """Empty the pool, zero the counters and slots, set the first
        sample id, and hand out the first work units."""
        for buf, v in zip(_leaves(self.st), _leaves(self._fresh())):
            buf.copy_(v)
        for t in (self.unit, self.q, self.iters, self.lane_bounces, self.sky_fetches,
                  self.slots):
            t.zero_()
        self.sample_base.fill_(sample_base)
        self._assign(self.st)

    def _assign(self, new):
        """Write the lane state `new` (the bounce's, or the buffers
        themselves) into the buffers, with the next work units handed to
        every dead lane; advance q, set the flag and count the lanes
        active after it (the next iteration's) into iters and
        lane_bounces."""
        bk.lanes_assign(self.scene, self.params, new, self.st, self.unit, self.xs, self.ys,
                        self.n_work,
                        (self.q, self.sample_base, self.iters, self.lane_bounces, self.flag))

    def _iteration(self):
        """One iteration over the buffers: the bounce's kernels (bounce
        and cap, retire), then assign."""
        st, scene, params = self.st, self.scene, self.params
        # without mesh triangles the shadow rays go in bounce_prims' own launch
        shadow = (st["dls"], *self.shadow[:2]) if self.dls and not scene.n_mesh_tris else None
        prims = bk.bounce_prims(scene, params, st["ro"], st["rd"], st["active"], shadow=shadow)
        mesh = None
        if scene.n_mesh_tris:  # the merged hit first, then each emitter's shadow rays
            mesh = mesh_of(scene, params, st["ro"], st["rd"], prims[5])
            if self.dls:
                _, flags, gids = self.shadow
                for j in range(len(scene.emitters)):
                    d_l, seed = bk.shadow_prims(scene, params, st["dls"], prims, mesh, j,
                                                flags[j])
                    mesh_of(scene, params, st["dls"]["pos"], d_l, seed, gid_out=gids[j])
        bk.bounce_shade(scene, params, st, prims, mesh, self.shadow, self.unit, self.slots,
                        self.cap, self.sky_fetches if self.sky else None)
        self._assign(st)

    def _step(self):
        """STEP_ITERATIONS iterations, one after another on the buffers:
        the body of the card's CUDA graph."""
        for _ in range(STEP_ITERATIONS):
            self._iteration()

    def _torch_iteration(self):
        """The iteration with the bounce in torch (`_bounce_step`, an
        operation a launch), cap and retire as torch operations: the
        reference the tests hold `_iteration`, the bounce's kernels, against.
        No render takes it."""
        st, where = self.st, torch.where
        was_active = st["active"]  # overwritten last, by _assign
        new = _bounce_step(self.scene, self.params, st)
        new["active"] = new["active"] & (new["bounce"] < self.cap)
        if self.dls:
            new["dls"]["active"] = new["dls"]["active"] & new["active"]
        term = was_active & ~new["active"]
        L = new["L"]
        if self.sky:  # a retiring path that missed adds its sky term
            L = resolve_sky_dense(self.scene, L, new["miss_d"], new["miss_w"], term)
            bk.count_fetches(self.sky_fetches, new["miss_w"], term)
        self.slots.index_put_((where(term, self.unit, self.discard),), torch.stack(L, dim=1))
        # a dead lane keeps its state: the bounce leaves every field of
        # such a lane as it was but its stream and the direct-light
        # record, which it rewrites
        new["rng"] = where(was_active, new["rng"], st["rng"])
        if self.dls:
            for k in ("pos", "norm", "ci", "self_idx"):
                for out, a in zip(_leaves((st["dls"][k],)), _leaves((new["dls"][k],))):
                    where(was_active, a, out, out=out)
        self._assign(new)

    def _capture(self):
        """The first replay: one eager step on a side stream (the warm-up
        the capture needs, real iterations of the render, so that every
        step of a batch runs STEP_ITERATIONS of them), then the capture
        of the next with the cyclic garbage collector off, with the kernel
        launches it holds taken back out of mk.LAUNCHES and bk.LAUNCHES
        (they are counted at each replay)."""
        with torch.cuda.device(self.dev):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self._step()
            torch.cuda.current_stream().wait_stream(side)
            before = [dict(counts) for counts in _COUNTS]
            graph = torch.cuda.CUDAGraph()
            # no cyclic collection inside the capture: a dead cycle that
            # holds another CUDA graph (a dropped Renderer's Lanes) would be
            # freed there, and destroying a graph while this thread
            # captures invalidates the capture
            collecting = gc.isenabled()
            gc.disable()
            t0 = time.time_ns()
            try:
                with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                    self._step()
            finally:
                if collecting:
                    gc.enable()
            t1 = time.time_ns()
        self.capture_s = (t1 - t0) / 1e9
        profiling.interval("wavefront.capture", t0, t1)
        self.graph_launches = {k: n - b[k] for counts, b in zip(_COUNTS, before)
                               for k, n in counts.items() if n != b[k]}
        for counts, b in zip(_COUNTS, before):
            counts.update(b)
        self.graph = graph

    def _replay(self):
        if self.graph is None:
            self._capture()
            return
        self.graph.replay()
        for counts in _COUNTS:
            for k in counts.keys() & self.graph_launches.keys():
                counts[k] += self.graph_launches[k]

    def _loop(self, step, sample_base: int) -> torch.Tensor:
        self._start(sample_base)
        self.steps = 0
        if profiling.enabled():
            self._spanned_loop(step)
        else:
            while bool(self.flag):
                step()
                self.steps += 1
        with profiling.span("wavefront.image"):
            return self._image()

    def _spanned_loop(self, step):
        """The loop with each flag read (the host's wait for the launch
        before it) and each launch spanned."""
        span = profiling.span
        while True:
            with span("wavefront.flag"):
                go = bool(self.flag)
            if not go:
                break
            with span("wavefront.launch"):
                step()
            self.steps += 1
        profiling.count("wavefront.launches", self.steps)

    def _image(self) -> torch.Tensor:
        """The slots summed over the samples, by flat pixel."""
        per_sample = self.slots[:self.n_work].view(self.n_samples, self.n_pix, 3)
        acc = torch.zeros((self.n_pix, 3), dtype=torch.float32, device=self.dev)
        for s in range(self.n_samples):  # sample_batch's order
            acc = acc + per_sample[s]
        return torch.empty_like(acc).index_copy_(0, self.flat, acc)

    def run(self, sample_base: int) -> torch.Tensor:
        """The batch from sample id sample_base: the graph's replays on
        the card, the eager loop on the CPU. Returns wavefront_batch's
        image."""
        return self._loop(self._replay if self.dev.type == "cuda" else self._step,
                          sample_base)

    def _run_eager(self, sample_base: int) -> torch.Tensor:
        """`run` by the eager loop on any device: on the card, the
        reference the tests and chip_smoke.py hold the graph's replays
        against, bitwise."""
        return self._loop(self._step, sample_base)

    def stats(self) -> dict:
        """The last batch's {"iterations", "lane_bounces", "sky_fetches"},
        from the device's counts (an iteration counts where a lane was live
        at its start; a sky fetch where a retiring lane's path missed with
        a weight > 0 left), read in one copy; the iterations launched past
        them go to the wavefront.drained_iterations counter."""
        with profiling.span("wavefront.stats"):
            iterations, lane_bounces, sky_fetches = torch.stack(
                (self.iters, self.lane_bounces, self.sky_fetches)).tolist()
        profiling.count("wavefront.iterations", iterations)
        profiling.count("wavefront.lane_bounces", lane_bounces)
        profiling.count("wavefront.sky_fetches", sky_fetches)
        profiling.count("wavefront.drained_iterations",
                        STEP_ITERATIONS * self.steps - iterations)
        return {"iterations": iterations, "lane_bounces": lane_bounces,
                "sky_fetches": sky_fetches}


def wavefront_batch(scene, params: IntegratorParams, xs_tab, ys_tab, sample_base: int,
                    n_samples: int, width: int, pool: int, return_stats: bool = False,
                    cache: dict | None = None):
    """Radiance SUM over sample ids sample_base .. sample_base+n_samples-1
    of every pixel of the (n_pix,) int32 tables xs_tab, ys_tab (dispatch
    order, e.g. 32x32 tiles) on the scene's device. Returns the (n_pix, 3)
    f32 sums indexed by the flat pixel y * width + x (with
    return_stats, also {"iterations", "lane_bounces", "sky_fetches"}: the
    loop's iterations, the lanes active at their starts, summed, and the
    paths that ended at the sky). `cache`: a
    dict that keeps the `Lanes` (and on the card their CUDA graphs)
    between calls, the last CACHED_LANES made; without one, each call
    allocates its own (and captures its graph anew). Raises on a
    differentiable render, as the JAX package's wavefront.supports
    refuses one (:57-58): that tier renders through
    `renderer.sample_batch`."""
    with profiling.span("wavefront.batch"):
        key = (id(scene), params, id(xs_tab), id(ys_tab), n_samples, width, pool)
        lanes = None if cache is None else cache.get(key)
        if lanes is None:  # it holds scene and tables, so their ids stay theirs
            lanes = Lanes(scene, params, xs_tab, ys_tab, n_samples, width, pool)
            if cache is not None:
                cache[key] = lanes
                while len(cache) > CACHED_LANES:
                    cache.pop(next(iter(cache)))
        img = lanes.run(sample_base)
        return (img, lanes.stats()) if return_stats else img
