"""Wavefront path tracing with lane regeneration.

Port of `raytrace_tpu/render/wavefront.py::wavefront_batch` (:61-300).
A fixed pool of lanes runs the integrator's `_bounce_step`, and every
iteration:

  1. one bounce for the whole pool (the same formulas and the same
     per-(pixel, sample) streams as `trace_paths`);
  2. the per-lane bounce cap kills lanes at max_depth bounces (and with
     them a pending direct-light term, as trace_paths drops pendings at
     its loop's end); lanes whose path ended retire their radiance, with
     the cube map's term where the path missed (trace_paths' post-loop
     resolve, :212-230);
  3. dead lanes take the next work units off a queue counter: ranked by
     a prefix sum over the pool, handed out sample-major over the
     tile-ordered pixel table, seeded from (x, y, sample) and raygen'd
     in place, with a cleared direct-light state and miss record.

The loop ends when the queue is drained and the last path has died: its
condition is one `.any()` per iteration, a sync with the host (the
iteration count is in `return_stats`). Not ported: `sort_lanes`
(measured a loss on the TPU, :105-115), `ablate` (profiling stubs) and
the sky resolve's 8192-lane tiles under `lax.cond` (a TPU gather trick,
:228-248): the retiring lanes that missed are gathered (`nonzero`, with
a sky a second sync an iteration) and their sky sampled in one pass.

Accumulation is deterministic, without atomics: a retiring lane writes
its radiance into its work unit's own (sample, pixel) slot (each unit
retires exactly once; lanes that do not retire write a discard row), and
the slots are summed over the samples in order, 0, 1, ..., as
`renderer.sample_batch` sums. So two runs, and a resumed render, are
bitwise equal on the card too. The slots take n_samples * n_pix * 12
bytes.
"""
from __future__ import annotations

import torch

from ..ops import raygen, rng
from .integrator import (IntegratorParams, _bounce_step, init_lanes, max_depth, resolve_sky,
                         tracks_miss, uses_dls)


def wavefront_batch(scene, params: IntegratorParams, xs_tab, ys_tab, sample_base: int,
                    n_samples: int, width: int, pool: int, return_stats: bool = False):
    """Radiance SUM over sample ids sample_base .. sample_base+n_samples-1
    of every pixel of the (n_pix,) int32 tables xs_tab, ys_tab (dispatch
    order, e.g. 32x32 tiles) on the scene's device. Returns the (n_pix, 3)
    f32 sums indexed by the flat pixel y * width + x (with
    return_stats, also {"iterations", "lane_bounces"}: the loop's
    iterations and the lanes active at their starts, summed). Raises on
    a differentiable render, as the JAX package's wavefront.supports
    refuses one (:57-58): that tier renders through
    `renderer.sample_batch`."""
    if params.differentiable:
        raise ValueError("the wavefront does not take a differentiable render")
    dev = xs_tab.device
    n_pix = xs_tab.numel()
    n_work = n_pix * n_samples
    cam, has_lens = scene.cam, scene.has_lens
    cap = max_depth(params)
    dls = uses_dls(scene, params)
    sky = tracks_miss(scene, params)

    zeros = torch.zeros((pool,), dtype=torch.float32, device=dev)
    ones = torch.ones_like(zeros)
    st = init_lanes(scene, params, (zeros, zeros, zeros), (zeros, zeros, ones),
                    torch.zeros((pool,), dtype=torch.int64, device=dev))
    st["active"] = torch.zeros_like(st["active"])
    unit = torch.zeros((pool,), dtype=torch.int64, device=dev)
    q = torch.zeros((), dtype=torch.int64, device=dev)
    slots = torch.zeros((n_work + 1, 3), dtype=torch.float32, device=dev)  # row n_work: discard

    def assign(st, unit, q):
        """Hand the next work units to every dead lane; advance q."""
        need = ~st["active"]
        ranks = torch.cumsum(need.to(torch.int64), 0)
        ids = q + ranks - 1
        valid = need & (ids < n_work)
        q = torch.clamp(q + ranks[-1], max=n_work)
        ids = ids.clamp(0, max(n_work - 1, 0))
        pix = ids % n_pix
        x, y = xs_tab[pix], ys_tab[pix]
        state0, ro0, rd0 = raygen.generate_paths(
            rng.init_state(x, y, sample_base + ids // n_pix), x, y, cam, has_lens,
            params.generator)
        where = torch.where
        st = dict(st, ro=tuple(where(valid, ro0[k], st["ro"][k]) for k in range(3)),
                  rd=tuple(where(valid, rd0[k], st["rd"][k]) for k in range(3)),
                  L=tuple(where(valid, zeros, c) for c in st["L"]),
                  ci=tuple(where(valid, ones, c) for c in st["ci"]),
                  inten=where(valid, ones, st["inten"]), rng=where(valid, state0, st["rng"]),
                  active=st["active"] | valid,
                  bounce=where(valid, torch.zeros_like(st["bounce"]), st["bounce"]))
        if dls:  # a fresh work unit must not inherit a pending direct-light term
            st["dls"] = dict(st["dls"], active=st["dls"]["active"] & ~valid)
        if sky:  # nor a miss record (:287-288)
            for k in ("miss_d", "miss_w"):
                st[k] = tuple(where(valid, zeros, c) for c in st[k])
        return st, where(valid, ids, unit), q

    st, unit, q = assign(st, unit, q)
    iterations, lane_bounces = 0, torch.zeros((), dtype=torch.int64, device=dev)
    while bool(st["active"].any()):
        iterations += 1
        was_active = st["active"]
        lane_bounces = lane_bounces + was_active.sum()
        st = _bounce_step(scene, params, st)
        st["active"] = st["active"] & (st["bounce"] < cap)
        if dls:
            st["dls"]["active"] = st["dls"]["active"] & st["active"]
        term = was_active & ~st["active"]
        L = st["L"]
        if sky:  # a retiring path that missed adds its sky term
            L = resolve_sky(scene, L, st["miss_d"], st["miss_w"], lanes=term)
        slot = torch.where(term, unit, torch.full_like(unit, n_work))
        slots.index_put_((slot,), torch.stack(L, dim=1))
        st, unit, q = assign(st, unit, q)

    per_sample = slots[:n_work].view(n_samples, n_pix, 3)
    acc = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    for s in range(n_samples):  # sample_batch's order
        acc = acc + per_sample[s]
    img = torch.empty_like(acc).index_copy_(0, (ys_tab * width + xs_tab).long(), acc)
    if return_stats:
        return img, {"iterations": iterations, "lane_bounces": int(lane_bounces)}
    return img
