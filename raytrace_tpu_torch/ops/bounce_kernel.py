"""The wavefront's bounce as two CUDA entries, the sphere / free-triangle
hit and the shade-and-retire step, and its refill as a third.

The JAX package runs the integrator's bounce under `jit`: `closest_hit`
(raytrace_tpu/render/integrator.py:219-368), `_shade_hit` (:701-850) and
`_bounce_step` (:857-983) inside the wavefront's `lax.while_loop`
(raytrace_tpu/render/wavefront.py:195-296), which XLA compiles into a
few fused device programs. These entries of `csrc/bounce_kernel.cu`
are the hand-written counterpart, a thread per lane, and one wavefront
iteration on the card is (`render/wavefront.Lanes._iteration`):

    bounce_prims -> [a mesh: mesh_hit] -> [with direct-light sampling,
    each emitter's shadow rays: inside bounce_prims' launch in a scene
    without mesh triangles, else for each emitter bounce_prims on its
    shadow rays -> mesh_hit] -> bounce_shade -> lanes_assign

- `bounce_prims`: the brute nearest hit over every sphere and free
  triangle of the scene's columns (no cap on their counts), in both
  semantics with the cpu guard, and the mesh walk's seed (DEAD_SEED on
  dead lanes). Its plain version is `integrator.prims_hit`. A shadow ray
  is formed by `integrator.shadow_ray`, whose omit test reads this
  bounce's merged hit, and its flag says whether the ray is cast and its
  nearest sphere / free-triangle hit is the emitter. In a scene without
  mesh triangles the sphere / free-triangle hit is the merged hit, so the
  launch that finds it also tests every emitter's shadow ray against it
  (`bounce_prims(..., shadow=)`, counted in LAUNCHES as
  "bounce_prims_dls" besides "bounce_prims"). In a mesh scene the merged
  hit needs `mesh_hit` first, so each emitter's shadow rays are a launch
  of their own (`shadow_prims`), and `bounce_shade` reads their flags
  with the shadow mesh hit's gid.
- `bounce_shade`: the mesh hit merged (`integrator.merge_mesh`), then
  `integrator.shade_step` (the draws, the shading of the three kinds with
  the mesh attributes and texel fetch of `mesh_kernel.mesh_attrs`, the
  gpu or cpu radiance and roulette, the miss record, the direct-light
  terms, debug_single_ray), the bounce cap and the retire (a retiring
  lane's radiance, with `resolve_sky_dense`'s sky term, into its work
  unit's slot, and the retiring lanes that fetched the sky added to a
  device counter), written in place on `Lanes`' buffers. A dead lane keeps
  its whole state, its stream and direct-light record included, so a
  replay on a drained pool changes nothing; the plain version writes
  the slots' discard row, which nothing reads, and the kernel does not.
- `lanes_assign`: the refill of the JAX wavefront's `assign` (:102-150,
  without `sort_lanes`), two launches: each block's dead lanes, then the
  ranks, work ids, seeds and camera rays of the lanes it refills, the
  queue counter, the any-active flag and the device's iteration and
  lane-bounce counts (the lanes active after the refill are the next
  iteration's). Its plain version is `assign_reference`, the port's torch
  assign.

CPU tensors run the plain pieces; CUDA tensors launch the kernel or
raise. The entries are built with -fmad=false (kernels/build.py) and
keep the plain version's order of every sum and product, so on the card
they equal it bitwise. The differentiable tier and `trace_paths` run the
plain pieces only (autograd records them).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..render import integrator as itg
from . import cubemap, raygen, rng

# launches of each CUDA entry point in this process (read by chip_smoke.py)
LAUNCHES = {"bounce_prims": 0, "bounce_shade": 0, "lanes_assign": 0, "bounce_prims_dls": 0}


def _merged(scene, params, prims, mesh):
    hit = prims[:5]
    return hit if mesh is None else itg.merge_mesh(scene, params, None, None, hit, mesh)


def bounce_prims(scene, params, ro, rd, active, shadow=None):
    """The nearest sphere / free-triangle hit of each lane's ray: (t,
    kind, idx, bu, bv, seed), integrator.prims_hit's values (the kernel
    writes a miss on dead lanes, whose hit nothing reads). shadow: with
    direct-light sampling in a scene without mesh triangles, (pd,
    emitters, flags): the pending hits (the lane state's "dls"), the
    emitters' sphere indices ((E,) int32) and an (E, N) bool buffer, into
    which the same launch writes every emitter's shadow-ray flags tested
    against this hit (shadow_prims' flags, one emitter a row)."""
    if shadow is not None and scene.n_mesh_tris:
        raise ValueError("a mesh scene's shadow rays need its mesh hit: shadow_prims")
    if active.device.type == "cuda":
        return _launch_prims(scene, params, dict(ro=ro, rd=rd, active=active, shadow=shadow))
    if active.device.type == "cpu":
        return prims_reference(scene, params, ro, rd, active, shadow)
    raise ValueError(f"bounce_prims runs on cpu or cuda tensors, not {active.device}")


def shadow_prims(scene, params, pd, prims, mesh, j: int, flag):
    """The shadow rays toward emitter scene.emitters[j] from the pending
    hits pd (the lane state's "dls"), given this bounce's hit (prims,
    bounce_prims' values, and mesh, mesh_hit's or None): writes into the
    (N,) bool buffer `flag` the lanes whose ray is cast and meets that
    emitter first among the spheres and free triangles, and returns (d_l,
    seed), the ray's direction and its mesh seed. The wavefront takes it
    in mesh scenes only, where the seed starts the shadow mesh_hit; a
    meshless scene's shadow rays go in bounce_prims' own launch."""
    if flag.device.type == "cuda":
        return _launch_prims(scene, params, dict(dls=pd, prims=prims, mesh=mesh, flag=flag), j)
    if flag.device.type == "cpu":
        return shadow_reference(scene, params, pd, prims, mesh, j, flag)
    raise ValueError(f"shadow_prims runs on cpu or cuda tensors, not {flag.device}")


def bounce_shade(scene, params, st, prims, mesh, shadow, unit, slots, cap: int,
                 sky_fetches=None):
    """One bounce after the hits, in place: st, the lane state's buffers
    (init_lanes' tree), becomes the next state with the bounce cap
    applied, and each lane whose path ended writes its radiance (with the
    sky's term) into slots[unit]. prims: bounce_prims' values; mesh:
    mesh_hit's (None without a mesh); shadow: with direct-light sampling,
    (emitters, flags, gids): the emitters' sphere indices ((E,) int32),
    shadow_prims' flags ((E, N) bool) and the shadow mesh hits' gids ((E,
    N) int32, or None without a mesh); else None. slots: the (n_work + 1,
    3) f32 sums, the last row the discard row. sky_fetches: a 0-dim int64
    buffer to which the retiring lanes that fetch the sky are added (those
    whose path missed with a weight > 0 left), or None; nothing is added
    without a sky."""
    if unit.device.type == "cuda":
        _launch_shade(scene, params, st, prims, mesh, shadow, unit, slots, cap, sky_fetches)
    elif unit.device.type == "cpu":
        shade_reference(scene, params, st, prims, mesh, shadow, unit, slots, cap, sky_fetches)
    else:
        raise ValueError(f"bounce_shade runs on cpu or cuda tensors, not {unit.device}")


def lanes_assign(scene, params, new, st, unit, xs, ys, n_work: int, queue):
    """The wavefront's refill, in place: st, the lane state's buffers,
    takes the state `new` (the bounce's, or st itself) with the next work
    units handed to the dead lanes, ranked by position: each gets id q +
    its rank while that is below n_work, its unit in `unit`, a stream
    seeded from (x, y, sample_base + id // n_pix) of the (n_pix,) int32
    tables xs, ys at id % n_pix, raygen.generate_paths' ray, fresh
    radiance, throughput and bounce count, a cleared miss record and no
    pending direct-light term. queue: the 0-dim device buffers (q,
    sample_base, iters, lane_bounces, flag); q advances (at most to
    n_work), the flag says whether a lane is active after the refill, and
    iters and lane_bounces count those lanes, the next iteration's."""
    if unit.device.type == "cuda":
        _launch_assign(scene, params, new, st, unit, xs, ys, n_work, queue)
    elif unit.device.type == "cpu":
        assign_reference(scene, params, new, st, unit, xs, ys, n_work, queue)
    else:
        raise ValueError(f"lanes_assign runs on cpu or cuda tensors, not {unit.device}")


# --- the plain versions (any device) -----------------------------------------


def prims_reference(scene, params, ro, rd, active, shadow=None):
    """bounce_prims' plain version: integrator.prims_hit, then with
    shadow each emitter's shadow_reference on that hit."""
    hit, seed = itg.prims_hit(scene, params, ro, rd, active)
    prims = (*hit, seed)
    if shadow is not None:
        pd, _, flags = shadow
        for j in range(len(scene.emitters)):
            shadow_reference(scene, params, pd, prims, None, j, flags[j])
    return prims


def shadow_reference(scene, params, pd, prims, mesh, j: int, flag):
    """shadow_prims' plain version: integrator.shadow_ray and prims_hit."""
    e = scene.emitters[j]
    _, kind, idx, _, _ = _merged(scene, params, prims, mesh)
    d_l, _, cand = itg.shadow_ray(scene, pd, kind, idx, e)
    (_, ks, is_, _, _), seed = itg.prims_hit(scene, params, pd["pos"], d_l, cand)
    flag.copy_(cand & (ks == itg.KIND_SPHERE) & (is_ == e))
    return d_l, seed


def shade_reference(scene, params, st, prims, mesh, shadow, unit, slots, cap,
                    sky_fetches=None):
    """bounce_shade's plain version: integrator.merge_mesh and shade_step,
    then the wavefront's cap and retire."""
    where = torch.where
    hit = _merged(scene, params, prims, mesh)
    terms = []
    if shadow is not None:
        _, flags, gids = shadow
        for j, e in enumerate(scene.emitters):
            _, light_dot, _ = itg.shadow_ray(scene, st["dls"], hit[1], hit[2], e)
            terms.append((light_dot, flags[j] if gids is None else flags[j] & (gids[j] < 0)))
    was_active = st["active"]
    new = itg.shade_step(scene, params, st, hit, terms)
    new["active"] = new["active"] & (new["bounce"] < cap)
    if "dls" in new:
        new["dls"]["active"] = new["dls"]["active"] & new["active"]
    term = was_active & ~new["active"]
    L = new["L"]
    if "miss_d" in new:  # a retiring path that missed adds its sky term
        L = itg.resolve_sky_dense(scene, L, new["miss_d"], new["miss_w"], term)
        if sky_fetches is not None:
            count_fetches(sky_fetches, new["miss_w"], term)
    discard = torch.full_like(unit, slots.shape[0] - 1)
    slots.index_put_((where(term, unit, discard),), torch.stack(L, dim=1))
    # a dead lane keeps its state: the bounce leaves every field of such a
    # lane as it was but its stream and the direct-light record
    new["rng"] = where(was_active, new["rng"], st["rng"])
    if "dls" in new:
        for k in ("pos", "norm", "ci", "self_idx"):
            new["dls"][k] = _map2(lambda a, b: where(was_active, a, b), new["dls"][k],
                                  st["dls"][k])
    _copy_into(st, new)


def count_fetches(counter, miss_w, term):
    """Add to the 0-dim int64 `counter` the lanes of the bool mask `term`
    (those that retire) whose miss record has a weight > 0 in some
    channel: the lanes whose retire fetches the sky."""
    missed = (miss_w[0] > 0.0) | (miss_w[1] > 0.0) | (miss_w[2] > 0.0)
    counter.add_((missed & term).sum())


def assign_reference(scene, params, new, st, unit, xs, ys, n_work: int, queue):
    """lanes_assign's plain version: a prefix sum over the pool, the
    raygen of every lane, kept where the lane is refilled."""
    q, sample_base, iters, lane_bounces, flag = queue
    where, n_pix = torch.where, xs.numel()
    need = ~new["active"]
    ranks = torch.cumsum(need.to(torch.int64), 0)
    ids = q + ranks - 1
    valid = need & (ids < n_work)
    q.copy_(torch.clamp(q + ranks[-1], max=n_work))
    ids = ids.clamp(0, max(n_work - 1, 0))
    pix = ids % n_pix
    x, y = xs[pix], ys[pix]
    state0, ro0, rd0 = raygen.generate_paths(
        rng.init_state(x, y, sample_base + ids // n_pix), x, y, scene.cam, scene.has_lens,
        params.generator)
    z = torch.zeros_like(ro0[0])
    one = torch.ones_like(z)
    fresh = dict(ro=ro0, rd=rd0, L=(z, z, z), ci=(one, one, one), inten=one, rng=state0,
                 bounce=torch.zeros_like(st["bounce"]))
    if "miss_d" in st:  # a fresh work unit must not inherit a miss record (:287-288)
        fresh.update(miss_d=(z, z, z), miss_w=(z, z, z))
    for k, v in fresh.items():
        for out, a, b in zip(_tup(st[k]), _tup(v), _tup(new[k])):
            where(valid, a, b, out=out)
    if "dls" in st:  # nor a pending direct-light term
        torch.logical_and(new["dls"]["active"], ~valid, out=st["dls"]["active"])
    where(valid, ids, unit, out=unit)
    torch.logical_or(new["active"], valid, out=st["active"])
    flag.copy_(st["active"].any())
    iters.add_(flag)
    lane_bounces.add_(st["active"].sum())


def _tup(v):
    return v if isinstance(v, tuple) else (v,)


def _map2(fn, a, b):
    return tuple(fn(x, y) for x, y in zip(a, b)) if isinstance(a, tuple) else fn(a, b)


def _copy_into(dst, src):
    for k, v in src.items():
        if isinstance(v, dict):
            _copy_into(dst[k], v)
        else:
            for out, val in zip(dst[k] if isinstance(v, tuple) else (dst[k],),
                                v if isinstance(v, tuple) else (v,)):
                out.copy_(val)


# --- the launchers ----------------------------------------------------------

# BounceArgs, csrc/bounce_kernel.cu's one argument struct of both entries,
# field by field in its order: pointers, then 64-bit lengths, ints, floats
_PTRS = (
    ["sph_c", "sph_r", "sph_rgb", "sph_em", "sph_diffp", "sph_n_out", "sph_n_in", "sph_has_em",
     "sph_kind", "ft_v0", "ft_e1", "ft_e2", "ft_norm", "ft_rgb", "ft_em", "ft_diffp",
     "ft_n_out", "ft_n_in", "ft_has_em", "ft_kind", "attr", "desc", "pool", "face", "sky_pool",
     "emitters"]
    + [f"{k}{c}" for k in ("ro", "rd", "L", "ci") for c in range(3)]
    + ["inten", "rng", "active", "bounce"]
    + [f"{k}{c}" for k in ("miss_d", "miss_w") for c in range(3)]
    + ["dls_active"] + [f"{k}{c}" for k in ("dls_pos", "dls_norm", "dls_ci") for c in range(3)]
    + ["dls_self", "t", "kind", "idx", "bu", "bv", "seed", "mt", "mgid", "mu", "mv"]
    + [f"d_l{c}" for c in range(3)] + ["flag", "flags", "sgid", "unit", "slots", "sky_fetches"])
_LONGS = ("pool_len", "sky_len")
_INTS = ("n", "n_sph", "n_ft", "n_mesh", "n_emit", "pool_kind", "sky_kind", "cpu", "pcg", "dls",
         "debug", "miss", "assured", "cap", "emitter")
_FLOATS = ("max_thres", "inv_thres", "t_min", "dls_normze")


class BounceArgs(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_void_p) for k in _PTRS] + [(k, ctypes.c_longlong) for k in _LONGS]
                + [(k, ctypes.c_int) for k in _INTS] + [(k, ctypes.c_float) for k in _FLOATS])


_F32, _I64, _I32, _BOOL = torch.float32, torch.int64, torch.int32, torch.bool


def _ptr(name, t, dtype, dev, numel=None):
    """t's address, once t is contiguous, of dtype, on dev (and of numel
    elements); None for None."""
    if t is None:
        return None
    if t.dtype != dtype or t.device != dev or not t.is_contiguous() or (
            numel is not None and t.numel() != numel):
        raise ValueError(f"{name} must be contiguous {dtype} on {dev}"
                         + ("" if numel is None else f" of {numel} elements"))
    return t.data_ptr()


_SCENE_COLS = (("sph_c", "sph_c", _F32), ("sph_r", "sph_r", _F32), ("sph_rgb", "sph_rgb", _F32),
               ("sph_em", "sph_emissive", _F32), ("sph_diffp", "sph_diffp", _F32),
               ("sph_n_out", "sph_n_out", _F32), ("sph_n_in", "sph_n_in", _F32),
               ("sph_has_em", "sph_has_em", _BOOL), ("sph_kind", "sph_kind", _I64),
               ("ft_v0", "ft_v0", _F32), ("ft_e1", "ft_e1", _F32), ("ft_e2", "ft_e2", _F32),
               ("ft_norm", "ft_norm", _F32), ("ft_rgb", "ft_rgb", _F32),
               ("ft_em", "ft_emissive", _F32), ("ft_diffp", "ft_diffp", _F32),
               ("ft_n_out", "ft_n_out", _F32), ("ft_n_in", "ft_n_in", _F32),
               ("ft_has_em", "ft_has_em", _BOOL), ("ft_kind", "ft_kind", _I64))


def _args(scene, params, dev, n) -> BounceArgs:
    """The scene's columns, its mesh and sky tables and the parameters."""
    if params.differentiable:
        raise ValueError("the bounce kernels take no differentiable render")
    a = BounceArgs()
    for field, name, dtype in _SCENE_COLS:
        setattr(a, field, _ptr(f"scene.{name}", getattr(scene, name), dtype, dev))
    if scene.n_mesh_tris:
        m = scene.mesh
        a.attr = _ptr("mesh.attr", m.attr, _F32, dev)
        a.desc = _ptr("mesh.desc", m.desc, _I32, dev)
        if m.pool.device != dev or not m.pool.is_contiguous():
            raise ValueError(f"mesh.pool must be contiguous on {dev}")
        a.pool, a.pool_len, a.pool_kind = m.pool.data_ptr(), m.pool.numel(), m.pool_kind
    if scene.sky is not None:
        a.face, a.sky_pool, a.sky_kind, a.sky_len = cubemap.launch_args(scene.sky, dev)
    a.n, a.n_sph, a.n_ft, a.n_mesh = n, scene.n_spheres, scene.n_free_tris, scene.n_mesh_tris
    if params.generator not in rng.GENERATORS:
        raise ValueError(f"generator must be one of {rng.GENERATORS}, not {params.generator!r}")
    a.cpu, a.pcg = int(params.mode == "cpu"), int(params.generator == "pcg")
    a.dls, a.debug = int(itg.uses_dls(scene, params)), int(params.debug_single_ray)
    a.miss, a.assured = int(itg.tracks_miss(scene, params)), params.assured_depth
    a.max_thres = float(np.float32(params.max_thres))  # shade_step's constants
    a.inv_thres = float(np.float32(1.0) / np.float32(params.max_thres))
    a.t_min = itg.CPU_GUARD if params.mode == "cpu" else itg.EPS
    a.dls_normze = itg.DLS_NORMZE
    a.emitter = -1
    return a


def _set3(a, field, ts, dev, n, dtype=_F32):
    for c in range(3):
        setattr(a, f"{field}{c}", _ptr(f"{field}[{c}]", ts[c], dtype, dev, n))


def _set_dls(a, pd, dev, n):
    a.dls_active = _ptr("dls.active", pd["active"], _BOOL, dev, n)
    for k in ("pos", "norm", "ci"):
        _set3(a, f"dls_{k}", pd[k], dev, n)
    a.dls_self = _ptr("dls.self_idx", pd["self_idx"], _I64, dev, n)


def _set_hits(a, prims, mesh, dev, n):
    for k, t, dtype in zip(("t", "kind", "idx", "bu", "bv", "seed"), prims,
                           (_F32, _I64, _I64, _F32, _F32, _F32)):
        setattr(a, k, _ptr(f"prims.{k}", t, dtype, dev, n))
    if mesh is not None:
        for k, t, dtype in zip(("mt", "mgid", "mu", "mv"), mesh, (_F32, _I32, _F32, _F32)):
            setattr(a, k, _ptr(f"mesh.{k}", t, dtype, dev, n))


def _run(entry, a, dev):
    from ..kernels import build

    fn = getattr(build.build("bounce_kernel").lib, f"{entry}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(BounceArgs), ctypes.c_void_p]
    with torch.cuda.device(dev):
        rc = fn(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    LAUNCHES[entry] += 1


def _launch_prims(scene, params, lanes, j=None):
    if j is None:
        active = lanes["active"]
        dev, n = active.device, active.numel()
        a = _args(scene, params, dev, n)
        _set3(a, "ro", lanes["ro"], dev, n)
        _set3(a, "rd", lanes["rd"], dev, n)
        a.active = _ptr("active", active, _BOOL, dev, n)
        out = [torch.empty(n, dtype=dt, device=dev) for dt in (_F32, _I64, _I64, _F32, _F32, _F32)]
        _set_hits(a, out, None, dev, n)
        shadow = lanes["shadow"]
        if shadow is not None:  # every emitter's shadow rays in the same launch
            if not a.dls:
                raise ValueError("shadow rays need direct-light sampling")
            pd, emitters, flags = shadow
            _set_dls(a, pd, dev, n)
            a.n_emit = len(scene.emitters)
            a.emitters = _ptr("emitters", emitters, _I32, dev, a.n_emit)
            a.flag = _ptr("flags", flags, _BOOL, dev, a.n_emit * n)
        _run("bounce_prims", a, dev)
        if shadow is not None:
            LAUNCHES["bounce_prims_dls"] += 1
        return tuple(out)
    pd, flag = lanes["dls"], lanes["flag"]
    dev, n = flag.device, flag.numel()
    a = _args(scene, params, dev, n)
    if not a.dls:
        raise ValueError("shadow rays need direct-light sampling")
    a.emitter = scene.emitters[j]
    _set_dls(a, pd, dev, n)
    _set_hits(a, lanes["prims"], lanes["mesh"], dev, n)
    d_l = tuple(torch.empty(n, dtype=_F32, device=dev) for _ in range(3))
    seed = torch.empty(n, dtype=_F32, device=dev)
    _set3(a, "d_l", d_l, dev, n)
    a.seed = seed.data_ptr()  # the shadow ray's seed, in the primary's seed field
    a.flag = _ptr("flag", flag, _BOOL, dev, n)
    _run("bounce_prims", a, dev)
    return d_l, seed


def _launch_shade(scene, params, st, prims, mesh, shadow, unit, slots, cap, sky_fetches):
    dev, n = unit.device, unit.numel()
    a = _args(scene, params, dev, n)
    for k in ("ro", "rd", "L", "ci"):
        _set3(a, k, st[k], dev, n)
    a.inten = _ptr("inten", st["inten"], _F32, dev, n)
    a.rng = _ptr("rng", st["rng"], _I64, dev, n)
    a.active = _ptr("active", st["active"], _BOOL, dev, n)
    a.bounce = _ptr("bounce", st["bounce"], _I32, dev, n)
    if a.miss:
        _set3(a, "miss_d", st["miss_d"], dev, n)
        _set3(a, "miss_w", st["miss_w"], dev, n)
    if a.dls:
        if shadow is None:
            raise ValueError("direct-light sampling needs the shadow rays' flags")
        _set_dls(a, st["dls"], dev, n)
        emitters, flags, gids = shadow
        a.n_emit = len(scene.emitters)
        a.emitters = _ptr("emitters", emitters, _I32, dev, a.n_emit)
        a.flags = _ptr("flags", flags, _BOOL, dev, a.n_emit * n)
        if (gids is None) != (mesh is None):
            raise ValueError("the shadow rays' gids come with a mesh, and only with one")
        a.sgid = _ptr("gids", gids, _I32, dev, a.n_emit * n)
    _set_hits(a, prims, mesh, dev, n)
    if scene.n_mesh_tris and mesh is None:
        raise ValueError("a mesh scene's bounce needs its mesh hit")
    a.unit = _ptr("unit", unit, _I64, dev, n)
    if slots.dim() != 2 or slots.shape[1] != 3:
        raise ValueError("slots must be (n_work + 1, 3)")
    a.slots = _ptr("slots", slots, _F32, dev)
    if a.miss:  # without a sky the pointer stays null
        a.sky_fetches = _ptr("sky_fetches", sky_fetches, _I64, dev, 1)
    a.cap = cap
    _run("bounce_shade", a, dev)


# AssignArgs, csrc/bounce_kernel.cu's argument struct of lanes_assign: the
# source state's pointers, the buffers', then the pool's, 64-bit lengths,
# ints and the camera row
_ASSIGN_LANE = ([f"{k}{c}" for k in ("ro", "rd", "L", "ci") for c in range(3)]
                + ["inten", "rng", "bounce"]
                + [f"{k}{c}" for k in ("miss_d", "miss_w") for c in range(3)]
                + ["dls_active", "active"])
_ASSIGN_PTRS = ([f"src_{k}" for k in _ASSIGN_LANE] + _ASSIGN_LANE
                + ["unit", "xs", "ys", "q", "sample_base", "iters", "lane_bounces", "flag",
                   "scratch"])
_ASSIGN_THREADS = 1024  # the entry's block


class AssignArgs(ctypes.Structure):
    _fields_ = ([(k, ctypes.c_void_p) for k in _ASSIGN_PTRS]
                + [("n_work", ctypes.c_longlong), ("n_pix", ctypes.c_longlong),
                   ("n", ctypes.c_int), ("has_lens", ctypes.c_int), ("pcg", ctypes.c_int),
                   ("cam", ctypes.c_float * 18)])


def _lane_fields(tree, dev, n):
    """{AssignArgs lane field: address} of a lane-state tree."""
    dtypes = dict(inten=_F32, rng=_I64, bounce=_I32, active=_BOOL)
    out = {}
    for k in ("ro", "rd", "L", "ci", "miss_d", "miss_w"):
        for c, t in enumerate(tree.get(k, ())):
            out[f"{k}{c}"] = _ptr(f"{k}[{c}]", t, _F32, dev, n)
    for k, dtype in dtypes.items():
        out[k] = _ptr(k, tree[k], dtype, dev, n)
    if "dls" in tree:
        out["dls_active"] = _ptr("dls.active", tree["dls"]["active"], _BOOL, dev, n)
    return out


def _launch_assign(scene, params, new, st, unit, xs, ys, n_work, queue):
    from ..kernels import build

    dev, n = unit.device, unit.numel()
    if params.generator not in rng.GENERATORS:
        raise ValueError(f"generator must be one of {rng.GENERATORS}, not {params.generator!r}")
    if ("miss_d" in new, "dls" in new) != ("miss_d" in st, "dls" in st):
        raise ValueError("the source state and the buffers must hold the same fields")
    if len(scene.cam) != 18:
        raise ValueError("scene.cam must be make_cam_vec's 18 floats")
    a = AssignArgs()
    for k, v in _lane_fields(new, dev, n).items():
        setattr(a, f"src_{k}", v)
    for k, v in _lane_fields(st, dev, n).items():
        setattr(a, k, v)
    a.unit = _ptr("unit", unit, _I64, dev, n)
    n_pix = xs.numel()
    a.xs, a.ys = _ptr("xs", xs, _I32, dev), _ptr("ys", ys, _I32, dev, n_pix)
    for k, t in zip(("q", "sample_base", "iters", "lane_bounces", "flag"), queue):
        setattr(a, k, _ptr(k, t, _BOOL if k == "flag" else _I64, dev, 1))
    blocks = -(-n // _ASSIGN_THREADS)
    scratch = torch.empty(blocks + 1, dtype=_I64, device=dev)
    a.scratch = scratch.data_ptr()
    a.n_work, a.n_pix, a.n = n_work, n_pix, n
    a.has_lens, a.pcg = int(scene.has_lens), int(params.generator == "pcg")
    a.cam[:] = [float(v) for v in scene.cam]
    fn = build.build("bounce_kernel").lib.lanes_assign_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.POINTER(AssignArgs), ctypes.c_void_p]
    with torch.cuda.device(dev):
        rc = fn(ctypes.byref(a), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"lanes_assign kernel launch failed: CUDA error {rc}")
    LAUNCHES["lanes_assign"] += 1
