"""Monte-Carlo path integrator: the bounce loop of every lane, in torch.

Port of `raytrace_tpu/render/integrator.py` (forward rendering): the
closest hit over spheres, free triangles and the mesh (`closest_hit`,
:219-368), the shading of every kind with masked selects (`_shade_hit`,
:701-850), one bounce in gpu or cpu semantics with direct-light sampling
(`_bounce_step`, :857-983) and the loop to the last live lane
(`trace_paths`, :986-1041, its `while` loop). Lanes are flat (N,)
tensors; a 3-vector is a tuple of three.

The two semantics (integrator.py:16-38):

* gpu: the near sphere root only (with its `near < far` test); emissive
  hits add E*T*I and multiply the throughput by the colour twice;
  Russian roulette from `assured_depth` on (>=), terminating when
  u7 > max_thres and ADDING throughput / max_thres; the dielectric weight
  (1 on reflection, 1 - re on transmission) rides in `inten`;
* cpu: the least positive sphere root; a hit counts only at
  t >= 20*EPS (spheres, free triangles and the mesh); L += T * emissive
  at every hit; free-triangle emissive zeroed; roulette only AFTER
  `assured_depth` (>), survival 0.4, the bounce colour divided by 0.4;
  the Schlick cosine is c1 on entry and the reflect weight is re; and
  optionally direct-light sampling over the emissive spheres, with its
  one-bounce lookahead `dls` state.

This is the integrator's own formulation, which is not the fused
kernels': raygen (`raygen.generate_paths`) and every normalize are
sqrt-then-divide (`raygen.normalize`), the sphere normal takes eps 1e-20,
the spec direction is renormalized and the Schlick term is `cos**5`.
Only what is bit-identical is shared with the kernels' plain versions:
`rng`, `intersect.triangle_tuv`, `mesh_kernel.mesh_attrs` (the JAX
`mesh_attrs_dense`) and the texel fetch. The mesh nearest hit is
`mesh_kernel.mesh_hit`: its CUDA kernel on the card, its plain version on
the CPU. The cube map: a lane that misses records its direction and
weight (`miss_d`, `miss_w`; a path misses at most once, and then ends),
resolved once after the loop through `ops/cubemap.sample`
(:1034-1040; the wavefront's retiring lanes through `resolve_sky_dense`,
which needs no host sync); debug_single_ray samples the sky in its one
bounce.

A bounce is split where the wavefront's CUDA kernels split it
(ops/bounce_kernel.py): `prims_hit` (the sphere / free-triangle hit, the
`bounce_prims` entry's plain version), `mesh_of` (the `mesh_hit` launch),
`merge_mesh`, `shadow_ray` (direct-light sampling's rays) and
`shade_step` (everything after the hit, the `bounce_shade` entry's plain
version). `closest_hit` and `_bounce_step` compose them, as one
formulation: the CPU, `trace_paths` and the differentiable tier run
them.

The differentiable tier (`IntegratorParams.differentiable`, the JAX
:75): torch autograd records the bounce loop as it runs, so the loop
keeps its all-dead exit, where the JAX package scans all max_depth
bounces (:1018-1022, reverse mode cannot pass its while_loop): a bounce
over an all-dead pool adds nothing, to the image or to a gradient
(tests/test_torch_diff.py holds the two bitwise). When differentiable,
the mesh hit still comes from `mesh_hit` (the kernel on the card), and
the winner's (t, u, v) are recomputed from the scene's own vertex tables
`mt_v0 / mt_e1 / mt_e2` with `intersect.triangle_tuv`, the kernel's own
arithmetic (bitwise the same values), so that the gradient reaches the
vertices as a `min` passes it to its argmin in the JAX chunked path
(:318-366). Every select whose unselected branch could be inf or NaN
takes a finite stand-in there (`normalize`'s clamp, the guarded square
roots and divides), so the backward pass's 0 x (inf or NaN) cannot reach
a gradient. The fused kernels and the wavefront have no backward, and
refuse a differentiable render.

Draws: 8 uniforms per bounce in mesh scenes, 5 in meshless ones
(u0, u1, u2, u3, u7; integrator.py:862-869), from
`IntegratorParams.generator` (ops/rng.py: "weyl" or the reference's
"pcg"; the JAX package reads its RTPU_RNG at import instead).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import rng
from ..ops.intersect import EPS, INF, triangle_tuv
from ..ops.mesh_kernel import mesh_attrs, mesh_hit
from ..ops.raygen import TWO_PI, normalize
from ..ops.texture import take

KIND_NONE, KIND_SPHERE, KIND_FREETRI, KIND_MESHTRI = 0, 1, 2, 3
CPU_RR_THRES = 0.4  # radiance.rs:77, hard-coded
DLS_NORMZE = float(np.float32(1.0 / (30.0 * np.pi)))  # radiance.rs:90
CPU_GUARD = float(np.float32(20.0 * EPS))  # closest_hit.rs:16
# a dead lane's mesh seed: the slab test `entry < seed` then fails at
# every node, so the walk reaches nothing
DEAD_SEED = float("-inf")


@dataclass(frozen=True)
class IntegratorParams:
    """The JAX package's IntegratorParams (integrator.py:66-81) without
    its TPU tiling fields (`mesh_chunk`, `ray_tile`, `use_clusters`,
    `mesh_kernel`: the mesh always goes through `mesh_hit`).
    `differentiable`: gradients reach the mesh's vertex tables (module
    docstring). `generator`: the counter RNG's family (ops/rng.GENERATORS)
    of every draw, raygen's and the bounces', on every driver."""

    max_thres: float = 0.5
    assured_depth: int = 5
    max_bounces: int = 24
    mode: str = "gpu"
    debug_single_ray: bool = False
    dir_light_samp: bool = False
    differentiable: bool = False
    generator: str = "weyl"

    def __post_init__(self):
        if self.mode not in ("gpu", "cpu"):
            raise ValueError(f"mode must be 'gpu' or 'cpu', not {self.mode!r}")
        if self.generator not in rng.GENERATORS:
            raise ValueError(f"generator must be one of {rng.GENERATORS}, not {self.generator!r}")


def uses_dls(scene, params: IntegratorParams) -> bool:
    """Direct-light sampling runs in cpu semantics only, over spheres."""
    return bool(params.dir_light_samp and params.mode == "cpu" and scene.n_spheres)


def tracks_miss(scene, params: IntegratorParams) -> bool:
    """The lane state carries miss records: a cube map and a full path."""
    return scene.sky is not None and not params.debug_single_ray


def resolve_sky(scene, L, miss_d, miss_w, lanes=None):
    """L + miss_w * sky(miss_d) where the lane missed (some miss_w
    component > 0) and, given the bool mask `lanes`, is one of them: the
    post-loop resolve of trace_paths (:1034-1040). The sky is sampled on
    those lanes only."""
    missed = (miss_w[0] > 0.0) | (miss_w[1] > 0.0) | (miss_w[2] > 0.0)
    if lanes is not None:
        missed = missed & lanes
    mi = missed.nonzero()[:, 0]
    sky = scene.sky.sample(*(c[mi] for c in miss_d))
    return tuple(L[k].index_put((mi,), L[k][mi] + miss_w[k][mi] * sky[k]) for k in range(3))


def resolve_sky_dense(scene, L, miss_d, miss_w, lanes):
    """resolve_sky(scene, L, miss_d, miss_w, lanes=lanes) without the
    gather's `nonzero` (a host sync): the sky sampled on every lane, the
    term kept where the lane resolves, the same arithmetic a lane, so
    bitwise the same. A lane that does not resolve looks up the fixed
    direction +z: its miss_d may be 0, whose face uv is 0/0, a NaN texel
    index."""
    missed = (miss_w[0] > 0.0) | (miss_w[1] > 0.0) | (miss_w[2] > 0.0)
    missed = missed & lanes
    zero = torch.zeros_like(miss_d[0])
    sky = scene.sky.sample(*_where3(missed, miss_d, (zero, zero, torch.ones_like(zero))))
    return tuple(torch.where(missed, L[k] + miss_w[k] * sky[k], L[k]) for k in range(3))


def _where3(mask, a, b):
    return tuple(torch.where(mask, a[k], b[k]) for k in range(3))


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _cross(a, b):
    return (a[1] * b[2] - a[2] * b[1], a[2] * b[0] - a[0] * b[2], a[0] * b[1] - a[1] * b[0])


def _reflect(d, n):
    k = 2.0 * _dot(d, n)
    return tuple(d[i] - n[i] * k for i in range(3))


# --- closest hit ------------------------------------------------------------


def sphere_t(ro, rd, c, r, mode: str):
    """The integrator's `_sphere_t` (:94-114) over (S, N): rays (N,),
    centers c a 3-tuple of (S, 1) and radii r (S, 1). gpu: the near root,
    accepted when disc > 0, near > 0 and near < far; cpu: the least
    positive root. INF on a miss."""
    oc = tuple(ro[k] - c[k] for k in range(3))
    dirv = _dot(rd, oc)
    consts = _dot(oc, oc) - r * r
    disc = dirv * dirv - consts
    pos = disc > 0.0
    sq = torch.sqrt(torch.where(pos, disc, torch.ones_like(disc)))
    near = -dirv - sq
    far = -dirv + sq
    inf = torch.full_like(near, INF)
    if mode == "gpu":
        return torch.where(pos & (near > 0.0) & (near < far), near, inf)
    return torch.where(pos, torch.where(near > 0.0, near, torch.where(far > 0.0, far, inf)), inf)


def prims_hit(scene, params: IntegratorParams, ro, rd, active=None):
    """The nearest hit over spheres, then free triangles (the first two
    stages of `closest_hit`), each stage updating on strict <. Returns
    ((t, kind, idx, bu, bv), seed): (N,) each; seed is the mesh walk's
    seed, t where the lane is active and DEAD_SEED elsewhere (dead lanes
    reach no cluster). The `bounce_prims` kernel's plain version."""
    n = ro[0].shape[0]
    dev = ro[0].device
    t_best = torch.full((n,), INF, dtype=torch.float32, device=dev)
    kind = torch.zeros((n,), dtype=torch.int64, device=dev)
    idx = torch.zeros((n,), dtype=torch.int64, device=dev)
    bu = torch.zeros((n,), dtype=torch.float32, device=dev)
    bv = torch.zeros_like(bu)
    cpu = params.mode == "cpu"

    def guard(t):
        return torch.where(t >= CPU_GUARD, t, torch.full_like(t, INF)) if cpu else t

    if scene.n_spheres:
        c = tuple(scene.sph_c[:, k:k + 1] for k in range(3))
        ts = guard(sphere_t(ro, rd, c, scene.sph_r[:, None], params.mode))
        tmin, amin = ts.min(dim=0)  # the first of equal minima
        better = tmin < t_best
        t_best = torch.where(better, tmin, t_best)
        kind = torch.where(better, KIND_SPHERE, kind)
        idx = torch.where(better, amin, idx)

    if scene.n_free_tris:
        col = lambda a: tuple(a[:, k:k + 1] for k in range(3))
        ts, us, ws = triangle_tuv(*ro, *rd, col(scene.ft_v0), col(scene.ft_e1), col(scene.ft_e2))
        ts = guard(ts)
        tmin, amin = ts.min(dim=0)
        better = tmin < t_best
        t_best = torch.where(better, tmin, t_best)
        kind = torch.where(better, KIND_FREETRI, kind)
        idx = torch.where(better, amin, idx)
        bu = torch.where(better, us.gather(0, amin[None])[0], bu)
        bv = torch.where(better, ws.gather(0, amin[None])[0], bv)
    seed = t_best if active is None else torch.where(
        active, t_best, torch.full_like(t_best, DEAD_SEED))
    return (t_best, kind, idx, bu, bv), seed


def mesh_of(scene, params: IntegratorParams, ro, rd, seed, gid_out=None):
    """`mesh_hit` of the rays over the scene's mesh, seeded with `seed`
    (t_min EPS, or the cpu semantics' guard): (t, gid int32, u, v).
    `gid_out`: an (N,) int32 buffer that receives gid. No gradient (the
    kernel has no backward)."""
    kw = {} if gid_out is None else dict(gid_out=gid_out)
    return mesh_hit(tuple(c.detach() for c in ro), tuple(c.detach() for c in rd), seed.detach(),
                    scene.mesh, t_min=CPU_GUARD if params.mode == "cpu" else EPS, **kw)


def merge_mesh(scene, params: IntegratorParams, ro, rd, hit, mesh):
    """The mesh's hit `mesh` (mesh_of's) over the sphere / free-triangle
    hit `hit` (prims_hit's) where a triangle beat its seed. Returns (t,
    kind, idx, bu, bv)."""
    t_best, kind, idx, bu, bv = hit
    tm, gm, um, vm = mesh
    won = gm >= 0
    if params.differentiable:
        # the winner's (t, u, v) again, from the vertex tables the walk's
        # rows copy: the same floats, with the gradient
        g = gm.long().clamp(min=0)
        tri = [take(getattr(scene, k), g).unbind(1) for k in ("mt_v0", "mt_e1", "mt_e2")]
        tm, um, vm = triangle_tuv(*ro, *rd, *tri)
    t_best = torch.where(won, tm, t_best)
    kind = torch.where(won, KIND_MESHTRI, kind)
    idx = torch.where(won, gm.long(), idx)
    bu = torch.where(won, um, bu)
    bv = torch.where(won, vm, bv)
    return t_best, kind, idx, bu, bv


def closest_hit(scene, params: IntegratorParams, ro, rd, active=None):
    """Nearest hit over spheres, then free triangles, then the mesh
    seeded with that best t (integrator.py:219-368), each stage updating
    on strict <. Returns (t, kind, idx, bu, bv), (N,) each; idx is the
    sphere / free-triangle row or the mesh-triangle id. `active`: dead
    lanes seed the mesh with DEAD_SEED, so the walk skips their rays."""
    hit, seed = prims_hit(scene, params, ro, rd, active)
    if scene.n_mesh_tris:
        hit = merge_mesh(scene, params, ro, rd, hit, mesh_of(scene, params, ro, rd, seed))
    return hit


# --- shading ----------------------------------------------------------------


def _diff_dir(d, n, u, w):
    """Cosine-weighted direction in the frame (xd, n x xd, n)
    (integrator.py:379-394)."""
    dn = _dot(d, n)
    xd = normalize(*(d[k] - n[k] * dn for k in range(3)), eps=1e-20)
    yd = _cross(n, xd)
    r = torch.sqrt(u)
    th = TWO_PI * w
    rc, rs = r * torch.cos(th), r * torch.sin(th)
    z = torch.sqrt(torch.clamp(1.0 - u, min=0.0))
    return tuple(xd[k] * rc + yd[k] * rs + n[k] * z for k in range(3))


def _pow5(x):
    """x**5 as XLA's integer_pow evaluates it: x * ((x*x) * (x*x))."""
    x2 = x * x
    return x * (x2 * x2)


def _refract_dir(d, n, n_out, n_in, u, mode: str):
    """Dielectric (integrator.py:397-426) with the reference's Schlick
    quirks; cpu semantics take the cosine as c1 on entry and weight a
    reflection by re. Returns (new_d, weight)."""
    c = _dot(n, d)
    into = c < 0.0
    n1 = torch.where(into, n_out, n_in)
    n2 = torch.where(into, n_in, n_out)
    c1 = torch.abs(c)
    nr = _where3(into, n, tuple(-v for v in n))
    n_over = n1 / n2
    c22 = 1.0 - n_over * n_over * (1.0 - c1 * c1)
    tir = c22 < 0.0
    refl_d = _reflect(d, nr)
    sq = torch.sqrt(torch.where(c22 > 0.0, c22, torch.ones_like(c22)))
    k_t = n_over * c1 - sq
    trns = _where3(tir, d, tuple(d[k] * n_over + nr[k] * k_t for k in range(3)))
    r0 = (n1 - n2) / (n1 + n2)
    r0 = r0 * r0
    tn = _dot(trns, n)
    cos_term = 1.0 - (tn if mode == "gpu" else torch.where(into, c1, tn))
    re = r0 + (1.0 + r0) * _pow5(cos_term)
    do_refl = tir | (u < re)
    one = torch.ones_like(re)
    w_refl = one if mode == "gpu" else torch.where(tir, one, re)
    return _where3(do_refl, refl_d, trns), torch.where(do_refl, w_refl, 1.0 - re)


def _shade_hit(scene, params, ro, rd, t, kind, idx, bu, bv, draws):
    """Per-lane masked combine over the primitive kinds
    (integrator.py:701-850): shading normal, position, colour, emissive,
    the next direction and its weight, and whether the hit samples direct
    light."""
    u0, u1, u2, u3, u4, u5, u6 = draws
    is_sph, is_ft, is_mt = kind == KIND_SPHERE, kind == KIND_FREETRI, kind == KIND_MESHTRI
    t_safe = torch.where(torch.isfinite(t), t, torch.zeros_like(t))
    perfect = tuple(ro[k] + rd[k] * t_safe for k in range(3))
    zero, one = torch.zeros_like(t), torch.ones_like(t)
    norm = rgb = emissive = (zero, zero, zero)
    has_em = torch.zeros_like(t, dtype=torch.bool)
    mkind = torch.zeros_like(kind)
    diffp, n_out, n_in, metal, rough = zero, one, one, zero, zero

    def take3(table, i):
        row = take(table, i)
        return tuple(row[:, k] for k in range(3))

    if scene.n_spheres:
        si = idx.clamp(0, scene.n_spheres - 1)
        c = take3(scene.sph_c, si)
        norm = _where3(is_sph, normalize(*(perfect[k] - c[k] for k in range(3)), eps=1e-20), norm)
        rgb = _where3(is_sph, take3(scene.sph_rgb, si), rgb)
        emissive = _where3(is_sph, take3(scene.sph_emissive, si), emissive)
        has_em = torch.where(is_sph, scene.sph_has_em[si], has_em)
        mkind = torch.where(is_sph, scene.sph_kind[si], mkind)
        diffp = torch.where(is_sph, scene.sph_diffp[si], diffp)
        n_out = torch.where(is_sph, scene.sph_n_out[si], n_out)
        n_in = torch.where(is_sph, scene.sph_n_in[si], n_in)

    if scene.n_free_tris:
        fi = idx.clamp(0, scene.n_free_tris - 1)
        norm = _where3(is_ft, take3(scene.ft_norm, fi), norm)
        rgb = _where3(is_ft, take3(scene.ft_rgb, fi), rgb)
        if params.mode != "cpu":  # the CPU backend zeroes triangle emissive (generic.rs:85-86)
            emissive = _where3(is_ft, take3(scene.ft_emissive, fi), emissive)
            has_em = torch.where(is_ft, scene.ft_has_em[fi], has_em)
        mkind = torch.where(is_ft, scene.ft_kind[fi], mkind)
        diffp = torch.where(is_ft, scene.ft_diffp[fi], diffp)
        n_out = torch.where(is_ft, scene.ft_n_out[fi], n_out)
        n_in = torch.where(is_ft, scene.ft_n_in[fi], n_in)

    if scene.n_mesh_tris:
        m = scene.mesh
        mi = torch.where(is_mt, idx.clamp(0, scene.n_mesh_tris - 1), torch.zeros_like(idx))
        mnx, mny, mnz, mr, mg, mb, mmet, mrgh = mesh_attrs(m.attr, m.desc, m.pool, m.pool_kind,
                                                           mi, bu, bv)
        norm = _where3(is_mt, (mnx, mny, mnz), norm)
        rgb = _where3(is_mt, (mr, mg, mb), rgb)
        metal = torch.where(is_mt, mmet, metal)
        rough = torch.where(is_mt, mrgh, rough)

    pos = tuple(perfect[k] + norm[k] * EPS for k in range(3))
    spec_d = normalize(*_reflect(rd, norm))
    diff_d = _diff_dir(rd, norm, u1, u2)
    refr_d, refr_w = _refract_dir(rd, norm, n_out, n_in, u3, params.mode)
    ds_diff = u0 < diffp
    uni_d = _where3(mkind == 0, spec_d, _where3(
        mkind == 1, diff_d, _where3(mkind == 2, _where3(ds_diff, diff_d, spec_d), refr_d)))
    uni_w = torch.where(mkind == 3, refr_w, one)

    # mesh PBR divert (mesh/triangle.rs:190-226)
    r0 = 0.04 + (1.0 - 0.04) * metal
    refl = r0 + (1.0 - r0) * (1.0 - _pow5(torch.abs(_dot(rd, norm))))
    pbr_base = _where3(u0 < (1.0 - refl), diff_d, spec_d)
    scatter = normalize(u4, u5, u6, eps=1e-20)
    pbr_d = normalize(*(pbr_base[k] + scatter[k] * rough for k in range(3)))
    return dict(
        norm=norm, pos=pos, rgb=rgb, emissive=emissive, has_em=has_em,
        new_d=_where3(is_mt, pbr_d, uni_d), weight=torch.where(is_mt, one, uni_w),
        should_dls=(mkind == 1) | ((mkind == 2) & ds_diff),
    )


# --- the bounce loop --------------------------------------------------------


def init_lanes(scene, params, ro, rd, state):
    """The lane state of fresh paths (trace_paths' initial carry)."""
    zero = torch.zeros_like(ro[0])
    one = torch.ones_like(zero)
    st = dict(ro=ro, rd=rd, L=(zero, zero, zero), ci=(one, one, one), inten=one, rng=state,
              active=torch.ones_like(zero, dtype=torch.bool),
              bounce=torch.zeros_like(zero, dtype=torch.int32))
    if tracks_miss(scene, params):
        st["miss_d"] = st["miss_w"] = (zero, zero, zero)
    if uses_dls(scene, params):
        st["dls"] = dict(active=torch.zeros_like(st["active"]), pos=(zero, zero, zero),
                         norm=(zero, zero, zero), ci=(one, one, one),
                         self_idx=torch.full_like(zero, -1, dtype=torch.int64))
    return st


def shadow_ray(scene, pd, kind, idx, e: int):
    """Direct-light sampling's shadow ray toward emitter e (a sphere
    index) from the pending hit pd (the lane state's "dls"), given this
    bounce's hit (kind, idx): (d_l, light_dot, cand), cand the lanes whose
    ray is cast. The emitter that made the pending hit and the one this
    bounce hit are omitted (radiance.rs:46-52)."""
    center = scene.sph_c[e].unbind()
    d_l = normalize(*(center[k] - pd["pos"][k] for k in range(3)), eps=1e-20)
    light_dot = _dot(d_l, pd["norm"])
    omit = (pd["self_idx"] == e) | ((kind == KIND_SPHERE) & (idx == e))
    return d_l, light_dot, pd["active"] & (light_dot > 0.0) & ~omit


def shade_step(scene, params: IntegratorParams, st, hit, dls_terms=()):
    """One bounce after its closest hit (integrator.py:862-983): the
    draws, the shading, the gpu or cpu radiance update and roulette, the
    miss record, the direct-light terms and debug_single_ray. hit: (t,
    kind, idx, bu, bv), closest_hit's; dls_terms: with direct-light
    sampling, (light_dot, ok) for each of scene.emitters in order, ok the
    lanes whose shadow ray reaches that emitter. Returns the next lane
    state. The `bounce_shade` kernel's plain version, with the
    wavefront's cap and retire (ops/bounce_kernel.py)."""
    ro, rd, active = st["ro"], st["rd"], st["active"]
    t, kind, idx, bu, bv = hit
    if scene.n_mesh_tris:
        state, draws = rng.next_f32_n(st["rng"], 8, params.generator)
        u7 = draws[7]
    else:  # meshless scenes skip the PBR scatter draws u4-u6
        state, (u0, u1, u2, u3, u7) = rng.next_f32_n(st["rng"], 5, params.generator)
        draws = (u0, u1, u2, u3, u1, u2, u3, u7)
    hit = kind != KIND_NONE
    sh = _shade_hit(scene, params, ro, rd, t, kind, idx, bu, bv, draws[:7])
    L, ci, inten = st["L"], st["ci"], st["inten"]
    zero = torch.zeros_like(t)
    ah = active & hit
    miss_rec = {}
    if tracks_miss(scene, params):
        # the miss record (gpu: ci * inten, :880-886; cpu: ci, :905-910),
        # resolved after the loop
        am = active & ~hit
        mw = tuple(c * inten for c in ci) if params.mode == "gpu" else ci
        miss_rec = dict(miss_d=_where3(am, rd, st["miss_d"]), miss_w=_where3(am, mw, st["miss_w"]))

    if params.mode == "gpu":
        add_em = ah & sh["has_em"]
        L = tuple(L[k] + torch.where(add_em, sh["emissive"][k] * ci[k] * inten, zero)
                  for k in range(3))
        ci = _where3(add_em, tuple(ci[k] * sh["rgb"][k] for k in range(3)), ci)
        ci = _where3(ah, tuple(ci[k] * sh["rgb"][k] for k in range(3)), ci)
        rr_kill = (st["bounce"] >= params.assured_depth) & (
            u7 > float(np.float32(params.max_thres)))
        term = ah & rr_kill
        inv = float(np.float32(1.0) / np.float32(params.max_thres))
        ci_rr = tuple(c * inv for c in ci)
        L = tuple(L[k] + torch.where(term, ci_rr[k] * inten, zero) for k in range(3))
        ci = _where3(term, ci_rr, ci)
        survive = ah & ~rr_kill
        inten = torch.where(survive, inten * sh["weight"], inten)
    else:  # radiance.rs:20-72
        L = tuple(L[k] + torch.where(ah, sh["emissive"][k] * ci[k], zero) for k in range(3))
        rr_due = st["bounce"] > params.assured_depth
        rr_pass = torch.where(rr_due, u7 < CPU_RR_THRES, True)
        atten = torch.where(rr_due, torch.full_like(zero, CPU_RR_THRES), torch.ones_like(zero))
        survive = ah & rr_pass
        w = sh["weight"] / atten
        ci = _where3(survive, tuple(ci[k] * (sh["rgb"][k] * w) for k in range(3)), ci)
    new_active = survive

    # direct-light sampling at the PREVIOUS bounce's diffuse hit
    # (radiance.rs:89-120): light_dot * emissive / (30 pi) from each
    # emitter whose shadow ray reaches it
    pd = st.get("dls")
    for e, (light_dot, ok) in zip(scene.emitters, dls_terms):
        em = scene.sph_emissive[e].unbind()
        s = light_dot * DLS_NORMZE
        L = tuple(L[k] + torch.where(ok, pd["ci"][k] * (em[k] * s), zero) for k in range(3))

    if params.debug_single_ray:
        # first-hit emissive only (radiance.rs:31-33); a miss shows the sky,
        # black without a cube map (:955-959)
        sky = scene.sky.sample(*rd) if scene.sky is not None else (zero, zero, zero)
        L = tuple(torch.where(active & ~hit, sky[k], torch.where(ah, sh["emissive"][k], L[k]))
                  for k in range(3))
        new_active = torch.zeros_like(new_active)

    out = dict(ro=_where3(new_active, sh["pos"], ro), rd=_where3(new_active, sh["new_d"], rd),
               L=L, ci=ci, inten=inten, rng=state, active=new_active,
               bounce=st["bounce"] + new_active.to(torch.int32), **miss_rec)
    if uses_dls(scene, params):
        out["dls"] = dict(active=new_active & sh["should_dls"], pos=sh["pos"], norm=sh["norm"],
                          ci=ci, self_idx=torch.where(kind == KIND_SPHERE, idx,
                                                      torch.full_like(idx, -1)))
    return out


def _bounce_step(scene, params: IntegratorParams, st):
    """One bounce for all lanes (integrator.py:857-983). st: the lane
    state dict of init_lanes; returns the next one."""
    hit = closest_hit(scene, params, st["ro"], st["rd"], active=st["active"])
    terms = []
    if uses_dls(scene, params):
        # a shadow ray toward each emissive sphere's center; lanes outside
        # `cand` add nothing: they seed the mesh dead
        pd = st["dls"]
        for e in scene.emitters:
            d_l, light_dot, cand = shadow_ray(scene, pd, hit[1], hit[2], e)
            _, ks, is_, _, _ = closest_hit(scene, params, pd["pos"], d_l, active=cand)
            terms.append((light_dot, cand & (ks == KIND_SPHERE) & (is_ == e)))
    return shade_step(scene, params, st, hit, terms)


def max_depth(params: IntegratorParams) -> int:
    """The bounce cap of a path: 1 for debug_single_ray."""
    return 1 if params.debug_single_ray else params.max_bounces


def trace_paths(scene, params: IntegratorParams, ro, rd, state):
    """Trace a batch of rays to completion (integrator.py:986-1041, the
    forward `while` loop: at most max_depth bounces, ending when no lane
    is active, which syncs with the host once per bounce), then the cube
    map's resolve. Returns (L, rng): L a 3-tuple of (N,) f32."""
    st = init_lanes(scene, params, ro, rd, state)
    for _ in range(max_depth(params)):
        if not bool(st["active"].any()):
            break
        st = _bounce_step(scene, params, st)
    if tracks_miss(scene, params):
        return resolve_sky(scene, st["L"], st["miss_d"], st["miss_w"]), st["rng"]
    return st["L"], st["rng"]
