"""The paths of the two renderer formulations, one (pixel, sample) a lane.

`fused_paths`: the GPU backend's semantics as the fused kernels compute
them (trace_tiles for spheres, mesh_trace with a mesh): the near sphere
root; an emissive hit adds E (T I) and multiplies T by the colour twice;
Russian roulette from `assured` bounces on (>=), ending when u7 >
max_thres and adding T I / max_thres; the dielectric's weight rides in I;
the mesh's PBR lobe. `integrator_paths`: the CPU backend's semantics as
the integrator computes them (the wavefront and the plain driver): the
least positive root, hits at t >= 20 EPS, L += T E at every hit, roulette
after `assured` bounces (>) with survival 0.4. Both return the (N, 3)
radiance of each lane's path, and with `work` add what the path's
bounces cost to its counts (see `new_work`).
"""
from __future__ import annotations

import numpy as np
import torch

from . import rng
from .camera import TWO_PI, norm3, normalize, primary
from .geometry import EPS, inf_like, mesh_hit, sentinel, sphere_near, sphere_roots, walk_work

CPU_GUARD = float(np.float32(20.0 * EPS))
CPU_RR = 0.4
BRANCHES = ("miss", "diffuse", "mirror", "dielectric", "roulette", "mesh")


def new_work() -> dict:
    """Counts over lane-bounces: `lane_bounces`, `by_branch` (a miss; a
    sphere hit's lobe, or the roulette's end; a mesh hit), `near_roots`
    (sphere tests past the disc > 0 and dirv < 0 tests), `slab` and `tri`
    (the mesh walk's tests, `walk_work`), `paths`."""
    return dict(lane_bounces=0, by_branch={b: 0 for b in BRANCHES}, near_roots=0, slab=0, tri=0,
                paths=0)


def _where3(m, a, b):
    return tuple(torch.where(m, a[k], b[k]) for k in range(3))


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def _pow5(x):
    x2 = x * x
    return x * (x2 * x2)


def _texels(mesh, mi, bu, bv, dtype):
    """rgb_factor times the nearest base-colour texel at the barycentric
    (bu, bv) of triangles mi (clamped addressing; no texture: 1)."""
    uv = mesh["uv"][mi]
    b0 = 1.0 - bu - bv
    u = b0 * uv[:, 0] + bu * uv[:, 2] + bv * uv[:, 4]
    v = b0 * uv[:, 1] + bu * uv[:, 3] + bv * uv[:, 5]
    tid = mesh["tex_id"][mi]
    tex = mesh["textures"]
    hf, wf = (torch.full_like(u, float(s)) for s in tex.shape[1:3])
    zero = torch.zeros_like(u)
    # the clamp again on the integer: in bfloat16, W - 1 rounds up to W
    px = torch.minimum(torch.maximum(u * wf, zero), torch.clamp(wf - 1.0, min=0.0)).to(
        torch.int64).clamp(0, tex.shape[2] - 1)
    py = torch.minimum(torch.maximum(v * hf, zero), torch.clamp(hf - 1.0, min=0.0)).to(
        torch.int64).clamp(0, tex.shape[1] - 1)
    raw = tex[tid.clamp(min=0), py, px].to(torch.float32)
    texel = (raw / torch.full_like(raw, 255.0)).to(dtype)
    fac = mesh["rgb_factor"][mi]
    one = torch.ones_like(u)
    return [fac[:, k] * torch.where(tid >= 0, texel[:, k], one) for k in range(3)]


def _mesh_attrs(mesh, mi, bu, bv, dtype):
    """(normal, rgb, metal, rough) of mesh hits: the constant shading
    normal, the base colour, the metal and rough factors."""
    n = mesh["const_norm"][mi]
    return (n[:, 0], n[:, 1], n[:, 2]), _texels(mesh, mi, bu, bv, dtype), mesh["metal"][mi], \
        mesh["rough"][mi]


# --- the fused kernels' formulation ------------------------------------------

def _uniform_bsdf(d, n, mkind, diffp, n_out, n_in, u0, u1, u2, u3):
    dx, dy, dz = d
    nxv, nyv, nzv = n
    dn = dx * nxv + dy * nyv + dz * nzv
    spec = (dx - nxv * (2.0 * dn), dy - nyv * (2.0 * dn), dz - nzv * (2.0 * dn))
    xdx, xdy, xdz = norm3(dx - nxv * dn, dy - nyv * dn, dz - nzv * dn)
    yd = (nyv * xdz - nzv * xdy, nzv * xdx - nxv * xdz, nxv * xdy - nyv * xdx)
    r_ = torch.sqrt(u1)
    th = TWO_PI * u2
    ca, sa = r_ * torch.cos(th), r_ * torch.sin(th)
    zz = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    diff = (xdx * ca + yd[0] * sa + nxv * zz, xdy * ca + yd[1] * sa + nyv * zz,
            xdz * ca + yd[2] * sa + nzv * zz)
    is_diff = (mkind == 1.0) | ((mkind == 2.0) & (u0 < diffp))
    into = dn < 0.0
    n1 = torch.where(into, n_out, n_in)
    n2 = torch.where(into, n_in, n_out)
    c1 = torch.abs(dn)
    nr = (torch.where(into, nxv, -nxv), torch.where(into, nyv, -nyv), torch.where(into, nzv, -nzv))
    n_over = n1 / n2
    c22 = 1.0 - n_over * n_over * (1.0 - c1 * c1)
    tir = c22 < 0.0
    dnr = dx * nr[0] + dy * nr[1] + dz * nr[2]
    refl = tuple(d[k] - nr[k] * (2.0 * dnr) for k in range(3))
    sq22 = torch.sqrt(torch.where(c22 > 0.0, c22, torch.ones_like(c22)))
    k_t = n_over * c1 - sq22
    trans = tuple(torch.where(tir, d[k], d[k] * n_over + nr[k] * k_t) for k in range(3))
    r0 = (n1 - n2) / (n1 + n2)
    r0 = r0 * r0
    cos_term = 1.0 - (trans[0] * nxv + trans[1] * nyv + trans[2] * nzv)
    c2 = cos_term * cos_term
    re = r0 + (1.0 + r0) * (c2 * c2 * cos_term)
    do_refl = tir | (u3 < re)
    is_refr = mkind == 3.0
    out = tuple(torch.where(is_refr, torch.where(do_refl, refl[k], trans[k]),
                            torch.where(is_diff, diff[k], spec[k])) for k in range(3))
    one = torch.ones_like(dx)
    weight = torch.where(is_refr, torch.where(do_refl, one, 1.0 - re), one)
    lobe = torch.where(is_refr, 3, torch.where(is_diff, 1, 2))  # BRANCHES' codes
    return out, weight, lobe


def fused_paths(scene, xs, ys, samples, *, assured: int, max_bounces: int, work=None):
    """The GPU backend's paths as the fused kernels compute them, one
    sample a lane. scene: reference.scene.RefScene."""
    dt = scene.dtype
    cam = scene.cam
    max_thres = float(np.float32(cam[17]))
    inv_thres = float(np.float32(1.0) / np.float32(max_thres))
    state, o, d = primary(cam, xs, ys, samples, dt, fused=True)
    zero = torch.zeros_like(o[0])
    one = torch.ones_like(zero)
    ci, inten, L = [one] * 3, one, [zero] * 3
    active = torch.ones_like(zero, dtype=torch.bool)
    depth = torch.zeros_like(zero)
    where = torch.where
    mesh = scene.mesh
    n_draws = 8 if mesh is not None else 5
    if work is not None:
        work["paths"] += xs.numel()
    for _ in range(max_bounces):
        if not bool(active.any()):
            break
        t_best = inf_like(zero)
        best = torch.zeros_like(xs, dtype=torch.int64)
        for si, row in enumerate(scene.sph_rows):
            t, dirv, disc = sphere_near(o, d, row)
            if work is not None:
                work["near_roots"] += int((active & (disc > 0.0) & (dirv < 0.0)).sum())
            better = t < t_best
            t_best = where(better, t, t_best)
            best = where(better, si, best)
        is_sph = t_best < sentinel(dt)
        on_mesh = torch.zeros_like(active)
        if mesh is not None:
            ai = active.nonzero()[:, 0]
            ao, ad = tuple(c[ai] for c in o), tuple(c[ai] for c in d)
            tm, gm, um, vm = mesh_hit(ao, ad, t_best[ai], mesh["tables"], EPS)
            if work is not None:
                w = walk_work(ao, ad, tm, mesh["tables"], EPS)
                work["slab"] += w["slab"]
                work["tri"] += w["tri"]
            t_m, gid, bu, bv = (full.index_put((ai,), part) for full, part in
                                zip((zero, torch.full_like(best, -1), zero, zero), (tm, gm, um, vm)))
            on_mesh = active & (gid >= 0)
        sph = active & ~on_mesh & is_sph
        state, u = rng.draws(state, n_draws, dt)
        u0, u1, u2, u3, u7 = u[0], u[1], u[2], u[3], u[-1]
        rr_kill = (depth >= float(assured)) & (u7 > max_thres)

        # spheres: the attributes of the winner, a miss's defaults elsewhere
        si = best.clamp(max=len(scene.sph_rows) - 1)
        attr = lambda name, default: where(is_sph, scene.sph[name][si], torch.full_like(zero,
                                                                                         default))
        t_safe = where(sph, t_best, zero)
        p = [o[k] + d[k] * t_safe for k in range(3)]
        c = scene.sph["c"][si]
        sn = norm3(p[0] - c[:, 0], p[1] - c[:, 1], p[2] - c[:, 2])
        n = [where(is_sph, sn[k], zero) for k in range(3)]
        pos_s = [p[k] + n[k] * EPS for k in range(3)]
        nd_s, weight, lobe = _uniform_bsdf(d, n, attr("kind", 0.0), attr("diffp", 0.0),
                                           attr("n_out", 1.0), attr("n_in", 1.0), u0, u1, u2, u3)
        rgb = [attr(f"rgb{k}", 0.0) for k in range(3)]
        em = [attr(f"em{k}", 0.0) for k in range(3)]
        add_em = sph & (attr("has_em", 0.0) > 0.5)
        L = [L[k] + where(add_em, em[k] * (ci[k] * inten), zero) for k in range(3)]
        ci = [where(add_em, ci[k] * rgb[k], ci[k]) for k in range(3)]
        ci = [where(sph, ci[k] * rgb[k], ci[k]) for k in range(3)]

        pos_m = nd_m = None
        if mesh is not None:  # the PBR lobe; a mesh emits nothing
            mi = where(on_mesh, gid, torch.zeros_like(gid))
            nm, mrgb, metal, rough = _mesh_attrs(mesh, mi, bu, bv, dt)
            t_safe = where(on_mesh, t_m, zero)
            pos_m = [o[k] + d[k] * t_safe + nm[k] * EPS for k in range(3)]
            dn = d[0] * nm[0] + d[1] * nm[1] + d[2] * nm[2]
            k2 = 2.0 * dn
            spec = normalize(*(d[k] - nm[k] * k2 for k in range(3)))
            xd = normalize(*(d[k] - nm[k] * dn for k in range(3)), eps=1e-20)
            yd = (nm[1] * xd[2] - nm[2] * xd[1], nm[2] * xd[0] - nm[0] * xd[2],
                  nm[0] * xd[1] - nm[1] * xd[0])
            r_ = torch.sqrt(u1)
            th = TWO_PI * u2
            ca, sa = r_ * torch.cos(th), r_ * torch.sin(th)
            zz = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
            diff = [xd[k] * ca + yd[k] * sa + nm[k] * zz for k in range(3)]
            r0 = 0.04 + (1.0 - 0.04) * metal
            adn = torch.abs(dn)
            a2 = adn * adn
            refl = r0 + (1.0 - r0) * (1.0 - a2 * a2 * adn)
            pbr_diff = u0 < (1.0 - refl)
            sc = normalize(u[4], u[5], u[6], eps=1e-20)
            nd_m = normalize(*(where(pbr_diff, diff[k], spec[k]) + sc[k] * rough for k in range(3)))
            ci = [where(on_mesh, ci[k] * mrgb[k], ci[k]) for k in range(3)]

        hm = sph | on_mesh
        term = hm & rr_kill
        L = [L[k] + where(term, ci[k] * inv_thres * inten, zero) for k in range(3)]
        ci = [where(term, ci[k] * inv_thres, ci[k]) for k in range(3)]
        surv_s, surv_m = sph & ~rr_kill, on_mesh & ~rr_kill
        inten = where(surv_s, inten * weight, inten)
        if mesh is not None:
            o = [where(surv_s, pos_s[k], where(surv_m, pos_m[k], o[k])) for k in range(3)]
            d = [where(surv_s, nd_s[k], where(surv_m, nd_m[k], d[k])) for k in range(3)]
        else:
            o = [where(surv_s, pos_s[k], o[k]) for k in range(3)]
            d = [where(surv_s, nd_s[k], d[k]) for k in range(3)]
        if work is not None:
            work["lane_bounces"] += int(active.sum())
            code = where(on_mesh, 5, where(sph, where(term, 4, lobe), 0))[active]
            for i, b in enumerate(BRANCHES):
                work["by_branch"][b] += int((code == i).sum())
        survive = surv_s | surv_m
        depth = depth + survive.to(depth.dtype)
        active = survive
    return torch.stack(L, dim=1)


# --- the integrator's formulation --------------------------------------------

def _diff_dir(d, n, u, w):
    dn = _dot(d, n)
    xd = normalize(*(d[k] - n[k] * dn for k in range(3)), eps=1e-20)
    yd = (n[1] * xd[2] - n[2] * xd[1], n[2] * xd[0] - n[0] * xd[2], n[0] * xd[1] - n[1] * xd[0])
    r = torch.sqrt(u)
    th = TWO_PI * w
    rc, rs = r * torch.cos(th), r * torch.sin(th)
    z = torch.sqrt(torch.clamp(1.0 - u, min=0.0))
    return tuple(xd[k] * rc + yd[k] * rs + n[k] * z for k in range(3))


def _reflect(d, n):
    k = 2.0 * _dot(d, n)
    return tuple(d[i] - n[i] * k for i in range(3))


def _refract_cpu(d, n, n_out, n_in, u):
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
    cos_term = 1.0 - torch.where(into, c1, _dot(trns, n))
    re = r0 + (1.0 + r0) * _pow5(cos_term)
    do_refl = tir | (u < re)
    one = torch.ones_like(re)
    return _where3(do_refl, refl_d, trns), torch.where(do_refl, torch.where(tir, one, re), 1.0 - re)


def integrator_paths(scene, xs, ys, samples, *, assured: int, max_bounces: int, work=None):
    """The CPU backend's paths as the integrator computes them, one
    sample a lane (no direct-light sampling, no cube map)."""
    dt = scene.dtype
    state, ro, rd = primary(scene.cam, xs, ys, samples, dt, fused=False)
    zero = torch.zeros_like(ro[0])
    one = torch.ones_like(zero)
    L, ci = (zero,) * 3, (one,) * 3
    active = torch.ones_like(zero, dtype=torch.bool)
    bounce = torch.zeros_like(xs, dtype=torch.int32)
    mesh = scene.mesh
    S = len(scene.sph_rows)
    where = torch.where
    if work is not None:
        work["paths"] += xs.numel()
    for _ in range(max_bounces):
        if not bool(active.any()):
            break
        t_best = inf_like(zero)
        kind = torch.zeros_like(bounce, dtype=torch.int64)
        idx = torch.zeros_like(kind)
        bu, bv = zero, zero
        if S:
            c = tuple(scene.sph["c"][:, k:k + 1] for k in range(3))
            ts = sphere_roots(ro, rd, c, scene.sph["r"][:, None], "cpu")
            ts = where(ts >= CPU_GUARD, ts, inf_like(ts))
            tmin, amin = ts.min(dim=0)
            better = tmin < t_best
            t_best = where(better, tmin, t_best)
            kind = where(better, 1, kind)
            idx = where(better, amin, idx)
        if mesh is not None:
            ai = active.nonzero()[:, 0]
            ao, ad = tuple(c[ai] for c in ro), tuple(c[ai] for c in rd)
            tm, gm, um, vm = mesh_hit(ao, ad, t_best[ai], mesh["tables"], CPU_GUARD)
            if work is not None:
                w = walk_work(ao, ad, tm, mesh["tables"], CPU_GUARD)
                work["slab"] += w["slab"]
                work["tri"] += w["tri"]
            won = torch.zeros_like(active).index_put((ai,), gm >= 0)
            put = lambda full, part: full.index_put((ai,), part)
            t_best = where(won, put(t_best, tm), t_best)
            kind = where(won, 3, kind)
            idx = where(won, put(idx, gm), idx)
            bu, bv = where(won, put(bu, um), bu), where(won, put(bv, vm), bv)

        if mesh is not None:
            state, u = rng.draws(state, 8, dt)
        else:
            state, u5 = rng.draws(state, 5, dt)
            u = [u5[0], u5[1], u5[2], u5[3], u5[1], u5[2], u5[3], u5[4]]
        u0, u1, u2, u3, u7 = u[0], u[1], u[2], u[3], u[7]
        hit = kind != 0
        is_sph, is_mt = kind == 1, kind == 3
        t_safe = where(torch.isfinite(t_best), t_best, zero)
        perfect = tuple(ro[k] + rd[k] * t_safe for k in range(3))
        norm = rgb = emissive = (zero, zero, zero)
        mkind = torch.zeros_like(kind)
        diffp, n_out, n_in, metal, rough = zero, one, one, zero, zero
        if S:
            si = idx.clamp(0, S - 1)
            cs = scene.sph["c"][si]
            norm = _where3(is_sph, normalize(*(perfect[k] - cs[:, k] for k in range(3)), eps=1e-20),
                           norm)
            rgb = _where3(is_sph, tuple(scene.sph[f"rgb{k}"][si] for k in range(3)), rgb)
            emissive = _where3(is_sph, tuple(scene.sph[f"em{k}"][si] for k in range(3)), emissive)
            mkind = where(is_sph, scene.sph["kind_i"][si], mkind)
            diffp = where(is_sph, scene.sph["diffp"][si], diffp)
            n_out = where(is_sph, scene.sph["n_out"][si], n_out)
            n_in = where(is_sph, scene.sph["n_in"][si], n_in)
        if mesh is not None:
            mi = where(is_mt, idx.clamp(0, mesh["n_tris"] - 1), torch.zeros_like(idx))
            nm, mrgb, mmet, mrgh = _mesh_attrs(mesh, mi, bu, bv, dt)
            norm = _where3(is_mt, nm, norm)
            rgb = _where3(is_mt, mrgb, rgb)
            metal = where(is_mt, mmet, metal)
            rough = where(is_mt, mrgh, rough)
        pos = tuple(perfect[k] + norm[k] * EPS for k in range(3))
        spec_d = normalize(*_reflect(rd, norm))
        diff_d = _diff_dir(rd, norm, u1, u2)
        refr_d, refr_w = _refract_cpu(rd, norm, n_out, n_in, u3)
        ds_diff = u0 < diffp
        uni_d = _where3(mkind == 0, spec_d, _where3(
            mkind == 1, diff_d, _where3(mkind == 2, _where3(ds_diff, diff_d, spec_d), refr_d)))
        uni_w = where(mkind == 3, refr_w, one)
        r0 = 0.04 + (1.0 - 0.04) * metal
        refl = r0 + (1.0 - r0) * (1.0 - _pow5(torch.abs(_dot(rd, norm))))
        pbr_base = _where3(u0 < (1.0 - refl), diff_d, spec_d)
        scatter = normalize(u[4], u[5], u[6], eps=1e-20)
        pbr_d = normalize(*(pbr_base[k] + scatter[k] * rough for k in range(3)))
        new_d = _where3(is_mt, pbr_d, uni_d)
        weight = where(is_mt, one, uni_w)

        ah = active & hit
        L = tuple(L[k] + where(ah, emissive[k] * ci[k], zero) for k in range(3))
        rr_due = bounce > assured
        rr_pass = where(rr_due, u7 < CPU_RR, True)
        atten = where(rr_due, torch.full_like(zero, CPU_RR), one)
        survive = ah & rr_pass
        w = weight / atten
        ci = _where3(survive, tuple(ci[k] * (rgb[k] * w) for k in range(3)), ci)
        if work is not None:
            work["lane_bounces"] += int(active.sum())
            lobe = where(mkind == 3, 3, where((mkind == 1) | ((mkind == 2) & ds_diff), 1, 2))
            code = where(is_mt, 5, where(hit, where(rr_pass, lobe, 4), 0))[active]
            for i, b in enumerate(BRANCHES):
                work["by_branch"][b] += int((code == i).sum())
        ro = _where3(survive, pos, ro)
        rd = _where3(survive, new_d, rd)
        bounce = bounce + survive.to(torch.int32)
        active = survive
    return torch.stack(L, dim=1)
