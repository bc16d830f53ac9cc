"""Brute-force closest hit over the packed sphere and free-triangle tables.

Mirrors `raytrace_tpu/ops/pallas/trace_kernel.py::closest_sph_ft`
(:229-324; = `render/integrator._sphere_t` / `_triangle_t` :94-131 in
gpu mode) with the permissive SceneHints, which select every attribute:

- spheres: near root only, hit when disc > 0 and near > 0;
- free triangles: Moller-Trumbore with the |det| >= EPS and t >= EPS
  guards;
- a running strict-< select of t over spheres first, then free
  triangles, in packed row order, so exact-t ties keep the earlier row.

Instead of selecting every attribute at every primitive, the winner's
row index is tracked and its attributes are gathered once after the
loop: the same values, because a select chain keeps exactly the last
strictly-closer primitive's row.
"""
from __future__ import annotations

import numpy as np
import torch

EPS = float(np.float32(1e-4))
INF = float(np.float32(3.4e38))  # MAXF-like sentinel, not inf

# sphere table columns (S, 15) and free-triangle columns (F, 23)
SC = dict(cx=0, cy=1, cz=2, r=3, rr=4, gg=5, bb=6, em_r=7, em_g=8, em_b=9,
          has_em=10, kind=11, diffp=12, n_out=13, n_in=14)
FC = dict(v0x=0, v0y=1, v0z=2, e1x=3, e1y=4, e1z=5, e2x=6, e2y=7, e2z=8,
          nx=9, ny=10, nz=11, rr=12, gg=13, bb=14, em_r=15, em_g=16, em_b=17,
          has_em=18, kind=19, diffp=20, n_out=21, n_in=22)
# material attributes shared by both tables, with their miss defaults
_MAT = dict(rgb_r=("rr", 0.0), rgb_g=("gg", 0.0), rgb_b=("bb", 0.0),
            em_r=("em_r", 0.0), em_g=("em_g", 0.0), em_b=("em_b", 0.0),
            has_em=("has_em", 0.0), mkind=("kind", 0.0), diffp=("diffp", 0.0),
            n_out=("n_out", 1.0), n_in=("n_in", 1.0))


def sphere_disc(ox, oy, oz, dx, dy, dz, row):
    """(dirv, disc) of the rays against the sphere `row` (a table row):
    a ray's line meets the sphere where disc > 0, its near root at
    -dirv - sqrt(disc)."""
    ocx, ocy, ocz = ox - row[0], oy - row[1], oz - row[2]
    dirv = dx * ocx + dy * ocy + dz * ocz
    consts = ocx * ocx + ocy * ocy + ocz * ocz - row[3] * row[3]
    return dirv, dirv * dirv - consts


def sphere_t(ox, oy, oz, dx, dy, dz, row):
    """Near-root distance to the sphere `row` (a table row), INF on miss."""
    dirv, disc = sphere_disc(ox, oy, oz, dx, dy, dz, row)
    pos = disc > 0.0
    sq = torch.sqrt(torch.where(pos, disc, torch.ones_like(disc)))
    near = -dirv - sq
    return torch.where(pos & (near > 0.0), near, torch.full_like(near, INF))


def triangle_tuv(ox, oy, oz, dx, dy, dz, v0, e1, e2):
    """Moller-Trumbore (the JAX integrator's `_triangle_t`, :117-131):
    rays and the triangle's v0 / e1 / e2 (3-tuples) are broadcastable
    tensors or floats. Returns (t, u, w); t is INF on a miss."""
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = torch.abs(det) >= EPS
    one = torch.ones_like(det)
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, one), torch.zeros_like(det))
    hx, hy, hz = ox - v0[0], oy - v0[1], oz - v0[2]
    u = inv_det * (hx * pvx + hy * pvy + hz * pvz)
    qx = hy * e1z - hz * e1y
    qy = hz * e1x - hx * e1z
    qz = hx * e1y - hy * e1x
    w = inv_det * (dx * qx + dy * qy + dz * qz)
    t = inv_det * (e2x * qx + e2y * qy + e2z * qz)
    ok = ok & (u >= 0.0) & (u <= 1.0) & (w >= 0.0) & (u + w <= 1.0) & (t >= EPS)
    return torch.where(ok, t, torch.full_like(t, INF)), u, w


def triangle_t(ox, oy, oz, dx, dy, dz, row):
    """Moller-Trumbore distance to the free triangle `row`, INF on miss."""
    return triangle_tuv(ox, oy, oz, dx, dy, dz, row[0:3], row[3:6], row[6:9])[0]


def closest_sph_ft(sph, ft, ox, oy, oz, dx, dy, dz, *, n_sph: int, n_ft: int):
    """sph (>=n_sph, 15), ft (>=n_ft, 23) f32 tables; rays as (N,)
    tensors. Returns a dict of (N,) tensors: t_best, kind (0 none /
    1 sphere / 2 free triangle), scx/scy/scz (hit sphere center),
    nxv/nyv/nzv (hit triangle's stored normal), rgb_*, em_*, has_em,
    mkind, diffp, n_out, n_in — zeros (n_out = n_in = 1) where the
    winner is of the other kind or there is none."""
    t_best = torch.full_like(dx, INF)
    kind = torch.zeros_like(dx, dtype=torch.int64)
    best = torch.zeros_like(dx, dtype=torch.int64)
    sph_rows = sph.tolist()
    ft_rows = ft.tolist()
    for si in range(n_sph):
        t = sphere_t(ox, oy, oz, dx, dy, dz, sph_rows[si])
        better = t < t_best
        t_best = torch.where(better, t, t_best)
        kind = torch.where(better, 1, kind)
        best = torch.where(better, si, best)
    for fi in range(n_ft):
        t = triangle_t(ox, oy, oz, dx, dy, dz, ft_rows[fi])
        better = t < t_best
        t_best = torch.where(better, t, t_best)
        kind = torch.where(better, 2, kind)
        best = torch.where(better, fi, best)

    is_s, is_f = kind == 1, kind == 2
    srow = sph[best.clamp(max=sph.shape[0] - 1)]
    frow = ft[best.clamp(max=ft.shape[0] - 1)]
    zero = torch.zeros_like(dx)
    out = dict(t_best=t_best, kind=kind.to(dx.dtype))
    for k, c in (("scx", "cx"), ("scy", "cy"), ("scz", "cz")):
        out[k] = torch.where(is_s, srow[:, SC[c]], zero)
    for k, c in (("nxv", "nx"), ("nyv", "ny"), ("nzv", "nz")):
        out[k] = torch.where(is_f, frow[:, FC[c]], zero)
    for k, (c, default) in _MAT.items():
        miss = torch.full_like(dx, default)
        out[k] = torch.where(is_s, srow[:, SC[c]], torch.where(is_f, frow[:, FC[c]], miss))
    return out
