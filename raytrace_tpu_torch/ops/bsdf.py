"""Uniform-material BSDF sampling for a sphere / free-triangle hit.

Mirrors `raytrace_tpu/ops/pallas/trace_kernel.py::uniform_bsdf`
(:327-405; = `render/integrator._diff_dir` / `_refract_dir` :379-426 in
gpu mode) with the permissive SceneHints (every lobe evaluated, then
selected by material kind):

- Spec (kind 0): mirror reflection, not renormalized (d and n are unit);
- Diff (1), and DiffSpec (2) when u0 < diffp: cosine-weighted direction
  in the frame (normalize(d - n(d.n)), n x that, n);
- Dielectric (3), gpu mode: Snell refraction with the reference's
  Schlick quirks kept — (1 + r0) and cos_term = 1 - t.n with the
  UNflipped normal — so it nearly always reflects on entry; the weight
  is 1 on reflection and 1 - re on transmission.
"""
from __future__ import annotations

import torch

from .raygen import TWO_PI, norm3


def uniform_bsdf(dx, dy, dz, nxv, nyv, nzv, mkind, diffp, n_out, n_in, u0, u1, u2, u3):
    """Returns (ndx, ndy, ndz, weight), each an (N,) tensor."""
    dn = dx * nxv + dy * nyv + dz * nzv
    sdx, sdy, sdz = dx - nxv * (2.0 * dn), dy - nyv * (2.0 * dn), dz - nzv * (2.0 * dn)

    xdx, xdy, xdz = norm3(dx - nxv * dn, dy - nyv * dn, dz - nzv * dn)
    ydx = nyv * xdz - nzv * xdy
    ydy = nzv * xdx - nxv * xdz
    ydz = nxv * xdy - nyv * xdx
    r_ = torch.sqrt(u1)
    th = TWO_PI * u2
    ca, sa = r_ * torch.cos(th), r_ * torch.sin(th)
    zz = torch.sqrt(torch.clamp(1.0 - u1, min=0.0))
    ddx = xdx * ca + ydx * sa + nxv * zz
    ddy = xdy * ca + ydy * sa + nyv * zz
    ddz = xdz * ca + ydz * sa + nzv * zz
    is_diff = (mkind == 1.0) | ((mkind == 2.0) & (u0 < diffp))

    into = dn < 0.0
    n1 = torch.where(into, n_out, n_in)
    n2 = torch.where(into, n_in, n_out)
    c1 = torch.abs(dn)
    nrx = torch.where(into, nxv, -nxv)
    nry = torch.where(into, nyv, -nyv)
    nrz = torch.where(into, nzv, -nzv)
    n_over = n1 / n2
    c22 = 1.0 - n_over * n_over * (1.0 - c1 * c1)
    tir = c22 < 0.0
    dnr = dx * nrx + dy * nry + dz * nrz
    refx = dx - nrx * (2.0 * dnr)
    refy = dy - nry * (2.0 * dnr)
    refz = dz - nrz * (2.0 * dnr)
    sq22 = torch.sqrt(torch.where(c22 > 0.0, c22, torch.ones_like(c22)))
    k_t = n_over * c1 - sq22
    tx = torch.where(tir, dx, dx * n_over + nrx * k_t)
    ty = torch.where(tir, dy, dy * n_over + nry * k_t)
    tz = torch.where(tir, dz, dz * n_over + nrz * k_t)
    r0 = (n1 - n2) / (n1 + n2)
    r0 = r0 * r0
    cos_term = 1.0 - (tx * nxv + ty * nyv + tz * nzv)
    c2 = cos_term * cos_term
    re = r0 + (1.0 + r0) * (c2 * c2 * cos_term)
    do_refl = tir | (u3 < re)
    is_refr = mkind == 3.0

    def pick(refl, trans, diff, spec):
        return torch.where(is_refr, torch.where(do_refl, refl, trans),
                           torch.where(is_diff, diff, spec))

    one = torch.ones_like(dx)
    weight = torch.where(is_refr, torch.where(do_refl, one, 1.0 - re), one)
    return pick(refx, tx, ddx, sdx), pick(refy, ty, ddy, sdy), pick(refz, tz, ddz, sdz), weight
