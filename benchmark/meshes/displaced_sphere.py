"""Mesh kind "displaced_sphere": a displaced, flattened sphere surface of
exactly `n_tris` triangles split into `n_textures` primitives, each with
its own u8 base-colour texture of `tex_size`^2 texels (seed
`texture_seed` + primitive) and seeded per-vertex uvs: the stand-in for
the reference's a380 asset (see configs/a380.json)."""
from __future__ import annotations

import numpy as np


def _surface(n_tris: int, radius: float, seams: int):
    """A displaced-sphere triangulation of exactly n_tris triangles:
    (v0, e1, e2), each (n_tris, 3) f32."""
    nu = seams
    nv = -(-n_tris // (2 * nu)) + 2
    uu = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    vv = np.linspace(0.05, np.pi - 0.05, nv)
    U, V = np.meshgrid(uu, vv, indexing="ij")
    r = radius * (1.0 + 0.18 * np.sin(3 * U) * np.cos(2 * V)
                  + 0.08 * np.sin(7 * U + 1.3) * np.sin(5 * V))
    X = r * np.sin(V) * np.cos(U)
    Z = r * np.sin(V) * np.sin(U)
    Y = 0.3 * r * np.cos(V)
    verts = np.stack([X, Y, Z], -1).reshape(nu * nv, 3)
    i = np.arange(nu)[:, None]
    j = np.arange(nv - 1)[None, :]
    a = i * nv + j
    b = ((i + 1) % nu) * nv + j
    quads_a = np.stack([a, b, a + 1], -1).reshape(-1, 3)
    quads_b = np.stack([b, b + 1, a + 1], -1).reshape(-1, 3)
    idx = np.concatenate([quads_a, quads_b], 0)[:n_tris]
    v0 = verts[idx[:, 0]]
    return (v0.astype(np.float32), (verts[idx[:, 1]] - v0).astype(np.float32),
            (verts[idx[:, 2]] - v0).astype(np.float32))


def make(m: dict) -> list:
    """The mesh's primitives (scenes.RawScene.primitives)."""
    n_tris, n_tex, size = int(m["n_tris"]), int(m["n_textures"]), int(m["tex_size"])
    v0, e1, e2 = _surface(n_tris, float(m["radius"]), int(m["seams"]))
    norms = np.cross(e1, e2)
    norms /= np.maximum(np.linalg.norm(norms, axis=1, keepdims=True), 1e-9)
    bounds = np.linspace(0, n_tris, max(1, n_tex) + 1).astype(np.int64)
    prims = []
    for p in range(max(1, n_tex)):
        lo, hi = bounds[p], bounds[p + 1]
        k = int(hi - lo)
        if k == 0:
            continue
        sv0, se1, se2 = v0[lo:hi], e1[lo:hi], e2[lo:hi]
        tex = coords = None
        if n_tex:
            g = np.random.default_rng(int(m["texture_seed"]) + p)
            tex = g.integers(51, 256, (size, size, 3), dtype=np.uint8)
            coords = g.uniform(0.0, 1.0, (3 * k, 2)).astype(np.float32)
        prims.append(dict(
            poses=np.concatenate([sv0, sv0 + se1, sv0 + se2], 0).astype(np.float32),
            norms=np.concatenate([norms[lo:hi]] * 3, 0).astype(np.float32),
            indices=np.stack([np.arange(k), np.arange(k) + k, np.arange(k) + 2 * k],
                             axis=1).astype(np.int32),
            rgb_factor=np.asarray(m["rgb_factor"], np.float32),
            metal=float(m["metal"]), rough=float(m["rough"]), texture=tex, coords=coords))
    return prims
