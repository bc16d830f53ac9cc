"""The a380-class mesh scene, built procedurally.

The reference's a380 asset (127,749 triangles, README.md:173) is not in
this repository, so the JAX package benchmarks a stand-in of the same
triangle count: `scripts/bench_mesh.py` (`_surface` :73-104, `make_mesh`
:107-155, `a380_cam_scheme` :184-207). That script imports jax, so this
is the port's own copy, producing the same arrays from the same seeds:
a displaced, flattened sphere surface of exactly 127,749 triangles,
split into 20 primitives with procedural 1024x1024 u8 base-colour
textures (the script's BENCH_MESH_TEXTURES=20), under the a380.yml
camera and sun at 1216x608, assured depth 5, max_thres 0.5.
"""
from __future__ import annotations

import numpy as np

from .config import ModelMember, Scheme, Tagged, parse_scheme
from .gltf import LoadedMesh, Primitive, TextureData

N_TRIS = 127_749  # the a380 element count
WIDTH, HEIGHT = 1216, 608
N_TEXTURES = 20
TEX_SIZE = 1024


def _surface(n_tris: int):
    """A displaced-sphere surface triangulation with exactly n_tris
    triangles. Returns (v0, e1, e2), each (n_tris, 3) f32."""
    nu = 360
    nv = -(-n_tris // (2 * nu)) + 2
    uu = np.linspace(0, 2 * np.pi, nu, endpoint=False)
    vv = np.linspace(0.05, np.pi - 0.05, nv)
    U, V = np.meshgrid(uu, vv, indexing="ij")
    r = 24.0 * (1.0 + 0.18 * np.sin(3 * U) * np.cos(2 * V)
                + 0.08 * np.sin(7 * U + 1.3) * np.sin(5 * V))
    X = r * np.sin(V) * np.cos(U)
    Z = r * np.sin(V) * np.sin(U)
    Y = 0.3 * r * np.cos(V)  # flattened: an aircraft-like slab
    verts = np.stack([X, Y, Z], -1).reshape(nu * nv, 3)
    i = np.arange(nu)[:, None]
    j = np.arange(nv - 1)[None, :]
    a = i * nv + j
    b = ((i + 1) % nu) * nv + j
    quads_a = np.stack([a, b, a + 1], -1).reshape(-1, 3)
    quads_b = np.stack([b, b + 1, a + 1], -1).reshape(-1, 3)
    idx = np.concatenate([quads_a, quads_b], 0)[:n_tris]
    v0 = verts[idx[:, 0]]
    e1 = verts[idx[:, 1]] - v0
    e2 = verts[idx[:, 2]] - v0
    return v0.astype(np.float32), e1.astype(np.float32), e2.astype(np.float32)


def make_mesh(n_tris: int = N_TRIS, n_textures: int = N_TEXTURES,
              tex_size: int = TEX_SIZE) -> LoadedMesh:
    """The surface as n_textures primitives (one when 0), each with its
    own tex_size^2 u8 base-colour texture (seed 1000 + primitive) and
    per-vertex uvs, metal 0.6, rough 0.35."""
    v0, e1, e2 = _surface(n_tris)
    norms = np.cross(e1, e2)
    norms /= np.maximum(np.linalg.norm(norms, axis=1, keepdims=True), 1e-9)
    n_prims = max(1, n_textures)
    bounds = np.linspace(0, n_tris, n_prims + 1).astype(np.int64)
    prims = []
    for p in range(n_prims):
        lo_i, hi_i = bounds[p], bounds[p + 1]
        m = int(hi_i - lo_i)
        if m == 0:
            continue
        sv0, se1, se2 = v0[lo_i:hi_i], e1[lo_i:hi_i], e2[lo_i:hi_i]
        poses = np.concatenate([sv0, sv0 + se1, sv0 + se2], 0).astype(np.float32)
        idx = np.stack([np.arange(m), np.arange(m) + m, np.arange(m) + 2 * m],
                       axis=1).astype(np.int32)
        rgb_tex = None
        if n_textures:
            prng = np.random.default_rng(1000 + p)
            raw = prng.integers(51, 256, (tex_size, tex_size, 3), dtype=np.uint8)
            coords = prng.uniform(0.0, 1.0, (3 * m, 2)).astype(np.float32)
            rgb_tex = TextureData(pixels=raw.astype(np.float32) / 255.0, coords=coords,
                                  pixels_raw=raw)
        prims.append(Primitive(
            poses=poses,
            norms=np.concatenate([norms[lo_i:hi_i]] * 3, 0).astype(np.float32),
            indices=idx,
            rgb_factor=np.array([0.7, 0.72, 0.75], np.float32),
            rgb_tex=rgb_tex,
            metal_factor=0.6,
            rough_factor=0.35,
        ))
    return LoadedMesh(primitives=prims, trans_mat=np.eye(4, dtype=np.float32))


def a380_cam_scheme(width: int = WIDTH, height: int = HEIGHT, spp: int = 16) -> Scheme:
    """The a380.yml camera and sun over no other member."""
    raw = {
        "render_info": {
            "width": width, "height": height, "samps_per_pix": spp, "kd_tree_depth": 17,
            "rad_info": {
                "debug_single_ray": False, "dir_light_samp": False,
                "russ_roull_info": {"assured_depth": 5, "max_thres": 0.5},
            },
            "use_gpu": True,
        },
        "cam": {
            "d": [0, 0, 6], "up": [0, 1, 0], "view_eulers": [-0.6, 0.1, 0],
            "o": [0, -15, -30], "screen_width": 10.0, "screen_height": 5.0,
        },
        "scene_members": [
            Tagged("Sphere", {
                "c": [2500, 2200, -200], "r": 1200,
                "coloring": Tagged("Solid", [0, 0, 0]),
                "mat": {"divert_ray": "Diff", "emissive": [1.0, 1.0, 1.0]},
            }),
        ],
    }
    return parse_scheme(raw)


def a380_scheme(width: int = WIDTH, height: int = HEIGHT, spp: int = 16) -> Scheme:
    """The a380-class scene: the camera and sun plus the procedural mesh."""
    scheme = a380_cam_scheme(width, height, spp)
    scheme.scene_members.append(ModelMember(path="<procedural a380-class surface>",
                                            loaded=[make_mesh()]))
    return scheme
