"""The a380-class mesh scene and a cube-map sky, built procedurally.

The reference's a380 asset (127,749 triangles, README.md:173) is not in
this repository, so the JAX package benchmarks a stand-in of the same
triangle count: `scripts/bench_mesh.py` (`_surface` :73-104, `make_mesh`
:107-155, `a380_cam_scheme` :184-207). That script imports jax, so this
is the port's own copy, producing the same arrays from the same seeds:
a displaced, flattened sphere surface of exactly 127,749 triangles,
split into 20 primitives with procedural 1024x1024 u8 base-colour
textures (the script's BENCH_MESH_TEXTURES=20), under the a380.yml
camera and sun at 1216x608, assured depth 5, max_thres 0.5.

The sky scenes have no asset here either (the reference's
outside_spheres.yml and biplane's six 2048x2048 faces are not in the
repository): `sky_cubemap` writes six u8 PNG faces of biplane's size, in
which a wrong face or texel shows, and `outdoor_scheme` puts spheres
under them, open to the sky, as the offline stand-in for
outside_spheres.yml. Both are fixtures like models/walled.py.

Nor does it hold a scene of many copies of one asset, the case of the JAX
package's two-level instancing (README.md:405-415: a composite of 17
biplane instances, 124k triangles): `fleet_scheme` places 17 copies of a
7,300-triangle cut of the surface (`make_mesh(7300, 4)`, one LoadedMesh
shared by every member, so its four textures enter the texel pool once)
under the a380 camera and sun, each with its own seeded translation,
scale in 0.8-1.2 and non-zero Euler angles, in three rows facing the
camera that cover about 97% of the frame.

Nor does the repository hold an animated scheme: `animated_walled_scheme`
keyframes two of walled's spheres through the bezier, polynomial, Step and
Hold easings, and `animated_a380_scheme` moves and turns the a380-class
surface, each over one second (`framerate` frames).
"""
from __future__ import annotations

import os

import numpy as np

from ..utils.image import save_png
from .config import (FACE_ORDER, Anim, CubeMapFace, CubeMapMember, Keyframe, ModelMember, Scheme,
                     Tagged, parse_scheme)
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


FLEET_INSTANCES = 17
FLEET_TRIS = 7300  # 17 x 7,300 = 124,100 triangles
FLEET_ROWS = (6, 6, 5)  # instances a row, bottom to top
FLEET_DEPTH, FLEET_COL, FLEET_ROW = 110.0, 34.0, 30.0  # along the view, apart across it
FLEET_SEED = 17  # the draws of each instance's placement


def fleet_scheme(width: int = WIDTH, height: int = HEIGHT, spp: int = 16) -> Scheme:
    """FLEET_INSTANCES copies of make_mesh(FLEET_TRIS, n_textures=4) under
    the a380 camera and sun: rows of FLEET_ROWS instances about
    FLEET_DEPTH along the camera's view, FLEET_COL and FLEET_ROW apart
    across it, each rolled to face the camera (its flat side, the
    surface's y axis, toward it) and turned, scaled (0.8-1.2) and moved
    by draws from FLEET_SEED. The members share one `loaded` list and one
    `path`, so build_scene builds the instancing tables."""
    from .camera import build_camera

    scheme = a380_cam_scheme(width, height, spp)
    cam = build_camera(scheme.cam, width, height)
    fwd = cam.d / np.linalg.norm(cam.d)
    loaded = [make_mesh(FLEET_TRIS, n_textures=4)]
    g = np.random.default_rng(FLEET_SEED)
    for row, n in enumerate(FLEET_ROWS):
        for col in range(n):
            across = (col - (n - 1) / 2) * FLEET_COL + g.uniform(-3, 3)
            rise = (row - 1) * FLEET_ROW + g.uniform(-3, 3)
            pos = cam.o + (FLEET_DEPTH + g.uniform(-12, 12)) * fwd + across * cam.right \
                + rise * cam.up
            euler = [-2.17 + g.uniform(-0.25, 0.25), g.uniform(-0.3, 0.3), g.uniform(-0.3, 0.3)]
            scheme.scene_members.append(ModelMember(
                path="<procedural fleet asset>", loaded=loaded,
                uniform_scale=float(g.uniform(0.8, 1.2)),
                translation=pos.astype(np.float32), euler_angles=np.array(euler, np.float32)))
    return scheme


SKY_SIZE = 2048  # biplane's faces: six 2048x2048 u8 faces, 75.5 MB (BENCH_NOTES.md:517)
SKY_GRID = 64  # a dark grid line every SKY_GRID texels
# a hue per face, in FACE_ORDER
SKY_HUES = np.array([[255, 96, 64], [64, 160, 255], [96, 255, 96], [255, 224, 64],
                     [160, 96, 255], [64, 255, 224]], np.float32)
# the faces whose uv scales are not (1, 1): a mirrored u, a stretched and mirrored v
SKY_SCALES = {"pos_x": (-1.0, 1.0), "neg_y": (0.75, -1.25)}


def sky_face(index: int, size: int, seed: int = 0) -> np.ndarray:
    """Face `index` of FACE_ORDER as a (size, size, 3) u8 array (row 0 is
    the first texel row): the face's hue times a gradient along u and v,
    a dark line every SKY_GRID texels and seeded noise of up to 23 per
    channel, so that neighbouring texels and faces differ."""
    v, u = np.mgrid[0:size, 0:size].astype(np.float32)
    grad = 0.25 + 0.5 * u / max(size - 1, 1) + 0.25 * v / max(size - 1, 1)
    img = SKY_HUES[index] * grad[..., None]
    img[(u % SKY_GRID == 0) | (v % SKY_GRID == 0)] = 16.0
    noise = np.random.default_rng(seed * 6 + index).integers(0, 24, (size, size, 3))
    return np.clip(img + noise, 0, 255).astype(np.uint8)


def sky_cubemap(face_dir: str, size: int = SKY_SIZE, seed: int = 0) -> CubeMapMember:
    """Writes the six faces (`sky_face`) as PNGs into face_dir and returns
    the cube map member that names them, with SKY_SCALES."""
    faces = {}
    for i, name in enumerate(FACE_ORDER):
        path = os.path.join(face_dir, f"sky_{name}.png")
        save_png(path, sky_face(i, size, seed)[::-1])  # save_png writes row 0 last
        faces[name] = CubeMapFace(path, *SKY_SCALES.get(name, (1.0, 1.0)))
    return CubeMapMember(**faces)


def outdoor_scheme(sky: CubeMapMember, width: int = 1200, height: int = 600,
                   spp: int = 16) -> Scheme:
    """Spheres under the sky: a ground sphere, a mirror, a dielectric, a
    diffuse and an emissive sphere, open to the cube map `sky`, in gpu
    semantics (assured depth 5, max_thres 0.5) at the walled camera."""
    def sphere(c, r, rgb, mat):
        return Tagged("Sphere", {"c": c, "r": r, "coloring": Tagged("Solid", rgb), "mat": mat})

    raw = {
        "render_info": {
            "width": width, "height": height, "samps_per_pix": spp,
            "rad_info": {"russ_roull_info": {"assured_depth": 5, "max_thres": 0.5}},
            "use_gpu": True,
        },
        "cam": {"d": [0, 0, -5.0], "o": [0, 0.5, 0], "up": [0, 1, 0],
                "screen_width": 10.0, "screen_height": 5.0},
        "scene_members": [
            sphere([0.0, -1000.0, -10.0], 999.0, [0.6, 0.6, 0.55], {"divert_ray": "Diff"}),
            sphere([-2.6, 0.0, -7.0], 1.0, [0.95, 0.95, 0.95], {"divert_ray": "Spec"}),
            sphere([0.0, 0.0, -6.0], 1.0, [1.0, 1.0, 1.0],
                   {"divert_ray": Tagged("Dielectric", {"n_out": 1.0, "n_in": 1.5})}),
            sphere([2.6, 0.0, -7.0], 1.0, [0.8, 0.35, 0.2], {"divert_ray": "Diff"}),
            sphere([0.0, 3.0, -11.0], 1.0, [0.0, 0.0, 0.0],
                   {"divert_ray": "Diff", "emissive": [6.0, 6.0, 5.0]}),
        ],
    }
    scheme = parse_scheme(raw)
    scheme.scene_members.append(sky)
    return scheme


def _keyframes(*rows) -> Anim:
    """Anim of (time, translation, euler_angles or None, ease_type) rows."""
    return Anim(keyframes=[
        Keyframe(translation=np.asarray(t, np.float32), time=float(time),
                 euler_angles=None if e is None else np.asarray(e, np.float32), ease_type=ease)
        for time, t, e, ease in rows])


def animated_walled_scheme(width: int = 1200, height: int = 600, spp: int = 64,
                           framerate: float = 8.0) -> Scheme:
    """The walled scheme (animation: true) with two spheres keyframed over
    one second: the mirror sphere (member 1) through EaseInOut (the CSS
    bezier) and then EaseInCubic, the DiffSpec sphere (member 2) through
    Step and then Hold; framerate frames."""
    from .walled import walled_scheme

    scheme = walled_scheme(width, height)
    info = scheme.render_info
    info.samps_per_pix, info.animation, info.framerate = spp, True, float(framerate)
    scheme.scene_members[1].animation = _keyframes(
        (0.0, [-3.0, 0.0, -6.0], None, "EaseInOut"), (0.5, [-2.0, 1.0, -6.5], None, "EaseInCubic"),
        (1.0, [-1.0, -0.5, -7.0], None, "Linear"))
    scheme.scene_members[2].animation = _keyframes(
        (0.0, [1.0, -1.5, -6.0], None, "Step"), (0.4, [2.0, -1.0, -6.0], None, "Hold"),
        (1.0, [0.0, -1.5, -5.5], None, "Linear"))
    return scheme


def animated_a380_scheme(width: int = WIDTH, height: int = HEIGHT, spp: int = 16,
                         framerate: float = 4.0, mesh: LoadedMesh | None = None) -> Scheme:
    """The a380-class scene (animation: true) with the surface (`mesh`,
    by default make_mesh()) moved and turned over one second: translation
    and Euler angles through EaseInOutQuad and then Linear; framerate
    frames."""
    scheme = a380_cam_scheme(width, height, spp)
    info = scheme.render_info
    info.animation, info.framerate = True, float(framerate)
    scheme.scene_members.append(ModelMember(
        path="<procedural a380-class surface>", loaded=[make_mesh() if mesh is None else mesh],
        animation=_keyframes((0.0, [0.0, 0.0, 0.0], [0.0, 0.0, 0.0], "EaseInOutQuad"),
                             (0.5, [1.5, 0.5, -2.0], [0.05, 0.2, 0.0], "Linear"),
                             (1.0, [3.0, 1.0, -4.0], [0.1, 0.4, 0.05], "Linear"))))
    return scheme
