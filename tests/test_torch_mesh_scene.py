"""Port parity for the mesh scene: the glTF loader, the cluster builder,
scene packing, the walk's table packer, the texel fetch and the
procedural a380-class scene of raytrace_tpu_torch against raytrace_tpu.
Also holds the mesh scene builders that the other test_torch_mesh_*
files share."""
import base64
import importlib.util
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from raytrace_tpu.accel.builder import build_clusters_bvh as jax_build_clusters
from raytrace_tpu.models import config as jax_cfg
from raytrace_tpu.models import gltf as jax_gltf
from raytrace_tpu.models import scene as jax_scene_mod
from raytrace_tpu.models.scene import build_scene as jax_build_scene
from raytrace_tpu.ops import texture as jax_texture
from raytrace_tpu.ops.pallas.mesh_hit_kernel import pack_mesh_tables_np
from raytrace_tpu.render.integrator import _fetch_rgb
from raytrace_tpu_torch.accel.builder import build_clusters_bvh
from raytrace_tpu_torch.models import config as cfg
from raytrace_tpu_torch.models import gltf, procedural
from raytrace_tpu_torch.models.scene import SceneArrays, build_scene, from_reference
from raytrace_tpu_torch.ops import mesh_kernel as mk
from raytrace_tpu_torch.ops import texture
from test_torch_scene import reference_fields

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OCT_VERTS = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                     np.float32)
OCT_IDX = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                    [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.uint16)


def _png(arr) -> str:
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG")
    return "data:image/png;base64," + base64.b64encode(buf.getvalue()).decode()


def write_gltf(path, textured=False, normal_map=False, tangents=False, glb=False):
    """The octahedron of tests/test_instancing.py:33-79 (6 verts, 8
    tris, one embedded buffer), optionally with uvs, an embedded u8 PNG
    base colour (and metallic-roughness) map, a normal map, tangents,
    a node transform, or as a .glb container."""
    g = np.random.default_rng(11)
    views, accessors, chunks = [], [], []

    def add(arr, comp, typ, count):
        off = sum(len(c) for c in chunks)
        chunks.append(arr.tobytes())
        views.append({"buffer": 0, "byteOffset": off, "byteLength": len(chunks[-1])})
        accessors.append({"bufferView": len(views) - 1, "componentType": comp,
                          "count": count, "type": typ})
        return len(accessors) - 1

    attrs = {"POSITION": add(OCT_VERTS, 5126, "VEC3", 6)}
    attrs["NORMAL"] = add(OCT_VERTS / np.linalg.norm(OCT_VERTS, axis=1, keepdims=True),
                          5126, "VEC3", 6)
    idx = add(OCT_IDX.reshape(-1), 5123, "SCALAR", OCT_IDX.size)
    pbr = {"baseColorFactor": [0.8, 0.7, 0.6, 1.0], "metallicFactor": 0.3,
           "roughnessFactor": 0.5}
    material, images, textures = {"pbrMetallicRoughness": pbr}, [], []
    if textured or normal_map:
        attrs["TEXCOORD_0"] = add(g.uniform(0, 1, (6, 2)).astype(np.float32), 5126, "VEC2", 6)

    def tex(arr):
        images.append({"uri": _png(arr)})
        textures.append({"source": len(images) - 1})
        return {"index": len(textures) - 1}

    if textured:
        pbr["baseColorTexture"] = tex(g.integers(0, 256, (8, 16, 3), dtype=np.uint8))
        pbr["metallicRoughnessTexture"] = tex(g.integers(0, 256, (4, 4, 3), dtype=np.uint8))
    if normal_map:
        material["normalTexture"] = dict(tex(g.integers(0, 256, (8, 8, 3), dtype=np.uint8)),
                                         scale=0.9)
    if tangents:
        attrs["TANGENT"] = add(g.normal(size=(6, 4)).astype(np.float32), 5126, "VEC4", 6)
    buf = b"".join(chunks)
    doc = {
        "asset": {"version": "2.0"}, "scene": 0, "scenes": [{"nodes": [0]}],
        "nodes": [{"children": [1], "rotation": [0.0, 0.3826834, 0.0, 0.9238795]},
                  {"mesh": 0, "translation": [0.1, 0.2, -0.1], "scale": [1.0, 0.9, 1.1]}],
        "meshes": [{"primitives": [{"attributes": attrs, "indices": idx, "material": 0}]}],
        "materials": [material],
        "accessors": accessors, "bufferViews": views,
        "buffers": [{"byteLength": len(buf)}],
    }
    if images:
        doc["images"], doc["textures"] = images, textures
    if glb:
        js = json.dumps(doc).encode()
        js += b" " * (-len(js) % 4)
        body = buf + b"\0" * (-len(buf) % 4)
        data = (b"glTF" + np.array([2, 12 + 16 + len(js) + len(body)], np.uint32).tobytes()
                + np.array([len(js), 0x4E4F534A], np.uint32).tobytes() + js
                + np.array([len(body), 0x004E4942], np.uint32).tobytes() + body)
        with open(path, "wb") as f:
            f.write(data)
    else:
        doc["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                    + base64.b64encode(buf).decode())
        with open(path, "w") as f:
            json.dump(doc, f)
    return str(path)


def octa_members(mod, path, n_inst, with_extras):
    """n_inst octahedron instances; with_extras adds an emissive sphere,
    a dielectric sphere and a DiffSpec free triangle."""
    members = [mod.Tagged("Sphere", {
        "c": [0, 60, -30], "r": 40, "coloring": mod.Tagged("Solid", [0, 0, 0]),
        "mat": {"divert_ray": "Diff", "emissive": [2.0, 2.0, 2.0]}})]
    if with_extras:
        members += [
            mod.Tagged("Sphere", {
                "c": [2.5, -1.0, -3.0], "r": 1.0, "coloring": mod.Tagged("Solid", [0.9, 0.9, 0.9]),
                "mat": {"divert_ray": mod.Tagged("Dielectric", {"n_out": 1.0, "n_in": 1.5})}}),
            mod.Tagged("FreeTriangle", {
                "verts": [[-9, -2, -6], [9, -2, -6], [0, -2, 6]], "norm": [0, 1, 0],
                "rgb": [0.7, 0.7, 0.3],
                "mat": {"divert_ray": mod.Tagged("DiffSpec", {"diffp": 0.4})}}),
        ]
    for i in range(n_inst):
        members.append(mod.Tagged("Model", {
            "path": path, "uniform_scale": 0.8 + 0.1 * (i % 3),
            "translation": [-4.0 + 2.1 * i, 0.3 * (i % 2), 0.0],
            "euler_angles": [0.1 * i, 0.3 * i, 0.0]}))
    return members


def mesh_raw(members, width, height, assured=3):
    """Scheme dict: the camera of tests/test_instancing.py over members."""
    return {
        "render_info": {
            "width": width, "height": height, "samps_per_pix": 4,
            "rad_info": {"debug_single_ray": False, "dir_light_samp": False,
                         "russ_roull_info": {"assured_depth": assured, "max_thres": 0.5}},
            "use_gpu": True,
        },
        "cam": {"d": [0, 0, 6], "up": [0, 1, 0], "view_eulers": [0, 0, 0],
                "o": [0, 0, -14], "screen_width": 8.0, "screen_height": 4.0},
        "scene_members": members,
    }


def octa_schemes(path, width=64, height=32, n_inst=5, with_extras=True):
    """(JAX scheme, port scheme) of the octahedron scene."""
    js = jax_cfg.parse_scheme(mesh_raw(octa_members(jax_cfg, path, n_inst, with_extras),
                                       width, height))
    ps = cfg.parse_scheme(mesh_raw(octa_members(cfg, path, n_inst, with_extras), width, height))
    return js, ps


def a380_raw(mod, width, height):
    """The a380.yml camera and sun (scripts/bench_mesh.py:184-207)."""
    raw = mesh_raw([mod.Tagged("Sphere", {
        "c": [2500, 2200, -200], "r": 1200, "coloring": mod.Tagged("Solid", [0, 0, 0]),
        "mat": {"divert_ray": "Diff", "emissive": [1.0, 1.0, 1.0]}})], width, height, assured=5)
    raw["cam"] = {"d": [0, 0, 6], "up": [0, 1, 0], "view_eulers": [-0.6, 0.1, 0],
                  "o": [0, -15, -30], "screen_width": 10.0, "screen_height": 5.0}
    return raw


def surface_scene(n_tris=2097, width=64, height=32, n_textures=0, tex_size=16):
    """(JAX SceneArrays, port SceneArrays, JAX scheme, port scheme) of the
    procedural surface cut to n_tris triangles (2,097, spaceship_r1's
    size, under the JAX brute route's gate) under the a380 camera and sun. The JAX
    build gets the mesh as scripts/bench_mesh.py gives it, through its
    glTF loader's place."""
    mesh = procedural.make_mesh(n_tris, n_textures=n_textures, tex_size=tex_size)
    js = jax_cfg.parse_scheme(a380_raw(jax_cfg, width, height))
    jscene = jax_build_with_mesh(js, mesh)
    ps = cfg.parse_scheme(a380_raw(cfg, width, height))
    ps.scene_members.append(cfg.ModelMember(path="<surface>", loaded=[mesh]))
    return jscene, build_scene(ps), js, ps


def jax_build_with_mesh(js, mesh):
    """The JAX scene of scheme js with the loaded mesh appended as a
    Model member at the identity transform, given to the JAX glTF
    loader's place (as scripts/bench_mesh.py gives it); js gains that
    member."""
    js.scene_members.append(jax_cfg.ModelMember(
        path="<surface>", uniform_scale=1.0, translation=np.zeros(3, np.float32),
        euler_angles=np.zeros(3, np.float32)))
    orig_load, orig_resolve = jax_scene_mod.gltf_mod.load_model, jax_scene_mod.resolve_asset_path
    jax_scene_mod.gltf_mod.load_model = lambda *a, **k: [mesh]
    jax_scene_mod.resolve_asset_path = lambda p, d: p
    try:
        return jax_build_scene(js)
    finally:
        jax_scene_mod.gltf_mod.load_model = orig_load
        jax_scene_mod.resolve_asset_path = orig_resolve


# --- glTF ------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["plain", "textured", "normal_map", "tangents", "glb"])
def test_load_model_matches_jax(tmp_path, kind):
    path = write_gltf(tmp_path / ("m.glb" if kind == "glb" else "m.gltf"),
                      textured=kind in ("textured", "normal_map", "glb"),
                      normal_map=kind in ("normal_map", "tangents"),
                      tangents=kind == "tangents", glb=kind == "glb")
    args = (np.array([0.5, -1.0, 2.0], np.float32), 1.3, np.array([0.2, 0.4, -0.1], np.float32))
    ours = gltf.load_model(path, *args)
    ref = jax_gltf.load_model(path, *args)
    assert len(ours) == len(ref) == 1
    np.testing.assert_array_equal(ours[0].trans_mat, ref[0].trans_mat)
    for p, q in zip(ours[0].primitives, ref[0].primitives):
        for f in ("poses", "norms", "indices", "rgb_factor", "tangents"):
            a, b = getattr(p, f), getattr(q, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a, b, err_msg=f)
        for f in ("norm_scale", "metal_factor", "rough_factor"):
            assert getattr(p, f) == getattr(q, f), f
        for f in ("rgb_tex", "norm_tex", "mr_tex"):
            a, b = getattr(p, f), getattr(q, f)
            assert (a is None) == (b is None), f
            if a is not None:
                np.testing.assert_array_equal(a.coords, b.coords)
                np.testing.assert_array_equal(a.pixels, b.pixels)
                np.testing.assert_array_equal(a.pixels_raw, b.pixels_raw)
                assert a.pixels_raw.dtype == np.uint8


def test_sparse_accessor(tmp_path):
    path = write_gltf(tmp_path / "m.gltf")
    with open(path) as f:
        doc = json.load(f)
    buf = base64.b64decode(doc["buffers"][0]["uri"].split(",", 1)[1])
    extra = np.array([1, 4], np.uint16).tobytes() + np.array([[0, 2, 0], [0, 0, 3]],
                                                             np.float32).tobytes()
    off = len(buf)
    doc["bufferViews"] += [{"buffer": 0, "byteOffset": off, "byteLength": 4},
                           {"buffer": 0, "byteOffset": off + 4, "byteLength": 24}]
    doc["accessors"][0]["sparse"] = {"count": 2,
                                     "indices": {"bufferView": len(doc["bufferViews"]) - 2,
                                                 "componentType": 5123},
                                     "values": {"bufferView": len(doc["bufferViews"]) - 1}}
    buf += extra
    doc["buffers"][0] = {"byteLength": len(buf), "uri": "data:application/octet-stream;base64,"
                         + base64.b64encode(buf).decode()}
    with open(path, "w") as f:
        json.dump(doc, f)
    ours = gltf.GltfFile(path).accessor(0)
    np.testing.assert_array_equal(ours, jax_gltf.GltfFile(path).accessor(0))
    np.testing.assert_array_equal(ours[4], [0, 0, 3])


# --- cluster builder and packer --------------------------------------------


def test_cluster_builder_matches_jax_numpy():
    jscene, scene, _, _ = surface_scene()
    v0, e1, e2 = scene.mt_v0, scene.mt_e1, scene.mt_e2
    lo = np.minimum(np.minimum(v0, v0 + e1), v0 + e2)
    hi = np.maximum(np.maximum(v0, v0 + e1), v0 + e2)
    ours = build_clusters_bvh(lo, hi, leaf_target=64)
    ref = jax_build_clusters(lo, hi, leaf_target=64, native=False)
    assert ours[0].shape == (64, 64)
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("scene_name", ["surface", "octahedron"])
def test_pack_mesh_tables_matches_jax(tmp_path, scene_name):
    if scene_name == "surface":
        jscene, scene, js, _ = surface_scene()
    else:
        js, ps = octa_schemes(write_gltf(tmp_path / "m.gltf"))
        jscene, scene = jax_build_scene(js), build_scene(ps)
    cam_o = np.asarray(js.cam.o, np.float32)
    args = [np.asarray(getattr(jscene, k)) for k in
            ("cl_idx", "cl_lo", "cl_hi", "cl_v0", "cl_e1", "cl_e2")]
    ours = mk.pack_mesh_tables(*args, cam_o=cam_o)
    b, sb, sgb, tri = pack_mesh_tables_np(*args, cam_o=cam_o)
    np.testing.assert_array_equal(ours["bounds"], b)
    np.testing.assert_array_equal(ours["sbounds"], sb)
    np.testing.assert_array_equal(ours["sgbounds"], sgb)
    Cp, W = ours["gid"].shape
    tri = tri.reshape(Cp, W, 16)
    np.testing.assert_array_equal(ours["tri"][..., :9], tri[..., :9])
    np.testing.assert_array_equal(ours["gid"], tri[..., 9].astype(np.int32))
    assert ours["gid"].dtype == np.int32
    np.testing.assert_array_equal(ours["count"], (ours["gid"] >= 0).sum(1))


# --- scene packing ---------------------------------------------------------

_SCENE_CASES = {
    "untextured": dict(textured=False),
    "u8_textured": dict(textured=True),
    "normal_mapped": dict(textured=True, normal_map=True),
    "tangents": dict(normal_map=True, tangents=True),
}


def _assert_scene_equal(ours: SceneArrays, jscene, exact_clusters=True):
    for f in ("n_spheres", "n_free_tris", "n_mesh_tris", "n_clusters"):
        assert getattr(ours, f) == getattr(jscene, f), f
    M = ours.n_mesh_tris
    for f in ("mt_v0", "mt_e1", "mt_e2", "mt_desc"):
        np.testing.assert_array_equal(getattr(ours, f), np.asarray(getattr(jscene, f))[:M], f)
    np.testing.assert_array_equal(ours.mt_attr[:, :37], np.asarray(jscene.mt_attr)[:M, :37])
    assert not ours.mt_attr[:, 37:].any()
    np.testing.assert_array_equal(ours.tex_pool, np.asarray(jscene.tex_pool))
    assert ours.tex_pool.dtype == np.asarray(jscene.tex_pool).dtype
    if exact_clusters:
        for f in ("cl_idx", "cl_v0", "cl_e1", "cl_e2", "cl_lo", "cl_hi"):
            np.testing.assert_array_equal(getattr(ours, f), np.asarray(getattr(jscene, f)), f)
    else:
        # the JAX scene partitions with its C++ builder (std::nth_element),
        # whose leaves differ from the numpy algorithm's where centroids tie;
        # the port equals the JAX numpy builder on the JAX scene's triangles
        v0 = np.asarray(jscene.mt_v0)[:M]
        v1, v2 = v0 + np.asarray(jscene.mt_e1)[:M], v0 + np.asarray(jscene.mt_e2)[:M]
        ref = jax_build_clusters(np.minimum(np.minimum(v0, v1), v2),
                                 np.maximum(np.maximum(v0, v1), v2), leaf_target=64, native=False)
        for a, b in zip((ours.cl_idx, ours.cl_lo, ours.cl_hi), ref):
            np.testing.assert_array_equal(a, b)
        assert ours.cl_idx.shape == np.asarray(jscene.cl_idx).shape
    for f in ("sph_c", "sph_r", "ft_v0", "ft_e1", "ft_norm", "ft_kind"):
        np.testing.assert_array_equal(getattr(ours, f), np.asarray(getattr(jscene, f)), f)


@pytest.mark.parametrize("case", list(_SCENE_CASES))
def test_build_scene_matches_jax(tmp_path, case):
    js, ps = octa_schemes(write_gltf(tmp_path / "m.gltf", **_SCENE_CASES[case]), n_inst=1)
    jscene = jax_build_scene(js)
    ours = build_scene(ps)
    assert ours.n_mesh_tris == 8
    _assert_scene_equal(ours, jscene)
    if case == "u8_textured":
        assert ours.tex_pool.dtype == np.uint32 and ours.mt_desc[:, 1].min() > 0
    if case == "normal_mapped":
        assert ours.mt_attr[:, 18].all()


def test_five_instance_scene_and_from_reference(tmp_path):
    js, ps = octa_schemes(write_gltf(tmp_path / "m.gltf", textured=True), n_inst=5)
    jscene = jax_build_scene(js)
    assert jscene.n_inst == 5  # the JAX kernel tables are asset-local here
    ours = build_scene(ps)
    assert ours.n_mesh_tris == 40 and ours.n_clusters == 1
    _assert_scene_equal(ours, jscene)
    # the five instances share one decoded texture in the pool
    assert ours.tex_pool.size == 8 * 16 + 4 * 4
    back = from_reference(reference_fields(jscene))
    for f in ("mt_v0", "mt_attr", "mt_desc", "cl_idx", "cl_v0", "tex_pool", "sph_c"):
        np.testing.assert_array_equal(getattr(back, f), getattr(ours, f), f)
    assert (back.n_mesh_tris, back.n_clusters) == (40, 1)


def test_surface_scene_matches_jax():
    jscene, ours, _, _ = surface_scene()
    assert ours.n_mesh_tris == 2097
    _assert_scene_equal(ours, jscene, exact_clusters=False)


# --- the two repairs -------------------------------------------------------


def test_from_reference_carries_cube_map(tmp_path):
    """A mesh scene with a cube map crosses with its sky pool, face
    tables and has_cubemap, beside the mesh's own texel pool, and its
    MeshTables carry the sky."""
    from raytrace_tpu_torch.models.camera import build_camera
    from test_torch_cubemap import SKY_FIELDS, add_sky, write_faces

    js, ps = octa_schemes(write_gltf(tmp_path / "m.gltf", textured=True), n_inst=1)
    value = write_faces(tmp_path)
    add_sky(js, jax_cfg, jax_cfg._parse_member, value)
    add_sky(ps, cfg, cfg.parse_member, value)
    jscene = jax_build_scene(js)
    back, ours = from_reference(reference_fields(jscene)), build_scene(ps)
    assert back.has_cubemap and ours.has_cubemap
    for f in SKY_FIELDS + ("tex_pool",):
        np.testing.assert_array_equal(getattr(back, f), np.asarray(getattr(jscene, f)), f)
        np.testing.assert_array_equal(getattr(back, f), getattr(ours, f), f)
    assert back.tex_pool.size == 8 * 16 + 4 * 4
    tables = mk.MeshTables(back, build_camera(ps.cam, 64, 32), 0.5)
    np.testing.assert_array_equal(tables.sky.face[:, 0].numpy(), ours.cm_offsets)


def test_trace_kernel_supports_rejects_mesh(tmp_path):
    from raytrace_tpu_torch.ops import trace_kernel as tk
    from raytrace_tpu_torch.render.renderer import params_from_scheme

    _, ps = octa_schemes(write_gltf(tmp_path / "m.gltf"), n_inst=1, with_extras=False)
    scene = build_scene(ps)
    assert not tk.supports(scene, params_from_scheme(ps))
    assert mk.supports(scene, params_from_scheme(ps))


# --- texel fetch -----------------------------------------------------------


def _pools():
    g = np.random.default_rng(5)
    u8 = g.integers(0, 256, 3 * 700, dtype=np.uint8)
    packed = (u8[0::3].astype(np.uint32) | (u8[1::3].astype(np.uint32) << np.uint32(8))
              | (u8[2::3].astype(np.uint32) << np.uint32(16)))
    u16 = g.integers(0, 65536, 3 * 700, dtype=np.uint16)
    return {"u32": packed, "u16": u16, "f32": g.uniform(0, 1, 3 * 700).astype(np.float32)}


@pytest.mark.parametrize("dtype", ["u32", "u16", "f32"])
def test_fetch_rgb_bit_equal(dtype):
    pool = _pools()[dtype]
    base3 = (3 * np.random.default_rng(2).integers(0, 700, 4096)).astype(np.int32)
    base3[:3] = [0, 3 * 699, 3 * 5]
    ref = _fetch_rgb(jnp.asarray(pool), jnp.asarray(base3))
    pt, kind = texture.pool_tensor(pool)
    ours = texture.fetch_rgb(pt, kind, torch.from_numpy(base3))
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("dtype", ["u32", "u16", "f32"])
def test_sample_nearest_bit_equal(dtype):
    pool = _pools()[dtype]
    g = np.random.default_rng(3)
    n = 4096
    wid = g.integers(0, 20, n).astype(np.int32)
    hei = g.integers(1, 20, n).astype(np.int32)
    off = (3 * g.integers(0, 300, n)).astype(np.int32)
    u = g.uniform(-0.2, 1.2, n).astype(np.float32)
    v = g.uniform(-0.2, 1.2, n).astype(np.float32)
    ref = np.asarray(jax_texture.sample_nearest(jnp.asarray(pool), *map(jnp.asarray,
                                                                        (off, wid, hei, u, v))))
    pt, kind = texture.pool_tensor(pool)
    ok, rgb = texture.sample_nearest(pt, kind, *map(torch.from_numpy, (off, wid, hei, u, v)))
    np.testing.assert_array_equal(torch.stack(rgb, -1).numpy(), ref)
    np.testing.assert_array_equal(ok.numpy(), wid > 0)


# --- the procedural a380-class scene ---------------------------------------


def test_procedural_matches_bench_mesh(monkeypatch):
    """models/procedural.py against scripts/bench_mesh.py, loaded by path
    (it sets a persistent compilation cache at import: restored here)."""
    monkeypatch.setenv("BENCH_MESH_TEXTURES", "20")
    monkeypatch.setenv("BENCH_MESH_TEX_SIZE", "16")
    saved = {k: getattr(jax.config, k) for k in
             ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")}
    try:
        spec = importlib.util.spec_from_file_location(
            "bench_mesh_for_test", os.path.join(REPO, "scripts", "bench_mesh.py"))
        bench = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(bench)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    for a, b in zip(procedural._surface(procedural.N_TRIS), bench._surface(procedural.N_TRIS, None)):
        np.testing.assert_array_equal(a, b)
    ours = procedural.make_mesh(procedural.N_TRIS, n_textures=20, tex_size=16)
    ref = bench.make_mesh(procedural.N_TRIS)
    assert len(ours.primitives) == len(ref.primitives) == 20
    assert sum(p.indices.shape[0] for p in ours.primitives) == 127_749
    for p, q in zip(ours.primitives, ref.primitives):
        for f in ("poses", "norms", "indices", "rgb_factor"):
            np.testing.assert_array_equal(getattr(p, f), getattr(q, f))
        for f in ("pixels", "pixels_raw", "coords"):
            np.testing.assert_array_equal(getattr(p.rgb_tex, f), getattr(q.rgb_tex, f))
        assert (p.metal_factor, p.rough_factor) == (q.metal_factor, q.rough_factor)
    js, ps = bench.a380_cam_scheme(spp=16), procedural.a380_cam_scheme()
    assert (ps.render_info.width, ps.render_info.height) == (js.render_info.width,
                                                            js.render_info.height)
    for f in ("d", "o", "up", "view_eulers"):
        np.testing.assert_array_equal(getattr(ps.cam, f), getattr(js.cam, f))
    rr, jr = ps.render_info.rad_info.russ_roull_info, js.render_info.rad_info.russ_roull_info
    assert (rr.assured_depth, rr.max_thres) == (jr.assured_depth, jr.max_thres) == (5, 0.5)
    s, t = ps.scene_members[0], js.scene_members[0]
    assert (s.r, s.mat.emissive.tolist()) == (t.r, t.mat.emissive.tolist())
