"""Port parity for two-level instancing on the CPU: a scene of >= 4 copies
of one glTF asset builds the instance table and the asset's local
clusters (models/scene._try_build_instancing, the JAX package's
scene.py:404-493), and the "instanced" route's plain version
(ops/mesh_kernel.mesh_hit_instanced, the function of bounce_tiles'
`inst_body`, mesh_bounce_kernel.py:500-544) walks them per instance in
the instance frame.

The scene is tests/test_instancing.py's: five instances of an
8-triangle octahedron (its glTF writer copied here) under an emissive
sphere. Held against the JAX package: the detection and the instance
table, the refusals, the nearest hit against the flattened walk, a
planted exact-t tie across instances, the image of the port's plain
version against the JAX fused mesh kernel's instanced walk (interpret
mode), the Renderer on both routes and its resume, cpu semantics over
the flattened tables against the JAX XLA integrator, and from_reference.
"""
import base64
import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.models import config as jax_cfg
from raytrace_tpu.models.camera import build_camera as jax_build_camera
from raytrace_tpu.models.scene import build_scene as jax_build_scene
from raytrace_tpu.ops.pallas import trace_kernel as jax_tk
from raytrace_tpu.render import fused_mesh as fm
from raytrace_tpu.render.integrator import IntegratorParams
from raytrace_tpu.render.renderer import camera_to_arrays, sample_batch
from raytrace_tpu_torch.models import config as cfg
from raytrace_tpu_torch.models.camera import build_camera
from raytrace_tpu_torch.models.gltf import LoadedMesh, Primitive
from raytrace_tpu_torch.models.scene import build_scene, from_reference
from raytrace_tpu_torch.ops import mesh_kernel as mk
from raytrace_tpu_torch.ops.intersect import INF
from raytrace_tpu_torch.render.renderer import Renderer
from raytrace_tpu_torch.utils import checkpoint as ckpt
from test_torch_mesh_path import assert_close
from test_torch_renderer import tile_gate
from test_torch_scene import reference_fields

W, H = 64, 32


def _write_octahedron_gltf(tmp_path, name="oct.gltf"):
    """Minimal glTF 2.0: one mesh, 6 verts / 8 tris, embedded buffer
    (tests/test_instancing.py's writer)."""
    verts = np.array(
        [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
        np.float32,
    )
    idx = np.array(
        [[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
         [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.uint16
    ).reshape(-1)
    vb = verts.tobytes()
    ib = idx.tobytes()
    buf = vb + ib
    doc = {
        "asset": {"version": "2.0"},
        "scene": 0,
        "scenes": [{"nodes": [0]}],
        "nodes": [{"mesh": 0}],
        "meshes": [{"primitives": [{
            "attributes": {"POSITION": 0}, "indices": 1,
            "material": 0,
        }]}],
        "materials": [{"pbrMetallicRoughness": {
            "baseColorFactor": [0.8, 0.7, 0.6, 1.0],
            "metallicFactor": 0.3, "roughnessFactor": 0.5,
        }}],
        "accessors": [
            {"bufferView": 0, "componentType": 5126, "count": 6,
             "type": "VEC3", "min": verts.min(0).tolist(),
             "max": verts.max(0).tolist()},
            {"bufferView": 1, "componentType": 5123, "count": int(idx.size),
             "type": "SCALAR"},
        ],
        "bufferViews": [
            {"buffer": 0, "byteOffset": 0, "byteLength": len(vb)},
            {"buffer": 0, "byteOffset": len(vb), "byteLength": len(ib)},
        ],
        "buffers": [{
            "byteLength": len(buf),
            "uri": "data:application/octet-stream;base64,"
                   + base64.b64encode(buf).decode(),
        }],
    }
    p = os.path.join(tmp_path, name)
    with open(p, "w") as f:
        json.dump(doc, f)
    return p


def _raw(mod, paths):
    """tests/test_instancing.py's scheme, member i of `paths[i]`."""
    raw = {
        "render_info": {
            "width": W, "height": H, "samps_per_pix": 4, "kd_tree_depth": 17,
            "rad_info": {"debug_single_ray": False, "dir_light_samp": False,
                         "russ_roull_info": {"assured_depth": 3, "max_thres": 0.5}},
            "use_gpu": True,
        },
        "cam": {"d": [0, 0, 6], "up": [0, 1, 0], "view_eulers": [0, 0, 0],
                "o": [0, 0, -14], "screen_width": 8.0, "screen_height": 4.0},
        "scene_members": [mod.Tagged("Sphere", {
            "c": [0, 60, -30], "r": 40, "coloring": mod.Tagged("Solid", [0, 0, 0]),
            "mat": {"divert_ray": "Diff", "emissive": [2.0, 2.0, 2.0]}})],
    }
    for i, path in enumerate(paths):
        raw["scene_members"].append(mod.Tagged("Model", {
            "path": path, "uniform_scale": 0.8 + 0.1 * (i % 3),
            "translation": [-4.0 + 2.1 * i, 0.3 * (i % 2), 0.0],
            "euler_angles": [0.2 * i, 0.5 * i, 0.1 * i]}))
    return raw


def _schemes(paths):
    """(JAX scheme, port scheme)."""
    return jax_cfg.parse_scheme(_raw(jax_cfg, paths)), cfg.parse_scheme(_raw(cfg, paths))


@pytest.fixture(scope="module")
def five(tmp_path_factory):
    """(JAX scene, JAX scheme, port scene, port scheme) of five instances."""
    path = _write_octahedron_gltf(str(tmp_path_factory.mktemp("oct")))
    js, ps = _schemes([path] * 5)
    return jax_build_scene(js, pad_mult=64), js, build_scene(ps), ps


def _tables(scene, scheme):
    return mk.MeshTables(scene, build_camera(scheme.cam, W, H), 0.5)


def _rays(n, seed, origin=(0.0, 0.0, -14.0), boxes=((-6.0, -2.0, -2.0, 6.0, 2.0, 2.0),)):
    """n rays from near `origin`, each toward a point of one of the [lo
    xyz, hi xyz] `boxes` (the box and the point drawn from `seed`)."""
    g = np.random.default_rng(seed)
    o = np.asarray(origin, np.float32) + g.normal(0.0, 0.5, (n, 3)).astype(np.float32)
    b = np.asarray(boxes, np.float64)[g.integers(0, len(boxes), n)]
    d = b[:, :3] + g.uniform(0.0, 1.0, (n, 3)) * (b[:, 3:] - b[:, :3]) - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return (tuple(torch.from_numpy(np.ascontiguousarray(o[:, k])) for k in range(3)),
            tuple(torch.from_numpy(np.ascontiguousarray(d[:, k])) for k in range(3)))


def test_detection_matches_jax(five):
    jscene, _, ours, _ = five
    assert (jscene.n_inst, jscene.inst_tris) == (5, 8)
    assert (ours.n_inst, ours.inst_tris, ours.n_mesh_tris) == (5, 8, 40)
    np.testing.assert_allclose(ours.mk_inst, np.asarray(jscene.mk_inst), rtol=0, atol=1e-6)
    assert ours.mk_inst.dtype == np.float32
    # the gid bases are a permutation of i * inst_tris: every instance once
    assert sorted(ours.mk_inst[:, 18].tolist()) == [8.0 * i for i in range(5)]
    # the asset's local clusters: one cluster of its 8 triangles
    assert ours.inst_cl_idx.shape[0] == 1 and sorted(ours.inst_cl_idx[0, :8]) == list(range(8))
    t = _tables(ours, five[3])
    assert t.n_inst == 5 and t.inst.shape == (5, 24) and t.asset is not None
    assert t.route == ("instanced" if mk.INSTANCED_ROUTE else "walk")


def _moved_asset(i):
    """The octahedron as an in-memory mesh; member i of 4 has a vertex moved."""
    verts = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1], [0, 0, -1]],
                     np.float32)
    if i == 3:
        verts[0] = [1.5, 0.2, 0.0]
    idx = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                    [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]], np.int32)
    return [LoadedMesh(primitives=[Primitive(poses=verts, norms=verts, indices=idx,
                                             rgb_factor=np.array([0.8, 0.7, 0.6], np.float32))],
                       trans_mat=np.eye(4, dtype=np.float32))]


@pytest.mark.parametrize("case", ["three-members", "two-paths", "differing-geometry"])
def test_refusals(tmp_path, case):
    """Three members, two paths (two files of one content) or one instance
    whose geometry differs: no instancing tables, the flattened walk."""
    path = _write_octahedron_gltf(str(tmp_path))
    if case == "differing-geometry":  # in-memory members of one path string
        _, ps = _schemes([path] * 4)
        for i, m in enumerate(ps.scene_members[1:]):
            m.loaded = _moved_asset(i)
        jscene = None
    else:
        other = _write_octahedron_gltf(str(tmp_path), "copy.gltf")
        js, ps = _schemes([path] * 3 if case == "three-members" else [path, other] * 3)
        jscene = jax_build_scene(js, pad_mult=64)
    ours = build_scene(ps)
    if jscene is not None:
        assert jscene.n_inst == 0
        np.testing.assert_array_equal(ours.mk_inst, np.asarray(jscene.mk_inst))
    assert ours.n_mesh_tris > 0 and (ours.n_inst, ours.inst_tris) == (0, 0)
    assert ours.inst_cl_idx.shape[0] == 0
    t = _tables(ours, ps)
    assert t.route == "walk" and t.asset is None and t.inst.shape == (0, 24)
    with pytest.raises(ValueError, match="instancing tables"):
        mk.mesh_hit_instanced(*_rays(4, 0), torch.full((4,), INF), t)


def test_nearest_hit_matches_flattened_walk(five):
    """4,096 random rays: the instanced walk's (gid, t) against the
    flattened walk's; the local frame moves t by ulps."""
    _, _, scene, ps = five
    tables = _tables(scene, ps)
    o, d = _rays(4096, 11, boxes=scene.mk_inst[:, 12:18])  # toward the instances' AABBs
    seed = torch.full((4096,), INF)
    t_f, g_f, _, _ = mk.mesh_hit_walk(o, d, seed, tables)
    t_i, g_i, u_i, v_i = mk.mesh_hit_instanced(o, d, seed, tables)
    hits = int((g_f >= 0).sum())
    assert hits > 1000, hits
    assert float((g_i == g_f).float().mean()) >= 0.999
    both = (g_i == g_f) & (g_f >= 0)
    rel = ((t_i[both] - t_f[both]).abs() / t_f[both]).max()
    assert float(rel) <= 1e-5, float(rel)
    assert bool((t_i[g_i < 0] == INF).all()) and bool((u_i[g_i < 0] == 0).all())
    # a seed below every hit leaves every lane without one
    t_n, g_n, _, _ = mk.mesh_hit_instanced(o, d, torch.full((4096,), 1.0), tables)
    assert bool((g_n == -1).all()) and bool((t_n == 1.0).all())
    # the work counter sees every instance box of every live ray
    work = mk.instanced_walk_work(o, d, t_i, tables)
    assert work["rays"] == 4096 and work["inst_slab"] == 5 * 4096
    assert hits <= work["transforms"] <= work["inst_slab"] and work["tri"] >= hits


def test_exact_tie_goes_to_the_earlier_instance(tmp_path):
    """Two members with one transform: every hit on them is an exact-t tie
    across two instances, and the earlier row of the instance table wins;
    with the table's rows reversed, the other one does."""
    path = _write_octahedron_gltf(str(tmp_path))
    _, ps = _schemes([path] * 4)
    first, second = ps.scene_members[1:3]  # model members 0 and 1 coincide, at x = -4
    second.translation, second.uniform_scale, second.euler_angles = (
        first.translation, first.uniform_scale, first.euler_angles)
    scene = build_scene(ps)
    tables = _tables(scene, ps)
    assert tables.n_inst == 4
    o, d = _rays(2048, 5, origin=(-4.0, 0.0, -14.0), boxes=[(-5.0, -1.0, -1.0, -3.0, 1.0, 1.0)])
    seed = torch.full((2048,), INF)
    twins = {0.0, 8.0}  # the gid bases of model members 0 and 1
    for flip in (False, True):
        if flip:
            tables.inst = tables.inst.flip(0).contiguous()
        rows = [b for b in tables.inst[:, 18].tolist() if b in twins]
        _, gid, _, _ = mk.mesh_hit_instanced(o, d, seed, tables)
        on_twins = (gid >= 0) & (gid < 16)
        assert int(on_twins.sum()) > 200
        assert bool(((gid[on_twins] // 8) * 8 == int(rows[0])).all()), (flip, rows)


def test_image_matches_jax_fused_instanced(five):
    """mesh_trace_reference on the instanced route against the JAX fused
    mesh kernel's instanced walk (interpret mode) at 64x32:
    tests/test_instancing.py's limits (the entries off by > 1e-3 under
    1.2%, the channel means within 2e-2) and at most 0.2% of lanes off.
    At 8 samples a lane: the image is dark, and a lane whose path an ulp
    turns elsewhere after a few bounces (two lanes here, one for the
    port's flattened walk) moves a channel mean of a 2-sample image by
    about 1.4% (2.9e-2 for the two), of the 8-sample image by under 1%."""
    jscene, js, scene, ps = five
    samples = 8
    camera = jax_build_camera(js.cam, W, H)
    params = IntegratorParams(assured_depth=3, max_bounces=6)
    flat = np.arange(W * H, dtype=np.int32)
    sph_t, ft_t = jax_tk.pack_scene_tables(jscene)
    hints = jax_tk.scene_static_hints(sph_t, ft_t, jscene.n_spheres, jscene.n_free_tris)
    ref = np.asarray(fm.wavefront_mesh_fused(
        (jnp.asarray(sph_t), jnp.asarray(ft_t)),
        jnp.asarray(jax_tk.make_cam_vec(camera, float(params.max_thres))), jscene,
        camera_to_arrays(camera), params, W, H, jnp.asarray(flat % W), jnp.asarray(flat // W),
        jnp.int32(0), jnp.int32(samples), pool=1024, has_lens=False, hints=hints, interpret=True,
        python_loop=True))
    tables = _tables(scene, ps)
    xs, ys = torch.from_numpy(flat % W), torch.from_numpy(flat // W)
    out = torch.stack(mk.mesh_trace_reference(xs, ys, torch.zeros_like(xs), tables, assured=3,
                                              max_bounces=6, samples_per_lane=samples,
                                              route="instanced"), 1).numpy()
    mismatch = np.abs(out - ref) / (np.abs(ref) + 1e-3)
    assert (mismatch > 1e-3).mean() < 0.012, f"{(mismatch > 1e-3).mean()}"
    assert (mismatch > 1e-3).any(axis=1).mean() <= 0.002
    md = np.abs(out.mean(0) - ref.mean(0)) / (np.abs(ref.mean(0)) + 1e-6)
    assert md.max() < 2e-2, f"channel means off {md}"
    assert np.isfinite(out).all() and out.mean() > 0.003


def test_renderer_routes_and_resume(five, tmp_path):
    """The Renderer on the instanced route (MeshTables.route when
    INSTANCED_ROUTE is set, else asked for): its image passes the tile
    gate against the walk's, and a checkpoint resume is bitwise."""
    _, _, scene, ps = five

    def renderer(route):
        r = Renderer(ps, device="cpu", samples_per_launch=2, scene=scene)
        assert r.driver == "mesh_fused"
        assert r.tables.route == ("instanced" if mk.INSTANCED_ROUTE else "walk")
        r.tables.route = route
        return r

    r = renderer("instanced")
    img = r.render(samples=4, batch=2, progress=False)
    tile_gate(img, renderer("walk").render(samples=4, progress=False))
    assert img.mean() > 0.003
    first = renderer("instanced")
    first.render(samples=2, progress=False)
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, first.target)
    resumed = renderer("instanced")
    resumed.target = ckpt.load(path)
    resumed.render(samples=2, progress=False)
    assert resumed.target.count == r.target.count == 4
    np.testing.assert_array_equal(resumed.target.acc, r.target.acc)


def _flattened(scene):
    """The scene without its instancing tables."""
    empty = {f.name: f.default_factory() for f in dataclasses.fields(scene)
             if f.name == "mk_inst" or f.name.startswith("inst_cl_")}
    return dataclasses.replace(scene, n_inst=0, inst_tris=0, **empty)


def test_cpu_semantics_renders_over_flattened_tables(five):
    """cpu semantics on the instanced scene: the wavefront (mesh_hit over
    the flattened tables), bitwise the render of the same scene without
    instancing tables, against the JAX XLA integrator."""
    jscene, js, scene, ps = five
    r = Renderer(ps, device="cpu", mode="cpu", scene=scene)
    assert r.driver == "wavefront"
    img = r.render(samples=2, progress=False)
    flat = Renderer(ps, device="cpu", mode="cpu", scene=_flattened(scene))
    np.testing.assert_array_equal(flat.render(samples=2, progress=False), img)
    pix = np.arange(W * H, dtype=np.int32)
    ref = np.asarray(sample_batch(
        jscene, camera_to_arrays(jax_build_camera(js.cam, W, H)),
        IntegratorParams(mode="cpu", assured_depth=3, max_bounces=24), W, H,
        jnp.asarray(pix % W), jnp.asarray(pix // W), jnp.int32(0), jnp.int32(2)))
    assert_close(r.target.acc, ref, 2)
    assert img.mean() > 0.003


def test_from_reference_carries_the_instance_table(five):
    jscene, _, ours, ps = five
    back = from_reference(reference_fields(jscene))
    assert (back.n_inst, back.inst_tris) == (5, 8)
    np.testing.assert_array_equal(back.mk_inst, np.asarray(jscene.mk_inst))
    # the asset's local clusters, rebuilt from the JAX scene's world triangles
    np.testing.assert_array_equal(back.inst_cl_idx, ours.inst_cl_idx)
    for f in ("inst_cl_v0", "inst_cl_e1", "inst_cl_e2", "inst_cl_lo", "inst_cl_hi"):
        np.testing.assert_allclose(getattr(back, f), getattr(ours, f), rtol=0, atol=1e-5,
                                   err_msg=f)
    t = _tables(back, ps)
    o, d = _rays(1024, 3, boxes=ours.mk_inst[:, 12:18])
    a = mk.mesh_hit_instanced(o, d, torch.full((1024,), INF), t)
    b = mk.mesh_hit_instanced(o, d, torch.full((1024,), INF), _tables(ours, ps))
    assert float((a[1] == b[1]).float().mean()) >= 0.999


def test_fleet_scheme_builds_instanced_with_one_texture_set():
    """procedural.fleet_scheme: 17 instances of the 7,300-triangle cut,
    each transform non-trivial, the asset's four textures in the texel
    pool once (the members share one LoadedMesh), the instancing tables
    built."""
    from raytrace_tpu_torch.models import procedural

    scheme = procedural.fleet_scheme(32, 16)
    models = scheme.scene_members[1:]
    assert len(models) == 17 and len({id(m.loaded) for m in models}) == 1
    for m in models:
        assert 0.8 <= m.uniform_scale <= 1.2 and np.all(np.abs(m.euler_angles) > 1e-3)
    scene = build_scene(scheme)
    assert (scene.n_inst, scene.inst_tris, scene.n_mesh_tris) == (17, 7300, 124100)
    assert scene.tex_pool.dtype == np.uint32 and scene.tex_pool.size == 4 * 1024 * 1024
    t = mk.MeshTables(scene, build_camera(scheme.cam, 32, 16), 0.5)
    assert t.inst.shape == (17, 24) and t.asset.tri.shape[0] * t.asset.tri.shape[1] >= 7300
