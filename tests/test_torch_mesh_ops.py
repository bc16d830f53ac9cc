"""Port parity for the mesh ops: the plain walk and the plain brute
nearest hit against the JAX integrator's `_mesh_hit_clusters`, and the
mesh shading attributes against `mesh_attrs_dense`, on seeded inputs.

Gates: gids equal on >= 99.5% of lanes; where they are, t within 1e-5
relative on >= 98% of them and within 2e-4 on all, barycentrics
within 1e-3; attributes within 1e-6. The t gate is a fraction because XLA on the CPU contracts
multiply-adds into FMAs and torch does not: on the surface, rays that
start 30 units out land both versions within about 1.5e-5 of the
float64 Moller-Trumbore t (median over the lanes that differ), but on
opposite sides of it on 1.2% of these lanes."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytrace_tpu.models.scene import build_scene as jax_build_scene
from raytrace_tpu.ops.vec import Vec3
from raytrace_tpu.render.integrator import IntegratorParams, _mesh_hit_clusters, mesh_attrs_dense
from raytrace_tpu_torch.models.camera import build_camera
from raytrace_tpu_torch.models.scene import from_reference
from raytrace_tpu_torch.ops import mesh_kernel as mk
from raytrace_tpu_torch.ops.intersect import INF
from test_torch_mesh_scene import octa_schemes, surface_scene, write_gltf
from test_torch_scene import reference_fields

N_RAYS = 4096


def _rays(seed, center, spread):
    g = np.random.default_rng(seed)
    o = (center + g.uniform(-spread, spread, (N_RAYS, 3))).astype(np.float32)
    target = (center + g.uniform(-0.3 * spread, 0.3 * spread, (N_RAYS, 3))).astype(np.float32)
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    seed_t = np.where(g.uniform(size=N_RAYS) < 0.2, g.uniform(1.0, 30.0, N_RAYS),
                      np.float32(INF)).astype(np.float32)
    return o, d, seed_t


def _scenes(name, tmp_path):
    if name == "surface":
        jscene, _, js, ps = surface_scene()
        return jscene, js, ps, np.array([0.0, 0.0, 0.0]), 30.0
    js, ps = octa_schemes(write_gltf(tmp_path / "m.gltf", textured=True))
    return jax_build_scene(js), js, ps, np.array([0.0, 0.0, 0.0]), 5.0


@pytest.mark.parametrize("route", ["walk", "brute"])
@pytest.mark.parametrize("name", ["surface", "octahedra"])
def test_nearest_hit_matches_mesh_hit_clusters(tmp_path, name, route):
    jscene, js, ps, center, spread = _scenes(name, tmp_path)
    scene = from_reference(reference_fields(jscene))
    w, h = ps.render_info.width, ps.render_info.height
    tables = mk.MeshTables(scene, build_camera(ps.cam, w, h), 0.5)
    o, d, seed_t = _rays(17, center, spread)
    ref_t, ref_g, ref_u, ref_v = (np.asarray(a) for a in _mesh_hit_clusters(
        jscene, IntegratorParams(), Vec3(*map(jnp.asarray, o.T)), Vec3(*map(jnp.asarray, d.T)),
        jnp.asarray(seed_t)))
    nearest = mk.mesh_hit_walk if route == "walk" else mk.mesh_hit_brute
    t, g, u, v = (a.numpy() for a in nearest(
        tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in o.T),
        tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in d.T),
        torch.from_numpy(seed_t), tables))
    hits = (ref_g >= 0).sum()
    assert hits > N_RAYS // 10, hits  # the rays do reach the mesh
    same = g == ref_g
    assert same.mean() >= 0.995, f"gids differ on {(~same).sum()} lanes"
    rel = np.abs(t[same] - ref_t[same]) / np.abs(ref_t[same])
    assert (rel <= 1e-5).mean() >= 0.98, f"t off by > 1e-5 on {(rel > 1e-5).sum()} lanes"
    assert rel.max() <= 2e-4, rel.max()
    # u, v come from the same cancelling dot products (|o - v0| of 30-60
    # against triangles 0.3 across): FMA or not moves them by up to 2.3e-4
    hit = same & (g >= 0)
    np.testing.assert_allclose(u[hit], ref_u[hit], atol=1e-3)
    np.testing.assert_allclose(v[hit], ref_v[hit], atol=1e-3)


_ATTR_CASES = {
    "untextured": dict(),
    "u8_textured": dict(textured=True),
    "normal_mapped": dict(textured=True, normal_map=True),
    "tangents": dict(normal_map=True, tangents=True),
}


@pytest.mark.parametrize("case", list(_ATTR_CASES))
def test_mesh_attrs_match_jax(tmp_path, case):
    js, ps = octa_schemes(write_gltf(tmp_path / "m.gltf", **_ATTR_CASES[case]))
    jscene = jax_build_scene(js)
    scene = from_reference(reference_fields(jscene))
    tables = mk.MeshTables(scene, build_camera(ps.cam, 64, 32), 0.5)
    g = np.random.default_rng(4)
    mi = g.integers(0, scene.n_mesh_tris, 4096).astype(np.int32)
    bu = g.uniform(0, 1, 4096).astype(np.float32)
    bv = (g.uniform(0, 1, 4096) * (1 - bu)).astype(np.float32)
    ref = mesh_attrs_dense(jscene, jnp.asarray(mi), jnp.asarray(bu), jnp.asarray(bv))
    ours = mk.mesh_attrs(tables.attr, tables.desc, tables.pool, tables.pool_kind,
                         torch.from_numpy(mi).long(), torch.from_numpy(bu), torch.from_numpy(bv))
    for k, (a, b) in enumerate(zip(ours, ref)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, err_msg=f"output {k}")
