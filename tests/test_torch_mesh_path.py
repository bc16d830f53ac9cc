"""Port parity for the mesh path: `mesh_trace_reference` (the plain torch
version that the CUDA kernel is held against on the card) against the
JAX package's `sample_batch` (its XLA integrator, the oracle of
tests/test_mesh_fused.py) on the same pixels and sample ids, on both
nearest-hit routes.

Gate (tests/test_mesh_fused.py `_assert_close`): under 0.5% + 0.3% per
extra sample of lanes off by > 1e-3 relative, channel means within 8e-3
relative. Draws and streams are bit-identical; what differs is float
rounding (XLA contracts multiply-adds into FMAs on the CPU, torch does
not), which flips mesh-edge t-ties and texel choices on a few lanes."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytrace_tpu.models.camera import build_camera as jax_build_camera
from raytrace_tpu.models.scene import build_scene as jax_build_scene
from raytrace_tpu.ops.pallas.woop import MAX_TRIS as JAX_MAX_TRIS
from raytrace_tpu.render.integrator import IntegratorParams
from raytrace_tpu.render.renderer import camera_to_arrays, sample_batch
from raytrace_tpu_torch.models.camera import build_camera
from raytrace_tpu_torch.models.scene import from_reference
from raytrace_tpu_torch.ops import mesh_kernel as mk
from test_torch_mesh_scene import octa_schemes, surface_scene, write_gltf
from test_torch_scene import reference_fields

W, H = 64, 32
MAX_BOUNCES = 6


def assert_close(out, ref, n_samples):
    mismatch = np.abs(out - ref) / (np.abs(ref) + 1e-3)
    limit = 0.005 + 0.003 * (n_samples - 1)
    assert (mismatch > 1e-3).mean() < limit, f"{(mismatch > 1e-3).mean()}; max rel {mismatch.max()}"
    md = np.abs(out.mean(0) - ref.mean(0)) / (np.abs(ref.mean(0)) + 1e-6)
    assert md.max() < 8e-3, f"channel means off {md}"
    assert np.isfinite(out).all()


def _jax_ref(jscene, js, assured, base, n):
    flat = np.arange(W * H, dtype=np.int32)
    params = IntegratorParams(assured_depth=assured, max_bounces=MAX_BOUNCES)
    return np.asarray(sample_batch(
        jscene, camera_to_arrays(jax_build_camera(js.cam, W, H)), params, W, H,
        jnp.asarray(flat % W), jnp.asarray(flat // W), jnp.int32(base), jnp.int32(n)))


def _port(jscene, ps, route, assured, base, n, spl):
    tables = mk.MeshTables(from_reference(reference_fields(jscene)), build_camera(ps.cam, W, H),
                           0.5)
    flat = torch.arange(W * H, dtype=torch.int32)
    xs, ys = flat % W, flat // W
    acc = np.zeros((W * H, 3), np.float32)
    for s0 in range(0, n, spl):
        out = mk.mesh_trace(xs, ys, torch.full_like(xs, base + s0), tables, route=route,
                            assured=assured, max_bounces=MAX_BOUNCES, samples_per_lane=spl)
        acc += torch.stack(out, 1).numpy()
    return acc


@pytest.fixture(scope="module")
def octahedra(tmp_path_factory):
    """Five textured, normal-mapped octahedron instances with an emissive
    sphere, a dielectric sphere and a DiffSpec free triangle."""
    path = write_gltf(tmp_path_factory.mktemp("octa") / "m.gltf", textured=True, normal_map=True)
    js, ps = octa_schemes(path, W, H)
    return jax_build_scene(js), js, ps


@pytest.mark.parametrize("route", ["brute", "walk"])
@pytest.mark.parametrize("spl,n,base", [(1, 1, 0), (2, 4, 0), (2, 2, 7)],
                         ids=["spl1-1spp", "spl2-4spp", "base7"])
def test_octahedra_path_matches_jax(octahedra, route, spl, n, base):
    jscene, js, ps = octahedra
    ref = _jax_ref(jscene, js, 3, base, n)
    out = _port(jscene, ps, route, 3, base, n, spl)
    assert_close(out, ref, n)
    assert out.mean() > 0.01


@pytest.mark.parametrize("route", ["brute", "walk"])
def test_surface_path_matches_jax(route):
    """The 2,097-triangle surface, both routes: the JAX package's brute
    route (under its gate, woop.MAX_TRIS), the port's walk (above its
    gate, MAX_BRUTE_TRIS, measured on the H100)."""
    jscene, scene, js, ps = surface_scene(2097, W, H)
    assert mk.MAX_BRUTE_TRIS < jscene.n_mesh_tris <= JAX_MAX_TRIS
    assert mk.MeshTables(scene, build_camera(ps.cam, W, H), 0.5).route == "walk"
    ref = _jax_ref(jscene, js, 5, 3, 4)
    out = _port(jscene, ps, route, 5, 3, 4, 4)
    assert_close(out, ref, 4)


def test_a380_class_walk_matches_jax():
    """The full a380-class surface (127,749 triangles, 20 u8 textures, cut
    to 64x64 texels here): the walk route's scene."""
    jscene, scene, js, ps = surface_scene(127_749, W, H, n_textures=20, tex_size=64)
    assert mk.MeshTables(scene, build_camera(ps.cam, W, H), 0.5).route == "walk"
    ref = _jax_ref(jscene, js, 5, 0, 2)
    out = _port(jscene, ps, "walk", 5, 0, 2, 2)
    assert_close(out, ref, 2)
