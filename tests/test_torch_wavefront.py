"""The port's wavefront driver: `wavefront_batch` (a lane pool with
regeneration) against the port's `sample_batch` (the plain integrator)
on the same pixels and sample ids, at the JAX package's gate (rtol 1e-4,
atol 1e-4, tests/test_wavefront.py:77), in gpu and cpu semantics, with a
pool smaller and larger than the work, with direct-light sampling, with
debug_single_ray and on a mesh scene; against the JAX `wavefront_batch`
in each semantics (the port-vs-JAX gate of test_torch_mesh_path); and
two runs bitwise equal."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytrace_tpu.models.camera import build_camera as jax_build_camera
from raytrace_tpu.models.scene import build_scene as jax_build_scene
from raytrace_tpu.render.integrator import IntegratorParams as JaxParams
from raytrace_tpu.render.renderer import camera_to_arrays
from raytrace_tpu.render.wavefront import wavefront_batch as jax_wavefront_batch
from raytrace_tpu_torch.render.integrator import IntegratorParams
from raytrace_tpu_torch.render.renderer import sample_batch, tile_order
from raytrace_tpu_torch.render.wavefront import wavefront_batch
from test_dls import _scheme as dls_scheme
from test_torch_integrator import port_scene, sphere_scheme
from test_torch_mesh_path import assert_close
from test_torch_mesh_scene import octa_schemes, write_gltf

W, H = 48, 24
GPU = dict(assured_depth=2, max_bounces=8, mode="gpu")
CPU = dict(assured_depth=2, max_bounces=8, mode="cpu")


def _tables(w, h, tiled):
    order = tile_order(w, h) if tiled else np.arange(w * h)
    return (torch.from_numpy((order % w).astype(np.int32)),
            torch.from_numpy((order // w).astype(np.int32)))


def _plain(scene, params, w, h, n):
    xs, ys = _tables(w, h, tiled=False)
    return sample_batch(scene, params, xs, ys, 0, n).numpy()


def _wavefront(scene, params, w, h, n, pool, base=0):
    xs, ys = _tables(w, h, tiled=True)
    img, stats = wavefront_batch(scene, params, xs, ys, base, n, w, pool, return_stats=True)
    assert stats["iterations"] > 0 and stats["lane_bounces"] >= w * h * n
    return img.numpy()


@pytest.fixture(scope="module")
def spheres():
    js = sphere_scheme()
    js.render_info.width, js.render_info.height = W, H
    return port_scene(jax_build_scene(js), js, W, H), js


@pytest.mark.parametrize("kw", [GPU, CPU, dict(CPU, debug_single_ray=True)],
                         ids=["gpu", "cpu", "debug-single-ray"])
def test_wavefront_matches_sample_batch(spheres, kw):
    scene, _ = spheres
    params = IntegratorParams(**kw)
    ref = _plain(scene, params, W, H, 4)
    out = _wavefront(scene, params, W, H, 4, 256)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    assert ref.mean() > 1e-3


@pytest.mark.parametrize("pool", [128, 8192], ids=["smaller", "larger"])
def test_wavefront_pool_smaller_and_larger_than_work(spheres, pool):
    scene, _ = spheres
    params = IntegratorParams(**GPU)
    ref = _plain(scene, params, W, H, 2)
    assert pool < W * H * 2 or pool > W * H * 2
    np.testing.assert_allclose(_wavefront(scene, params, W, H, 2, pool), ref, rtol=1e-4,
                               atol=1e-4)


def test_wavefront_dls_matches_sample_batch():
    """tests/test_dls.py:160: the pending direct-light term rides in the
    pool, is cleared on fresh lanes and resolves before its lane retires."""
    js = dls_scheme()
    w, h = js.render_info.width, js.render_info.height
    scene = port_scene(jax_build_scene(js), js, w, h)
    params = IntegratorParams(mode="cpu", dir_light_samp=True, assured_depth=2, max_bounces=8)
    ref = _plain(scene, params, w, h, 2)
    out = _wavefront(scene, params, w, h, 2, 512)
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=1e-4)
    no_dls = _plain(scene, IntegratorParams(mode="cpu", assured_depth=2, max_bounces=8), w, h, 2)
    assert ref.sum() > no_dls.sum()  # the direct light does add


@pytest.mark.parametrize("kw", [GPU, CPU], ids=["gpu", "cpu"])
def test_wavefront_mesh_scene(tmp_path, kw):
    """The textured, normal-mapped octahedra: the mesh hit goes through
    `mesh_hit` (its plain version here) inside the pool."""
    js, _ = octa_schemes(write_gltf(tmp_path / "m.gltf", textured=True, normal_map=True), 32, 16)
    scene = port_scene(jax_build_scene(js), js, 32, 16)
    params = IntegratorParams(**dict(kw, max_bounces=6))
    ref = _plain(scene, params, 32, 16, 2)
    np.testing.assert_allclose(_wavefront(scene, params, 32, 16, 2, 256), ref, rtol=1e-4,
                               atol=1e-4)
    assert ref.mean() > 1e-3


@pytest.mark.parametrize("kw", [GPU, CPU], ids=["gpu", "cpu"])
def test_wavefront_matches_jax_wavefront(spheres, kw):
    scene, js = spheres
    flat = np.arange(W * H, dtype=np.int32)
    ref = np.asarray(jax_wavefront_batch(
        jax_build_scene(js), camera_to_arrays(jax_build_camera(js.cam, W, H)), JaxParams(**kw),
        jnp.asarray(flat % W), jnp.asarray(flat // W), jnp.int32(3), jnp.int32(2), width=W,
        height=H, pool=512))
    out = _wavefront(scene, IntegratorParams(**kw), W, H, 2, 512, base=3)
    assert_close(out, ref, 2)
    assert ref.mean() > 1e-3


def test_wavefront_runs_bitwise_equal(spheres):
    scene, _ = spheres
    params = IntegratorParams(mode="cpu", assured_depth=2, max_bounces=8)
    a = _wavefront(scene, params, W, H, 3, 384)
    b = _wavefront(scene, params, W, H, 3, 384)
    np.testing.assert_array_equal(a, b)
