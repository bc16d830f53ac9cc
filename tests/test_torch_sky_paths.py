"""Port parity for the cube map on the integrator paths: the port's
`sample_batch` (miss records in gpu and cpu semantics, the post-loop
resolve) against the JAX package's on a sphere + sky scene and on the
textured octahedra + sky, debug_single_ray's in-loop sky, the wavefront's
resolve at retirement against `sample_batch` (rtol 1e-4, atol 1e-4, as
test_torch_wavefront) and bitwise across runs, and `mesh_trace_reference`
with the sky against the JAX `sample_batch` on both nearest-hit routes.
Gate: test_torch_mesh_path.assert_close."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.models import config as jax_cfg
from raytrace_tpu.models.scene import build_scene as jax_build_scene
from raytrace_tpu.ops.vec import Vec3
from raytrace_tpu.render.integrator import IntegratorParams as JaxParams
from raytrace_tpu.render.integrator import _bounce_step as jax_bounce_step
from raytrace_tpu_torch.models.camera import build_camera
from raytrace_tpu_torch.models.scene import from_reference
from raytrace_tpu_torch.ops import mesh_kernel as mk
from raytrace_tpu_torch.ops import raygen, rng
from raytrace_tpu_torch.render.integrator import (IntegratorParams, _bounce_step, init_lanes,
                                                  resolve_sky)
from test_torch_cubemap import add_sky, write_faces
from test_torch_integrator import jax_ref, port_run, port_scene, sphere_scheme
from test_torch_mesh_path import assert_close
from test_torch_mesh_scene import octa_schemes, write_gltf
from test_torch_scene import reference_fields
from test_torch_wavefront import _plain, _wavefront

W, H, SPP, MAX_BOUNCES = 48, 24, 2, 6
ASSURED = {"spheres": 2, "octahedra": 3}


@pytest.fixture(scope="module")
def sky_scenes(tmp_path_factory):
    """name -> (JAX scene, JAX scheme) of the two scenes under one sky."""
    value = write_faces(tmp_path_factory.mktemp("faces"))
    js_oct, _ = octa_schemes(write_gltf(tmp_path_factory.mktemp("octa") / "m.gltf",
                                        textured=True, normal_map=True), W, H)
    out = {}
    for name, js in (("spheres", sphere_scheme()), ("octahedra", js_oct)):
        add_sky(js, jax_cfg, jax_cfg._parse_member, value)
        out[name] = (jax_build_scene(js), js)
    return out


@pytest.fixture(scope="module")
def refs(sky_scenes):
    """The JAX sample_batch of (scene, mode), computed once."""
    cache = {}

    def get(name, mode):
        if (name, mode) not in cache:
            jscene, js = sky_scenes[name]
            cache[name, mode] = jax_ref(jscene, js, JaxParams(
                assured_depth=ASSURED[name], max_bounces=MAX_BOUNCES, mode=mode), W, H)
        return cache[name, mode]

    return get


def _params(name, **kw):
    return IntegratorParams(assured_depth=ASSURED[name], max_bounces=MAX_BOUNCES, **kw)


@pytest.mark.parametrize("mode", ["gpu", "cpu"])
@pytest.mark.parametrize("name", ["spheres", "octahedra"])
def test_sample_batch_sky_matches_jax(sky_scenes, refs, name, mode):
    jscene, js = sky_scenes[name]
    scene = port_scene(jscene, js, W, H)
    assert scene.sky is not None and (scene.mesh is None) == (name == "spheres")
    out = port_run(scene, _params(name, mode=mode), W, H)
    ref = refs(name, mode)
    assert_close(out, ref, SPP)
    # the sky's term is there: the same scene without it is darker
    no_sky = port_scene(jscene, js, W, H)
    no_sky.sky = None
    assert out.sum() > 1.2 * port_run(no_sky, _params(name, mode=mode), W, H).sum()


def test_debug_single_ray_shows_the_sky(sky_scenes):
    """debug_single_ray samples the sky in its one bounce (:955-959): a
    miss shows the sky's texel, a hit the first emissive. Held against
    the JAX `_bounce_step` on the same primary rays: the JAX trace_paths
    cannot run this (with debug_single_ray it carries no miss record,
    :1005, which `_bounce_step` writes at :885 and :909), so its state
    gets one."""
    jscene, js = sky_scenes["spheres"]
    scene = port_scene(jscene, js, W, H)
    flat = torch.arange(W * H, dtype=torch.int32)
    xs, ys = flat % W, flat // W
    state, ro, rd = raygen.generate_paths(rng.init_state(xs, ys, torch.zeros_like(xs)), xs, ys,
                                          scene.cam, scene.has_lens)
    for mode in ("gpu", "cpu"):
        kw = dict(assured_depth=2, max_bounces=8, debug_single_ray=True, mode=mode)
        params = IntegratorParams(**kw)
        out = torch.stack(_bounce_step(scene, params, init_lanes(scene, params, ro, rd, state))[
            "L"], -1).numpy()
        v3 = lambda t: Vec3(*(jnp.asarray(c.numpy()) for c in t))
        zero, one = jnp.zeros((W * H,), jnp.float32), jnp.ones((W * H,), jnp.float32)
        st = dict(ro=v3(ro), rd=v3(rd), L=Vec3(zero, zero, zero), ci=Vec3(one, one, one),
                  inten=one, rng=jnp.asarray(state.numpy().astype(np.uint32)),
                  active=jnp.ones((W * H,), bool), bounce=jnp.zeros((W * H,), jnp.int32),
                  miss_d=Vec3(zero, zero, zero), miss_w=Vec3(zero, zero, zero))
        L = jax_bounce_step(jscene, JaxParams(**kw), st)["L"]
        ref = np.stack([np.asarray(c) for c in (L.x, L.y, L.z)], -1)
        assert_close(out, ref, 1)
        sky = (out > 0).all(-1) & (out <= 1.0).all(-1)  # sky texels; the emitter shows 6
        assert sky.mean() > 0.2 and (out.max(-1) == 6.0).any()


@pytest.mark.parametrize("mode", ["gpu", "cpu"])
def test_wavefront_sky_matches_sample_batch(sky_scenes, mode):
    """The miss record rides in the pool, is cleared on fresh lanes and
    resolves as the lane retires; a pool smaller than the work refills."""
    jscene, js = sky_scenes["octahedra"]
    scene = port_scene(jscene, js, W, H)
    params = _params("octahedra", mode=mode)
    ref = _plain(scene, params, W, H, SPP)
    np.testing.assert_allclose(_wavefront(scene, params, W, H, SPP, 512), ref, rtol=1e-4,
                               atol=1e-4)
    assert ref.mean() > 1e-2


def test_wavefront_sky_runs_bitwise_equal(sky_scenes):
    jscene, js = sky_scenes["spheres"]
    scene = port_scene(jscene, js, W, H)
    params = _params("spheres", mode="gpu")
    a = _wavefront(scene, params, W, H, 3, 384)
    b = _wavefront(scene, params, W, H, 3, 384)
    np.testing.assert_array_equal(a, b)


def test_resolve_sky_samples_only_the_retiring_misses(sky_scenes):
    """resolve_sky with a lane mask (the wavefront's retiring lanes) adds
    the sky on the masked lanes that missed, samples it on those alone,
    and leaves every other lane's L bit for bit."""
    jscene, js = sky_scenes["spheres"]
    scene = port_scene(jscene, js, W, H)
    g, n = np.random.default_rng(3), 1000
    f32 = lambda a: torch.from_numpy(a.astype(np.float32))
    L = tuple(f32(g.uniform(0, 1, n)) for _ in range(3))
    md = tuple(f32(g.normal(size=n)) for _ in range(3))
    mw = tuple(f32(np.where(g.uniform(size=n) < 0.5, 0.0, g.uniform(0.1, 1, n))) for _ in range(3))
    lanes = torch.from_numpy(g.uniform(size=n) < 0.5)
    missed = ((mw[0] > 0) | (mw[1] > 0) | (mw[2] > 0)) & lanes
    real, sampled = scene.sky.sample, []
    scene.sky.sample = lambda *d: sampled.append(d[0].numel()) or real(*d)
    try:
        out = resolve_sky(scene, L, md, mw, lanes=lanes)
    finally:
        del scene.sky.sample
    assert sampled == [int(missed.sum())] and 0 < sampled[0] < n
    rgb = real(*md)
    for k in range(3):
        assert torch.equal(out[k][~missed], L[k][~missed])
        assert torch.equal(out[k][missed], (L[k] + mw[k] * rgb[k])[missed])


@pytest.mark.parametrize("route", ["brute", "walk"])
def test_mesh_trace_sky_matches_jax(sky_scenes, refs, route):
    """mesh_trace_reference adds (throughput * inten) * sky(d) at a miss,
    the JAX driver's per-bounce add (fused_mesh.py:343-353): against the
    JAX sample_batch, launches of 1 and 2 samples per lane."""
    jscene, js = sky_scenes["octahedra"]
    tables = mk.MeshTables(from_reference(reference_fields(jscene)), build_camera(js.cam, W, H),
                           0.5)
    assert tables.sky is not None
    flat = torch.arange(W * H, dtype=torch.int32)
    xs, ys = flat % W, flat // W
    acc = np.zeros((W * H, 3), np.float32)
    for s0, spl in ((0, 1), (1, 1)) if route == "brute" else ((0, 2),):
        out = mk.mesh_trace(xs, ys, torch.full_like(xs, s0), tables, route=route,
                            assured=ASSURED["octahedra"], max_bounces=MAX_BOUNCES,
                            samples_per_lane=spl)
        acc += torch.stack(out, 1).numpy()
    assert_close(acc, refs("octahedra", "gpu"), SPP)
    assert acc.mean() > 1e-2

