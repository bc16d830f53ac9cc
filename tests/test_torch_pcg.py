"""Port parity under the reference's `pcg` generator: every path of the
port with generator="pcg" against the JAX package with
raytrace_tpu.ops.rng.GENERATOR set to "pcg" (its RTPU_RNG), on the same
pixels and sample ids: raygen with a lens (rays to 1e-6, draws bitwise),
trace_tiles' plain version against the JAX trace_tiles in Pallas
interpret mode, mesh_trace's plain version and sample_batch (both
semantics, a mesh scene among them) against the JAX sample_batch, and the
wavefront against the JAX wavefront. The gates are the existing parity
tests' own: bitwise RNG words, the lane gate of test_torch_trace_kernel
and the image gate of test_torch_mesh_path. jit caches do not key on
the JAX global, so each test clears them before and after.

Also: the jump-ahead constants the CUDA kernel draws pcg by
(csrc/trace_kernel.cu's pcg_mul / pcg_inc) against stepping the
generator, the Renderer's generator on every driver, and the camera's
required device."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from raytrace_tpu.models.camera import build_camera as jax_build_camera
from raytrace_tpu.models.scene import build_scene as jax_build_scene
from raytrace_tpu.ops import raygen as jax_raygen
from raytrace_tpu.ops import rng as jax_rng
from raytrace_tpu.ops.pallas import trace_kernel as jax_tk
from raytrace_tpu.render.integrator import IntegratorParams as JaxParams
from raytrace_tpu.render.renderer import camera_to_arrays as jax_camera_to_arrays
from raytrace_tpu.render.wavefront import wavefront_batch as jax_wavefront_batch
from raytrace_tpu_torch.kernels import build
from raytrace_tpu_torch.models.camera import build_camera
from raytrace_tpu_torch.models.scene import build_scene
from raytrace_tpu_torch.models.walled import walled_scheme
from raytrace_tpu_torch.ops import mesh_kernel as mk
from raytrace_tpu_torch.ops import raygen, rng
from raytrace_tpu_torch.ops import trace_kernel as tk
from raytrace_tpu_torch.render.integrator import IntegratorParams
from raytrace_tpu_torch.render.renderer import Renderer
from test_torch_integrator import jax_ref, port_run, port_scene, sphere_scheme
from test_torch_mesh_path import MAX_BOUNCES as MESH_BOUNCES, _jax_ref, _port, assert_close
from test_torch_mesh_scene import octa_schemes, write_gltf
from test_torch_renderer import tile_gate
from test_torch_scene import schemes
from test_torch_trace_kernel import ASSURED, MAX_BOUNCES, SIZES, lane_gate
from test_torch_wavefront import _wavefront

W, H = 48, 24
MASK = 0xFFFFFFFF


@pytest.fixture
def jax_pcg(monkeypatch):
    """The JAX package under pcg for the test's span (its caches cleared)."""
    jax.clear_caches()
    monkeypatch.setattr(jax_rng, "GENERATOR", "pcg")
    yield
    monkeypatch.undo()
    jax.clear_caches()


def test_kernel_jump_ahead_constants():
    """trace_kernel.cu draws pcg's k-th number of a bounce as the LCG
    jumped k steps, s_k = A_k s + C_k: its constants and recurrences,
    read from the source, against stepping ops/rng.py's pcg."""
    src = (build.CSRC / "trace_kernel.cu").read_text()
    mul = int(re.search(r"kPcgMul = (\d+)u;", src).group(1))
    inc = int(re.search(r"kPcgInc = (\d+)u;", src).group(1))
    assert "kPcgMul * pcg_mul(k - 1)" in src and "kPcgMul * pcg_inc(k - 1) + kPcgInc" in src
    a, c = [1], [0]
    for _ in range(8):
        a.append(a[-1] * mul & MASK)
        c.append((mul * c[-1] + inc) & MASK)
    s0 = torch.from_numpy(np.random.default_rng(3).integers(0, 2**32, 4096, dtype=np.int64))
    s = s0
    for k in range(1, 9):
        s, word = rng.next_u32(s, "pcg")
        jumped = (s0 * a[k] + c[k]) & MASK
        assert torch.equal(jumped, s), k
        # C_k = inc * (A_{k-1} + ... + 1)
        assert c[k] == inc * sum(a[:k]) & MASK
    # the output permutation as the kernel writes it, on the jumped state
    x = s
    w = (((x >> ((x >> 28) + 4)) ^ x) * 277803737) & MASK
    assert torch.equal((w >> 22) ^ w, word)


def test_raygen_with_lens_matches_jax(jax_pcg):
    """Lens and jitter draws under pcg: words bitwise, rays to 1e-6."""
    jscheme, scheme = schemes("walled", 64, 32, ASSURED)
    jscheme.cam.lens_r = scheme.cam.lens_r = 0.15
    cam = build_camera(scheme.cam, 64, 32)
    pix = np.arange(64 * 32, dtype=np.int32)
    xs, ys, samp = pix % 64, pix // 64, np.full_like(pix, 1234)
    state = rng.init_state(*(torch.from_numpy(a) for a in (xs, ys, samp)))
    state, ro, rd = raygen.generate(state, torch.from_numpy(xs), torch.from_numpy(ys),
                                    tk.make_cam_vec(cam), has_lens=True, generator="pcg")
    jstate = jax_rng.init_state(jnp.asarray(xs), jnp.asarray(ys), 64, 32, jnp.asarray(samp))
    jstate, jro, jrd = jax_raygen.generate(
        jstate, jnp.asarray(xs), jnp.asarray(ys),
        jax_camera_to_arrays(jax_build_camera(jscheme.cam, 64, 32)))
    np.testing.assert_array_equal(state.numpy().astype(np.uint32), np.asarray(jstate))
    for a, b in zip((*ro, *rd), (*jro, *jrd)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    weyl = raygen.generate(rng.init_state(*(torch.from_numpy(a) for a in (xs, ys, samp))),
                           torch.from_numpy(xs), torch.from_numpy(ys), tk.make_cam_vec(cam),
                           has_lens=True)
    assert not torch.equal(weyl[0], state)  # the generators differ


@pytest.mark.parametrize("name,spl", [("walled", 1), ("mixed", 4)])
def test_trace_tiles_reference_matches_jax(jax_pcg, name, spl):
    w, h = SIZES[name]
    js, ps = schemes(name, w, h, ASSURED)
    jscene, scene = jax_build_scene(js), build_scene(ps)
    jsph, jft = jax_tk.pack_scene_tables(jscene)
    jcv = jax_tk.make_cam_vec(jax_build_camera(js.cam, w, h))
    flat = np.arange(w * h, dtype=np.int32)
    xs, ys = (flat % w).reshape(-1, 128), (flat // w).reshape(-1, 128)
    samp = np.full_like(xs, 17)
    statics = dict(n_sph=scene.n_spheres, n_ft=scene.n_free_tris, has_lens=False,
                   assured=ASSURED, max_bounces=MAX_BOUNCES, samples_per_lane=spl)
    with pltpu.force_tpu_interpret_mode():
        ref = jax_tk.trace_tiles(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(samp),
                                 jnp.asarray(jsph), jnp.asarray(jft), jnp.asarray(jcv),
                                 interpret=True, **statics)
    ref = [np.asarray(r) for r in ref]
    tables = tk.SceneTables(scene, build_camera(ps.cam, w, h), 0.5)
    launches = dict(tk.LAUNCHES)
    args = (torch.from_numpy(xs), torch.from_numpy(ys), torch.from_numpy(samp), tables.sph,
            tables.ft, tables.cam_vec)
    ours = tk.trace_tiles(*args, generator="pcg", **statics)
    assert tk.LAUNCHES == launches  # CPU tensors never reach the CUDA kernel
    for o_, r_ in list(zip(ours, ref))[: 9 if spl == 1 else 3]:
        lane_gate(o_.numpy(), r_)
    assert ref[0].mean() > 0.01
    weyl = tk.trace_tiles(*args, **statics)
    assert not torch.equal(weyl[0], ours[0])
    with pytest.raises(ValueError):
        tk.trace_tiles(*args, generator="xorshift", **statics)


@pytest.fixture(scope="module")
def octahedra(tmp_path_factory):
    path = write_gltf(tmp_path_factory.mktemp("octa") / "m.gltf", textured=True, normal_map=True)
    js, ps = octa_schemes(path, 64, 32)
    return jax_build_scene(js), js, ps


@pytest.mark.parametrize("route", ["brute", "walk"])
def test_mesh_trace_reference_matches_jax(jax_pcg, octahedra, route, monkeypatch):
    """mesh_trace's plain version (8 draws a bounce) under pcg against the
    JAX sample_batch, 4 samples at 2 a lane from sample id 5."""
    jscene, js, ps = octahedra
    real = mk.mesh_trace
    monkeypatch.setattr(mk, "mesh_trace", lambda *a, **kw: real(*a, generator="pcg", **kw))
    ref = _jax_ref(jscene, js, 3, 5, 4)
    out = _port(jscene, ps, route, 3, 5, 4, 2)
    assert_close(out, ref, 4)
    assert out.mean() > 0.01
    monkeypatch.undo()
    assert not np.array_equal(out, _port(jscene, ps, route, 3, 5, 4, 2))  # weyl differs


@pytest.fixture(scope="module")
def spheres():
    js = sphere_scheme()
    js.render_info.width, js.render_info.height = W, H
    return jax_build_scene(js), js


MODES = {"gpu": dict(mode="gpu"), "cpu": dict(mode="cpu"),
         "cpu-dls": dict(mode="cpu", dir_light_samp=True), "mesh-cpu": dict(mode="cpu")}


@pytest.mark.parametrize("mode", list(MODES))
def test_sample_batch_matches_jax(jax_pcg, spheres, octahedra, mode):
    """The integrator under pcg: the spheres in both semantics (and with
    direct-light sampling), and the octahedra (8 draws a bounce) in cpu
    semantics, 2 samples from sample id 3."""
    if mode == "mesh-cpu":
        jscene, js, _ = octahedra
        w, h = 64, 32
    else:
        (jscene, js), w, h = spheres, W, H
    kw = dict(assured_depth=2, max_bounces=MESH_BOUNCES, **MODES[mode])
    ref = jax_ref(jscene, js, JaxParams(**kw), w, h, base=3)
    out = port_run(port_scene(jscene, js, w, h), IntegratorParams(generator="pcg", **kw), w, h,
                   base=3)
    assert_close(out, ref, 2)
    assert ref.mean() > 1e-3


@pytest.mark.parametrize("mode", ["gpu", "cpu"])
def test_wavefront_matches_jax(jax_pcg, spheres, mode):
    jscene, js = spheres
    kw = dict(assured_depth=2, max_bounces=8, mode=mode)
    flat = np.arange(W * H, dtype=np.int32)
    ref = np.asarray(jax_wavefront_batch(
        jscene, jax_camera_to_arrays(jax_build_camera(js.cam, W, H)), JaxParams(**kw),
        jnp.asarray(flat % W), jnp.asarray(flat // W), jnp.int32(3), jnp.int32(2), width=W,
        height=H, pool=512))
    out = _wavefront(port_scene(jscene, js, W, H), IntegratorParams(generator="pcg", **kw), W, H,
                     2, 512, base=3)
    assert_close(out, ref, 2)
    assert ref.mean() > 1e-3


@pytest.mark.parametrize("kw,driver", [
    ({}, "fused"), ({"use_fused": False}, "wavefront"),
    ({"use_fused": False, "use_wavefront": False}, "plain"),
], ids=["fused", "wavefront", "plain"])
def test_renderer_generator_on_every_driver(kw, driver):
    """Renderer(generator="pcg") on each driver of the walled frame agrees
    with the plain driver under the tile gate, differs from weyl, and
    continues bitwise (render(8, batch=4) against render(4) twice)."""
    scheme = walled_scheme(64, 32)
    r = Renderer(scheme, device="cpu", generator="pcg", **kw)
    assert r.driver == driver and r.params.generator == "pcg"
    img = r.render(samples=8, batch=4, progress=False)
    ref = Renderer(scheme, device="cpu", generator="pcg", use_fused=False,
                   use_wavefront=False).render(samples=8, progress=False)
    tile_gate(img, ref)
    weyl = Renderer(scheme, device="cpu", **kw).render(samples=8, progress=False)
    assert not np.array_equal(weyl, img)
    half = Renderer(scheme, device="cpu", generator="pcg", **kw)
    half.render(samples=4, progress=False)
    half.render(samples=4, progress=False)
    np.testing.assert_array_equal(half.target.acc, r.target.acc)


def test_unknown_generator_raises():
    with pytest.raises(ValueError):
        IntegratorParams(generator="xorshift")
    with pytest.raises(ValueError):
        Renderer(walled_scheme(32, 16), device="cpu", generator="xorshift")


def test_camera_to_arrays_needs_a_device():
    """The camera's tensors land on the device asked for; no silent CPU
    default."""
    cam = build_camera(walled_scheme(32, 16).cam, 32, 16)
    with pytest.raises(TypeError):
        raygen.camera_to_arrays(cam)
    arrays = raygen.camera_to_arrays(cam, "cpu")
    assert arrays.o.device.type == "cpu" and arrays.lens_r is None
    assert arrays.o.dtype == torch.float32
