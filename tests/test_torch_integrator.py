"""Port parity for the integrator: the port's `sample_batch` (raygen in
the integrator's formulation, `trace_paths`, `_bounce_step`) against the
JAX package's `sample_batch` on the same pixels and sample ids, in gpu
semantics, cpu semantics and cpu semantics with direct-light sampling,
on four scenes: spheres (tests/test_wavefront.py:29-52), the mixed
sphere / free-triangle / dielectric scene, the textured, normal-mapped
octahedra and the 2,097-triangle surface. The JAX side runs its XLA
cluster walk; the port's mesh hit is `mesh_hit` (its plain version here).
Scenes cross with `from_reference`, so both sides walk one cluster
layout.

Also the cpu-semantics closed forms of tests/test_dls.py:104-158 through
the port's `_bounce_step` on the same crafted lane states, and
debug_single_ray and the mode divergence inside a sphere
(tests/test_render.py:63-109).

Gate: test_torch_mesh_path.assert_close (under 0.5% + 0.3% per extra
sample of lanes off by > 1e-3 relative, channel means within 8e-3
relative): streams are bit-identical, and XLA's FMA contraction on the
CPU flips a few knife-edge paths."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytrace_tpu.models import config as jax_cfg
from raytrace_tpu.models.camera import build_camera as jax_build_camera
from raytrace_tpu.models.scene import build_scene as jax_build_scene
from raytrace_tpu.render.integrator import IntegratorParams as JaxParams
from raytrace_tpu.render.renderer import camera_to_arrays, sample_batch as jax_sample_batch
from raytrace_tpu_torch.models.camera import build_camera
from raytrace_tpu_torch.models.scene import SceneTensors, from_reference
from raytrace_tpu_torch.render.integrator import DLS_NORMZE, IntegratorParams, _bounce_step
from raytrace_tpu_torch.render.renderer import sample_batch
from test_dls import AWAY, CI, NRM, POS, _scheme as dls_scheme
from test_render import _scheme as render_scheme, _sphere
from test_torch_mesh_path import assert_close
from test_torch_mesh_scene import octa_schemes, surface_scene, write_gltf
from test_torch_scene import reference_fields, schemes

W, H, SPP, MAX_BOUNCES, ASSURED = 48, 24, 2, 6, 2
# the surface's lit lanes are few (about 130 of 1,152) and roulette from
# bounce 2 on adds a flipped self-hit's throughput to the mean: it takes
# assured 5, as in test_torch_mesh_path
ASSURED_OF = {"surface": 5}
MODES = {"gpu": dict(mode="gpu"), "cpu": dict(mode="cpu"),
         "cpu-dls": dict(mode="cpu", dir_light_samp=True)}


def sphere_scheme():
    """The five-sphere scheme of tests/test_wavefront.py:29-52 (JAX)."""
    members = [
        _sphere([0, -1.2, -10], 2.0, [0.7, 0.7, 0.7], {"divert_ray": "Diff"}),
        _sphere([1.5, 0.5, -8], 1.0, [0.9, 0.9, 0.9], {"divert_ray": "Spec"}),
        _sphere([-1.5, 0.5, -8], 1.0, [0.9, 0.9, 0.9],
                {"divert_ray": jax_cfg.Tagged("Dielectric", {"n_out": 1.0, "n_in": 1.5})}),
        _sphere([0, 2.2, -10], 1.5, [0, 0, 0], {"divert_ray": "Diff", "emissive": [6, 6, 6]}),
        _sphere([0, 0, -30], 15.0, [0.5, 0.5, 0.5], {"divert_ray": "Diff"}),
    ]
    s = render_scheme()
    s.scene_members = [jax_cfg._parse_member(m) for m in members]
    return s


def port_scene(jscene, js, width, height):
    """The port's SceneTensors of a JAX scene (the camera of its scheme)."""
    return SceneTensors(from_reference(reference_fields(jscene)),
                        build_camera(js.cam, width, height), 0.5)


def jax_ref(jscene, js, params, width, height, base=0, n=SPP):
    flat = np.arange(width * height, dtype=np.int32)
    return np.asarray(jax_sample_batch(
        jscene, camera_to_arrays(jax_build_camera(js.cam, width, height)), params, width, height,
        jnp.asarray(flat % width), jnp.asarray(flat // width), jnp.int32(base), jnp.int32(n)))


def port_run(scene, params, width, height, base=0, n=SPP):
    flat = torch.arange(width * height, dtype=torch.int32)
    return sample_batch(scene, params, flat % width, flat // width, base, n).numpy()


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """name -> (JAX scene, JAX scheme), built once per module."""
    js_oct, _ = octa_schemes(write_gltf(tmp_path_factory.mktemp("octa") / "m.gltf",
                                        textured=True, normal_map=True), W, H)
    js_mixed, _ = schemes("mixed", W, H, ASSURED)
    jsurf, _, js_surf, _ = surface_scene(2097, W, H)
    out = {"spheres": sphere_scheme(), "mixed": js_mixed, "octahedra": js_oct}
    out = {k: (jax_build_scene(js), js) for k, js in out.items()}
    out["surface"] = (jsurf, js_surf)
    return out


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("name", ["spheres", "mixed", "octahedra", "surface"])
def test_sample_batch_matches_jax(scenes, name, mode):
    jscene, js = scenes[name]
    kw = dict(assured_depth=ASSURED_OF.get(name, ASSURED), max_bounces=MAX_BOUNCES, **MODES[mode])
    ref = jax_ref(jscene, js, JaxParams(**kw), W, H)
    out = port_run(port_scene(jscene, js, W, H), IntegratorParams(**kw), W, H)
    assert_close(out, ref, SPP)
    if name != "mixed" or mode == "gpu":  # cpu semantics zero the mixed scene's lights
        assert ref.mean() > 1e-3


# --- direct-light sampling closed forms (tests/test_dls.py) ---------------


def _dls_state(n, dls_pos, dls_norm, dls_ci, self_idx, rd):
    one = torch.ones(n)
    c3 = lambda v: tuple(one * float(np.float32(x)) for x in v)
    return dict(ro=c3([0.0, 0.0, 0.0]), rd=c3(rd), L=c3([0.0] * 3), ci=c3([1.0] * 3), inten=one,
                rng=torch.full((n,), 12345, dtype=torch.int64),
                active=torch.zeros(n, dtype=torch.bool),  # only the pending term resolves
                bounce=torch.ones(n, dtype=torch.int32),
                dls=dict(active=torch.ones(n, dtype=torch.bool), pos=c3(dls_pos),
                         norm=c3(dls_norm), ci=c3(dls_ci),
                         self_idx=torch.full((n,), self_idx, dtype=torch.int64)))


def _dls_run(st, with_occluder=False):
    js = dls_scheme(with_occluder)
    scene = port_scene(jax_build_scene(js), js, 32, 16)
    params = IntegratorParams(mode="cpu", dir_light_samp=True, assured_depth=2, max_bounces=8)
    return torch.stack(_bounce_step(scene, params, st)["L"], dim=1).numpy()


def _to_emitter():
    to_e = np.array([0.0, 20.0, -10.0]) - np.array(POS)
    return list(to_e / np.linalg.norm(to_e))


@pytest.mark.parametrize("case", ["magnitude", "self-emitter", "bounce-element", "occluded",
                                  "light-dot"])
def test_dls_closed_forms(case):
    """radiance.rs:89-120: ci * emissive * light_dot / (30 pi) exactly;
    nothing from the emitter that made the pending hit, from the element
    this bounce hits, or through an occluder; light_dot scales it."""
    em = np.array([3.0, 4.0, 5.0])
    tilt = np.array([3.0, 4.0, 0.0]) / 5.0
    if case == "magnitude":
        L = _dls_run(_dls_state(4, POS, NRM, CI, 0, AWAY))
        expected = np.array(CI) * em * DLS_NORMZE
    elif case == "self-emitter":
        L, expected = _dls_run(_dls_state(4, POS, NRM, CI, 1, AWAY)), 0.0
    elif case == "bounce-element":
        st = _dls_state(4, POS, NRM, CI, 0, _to_emitter())
        st["ro"] = st["dls"]["pos"]
        L, expected = _dls_run(st), 0.0
    elif case == "occluded":
        L, expected = _dls_run(_dls_state(4, POS, NRM, CI, 0, AWAY), with_occluder=True), 0.0
    else:
        L = _dls_run(_dls_state(4, POS, list(tilt), CI, 0, AWAY))
        expected = np.array(CI) * em * (tilt[1] * DLS_NORMZE)
    np.testing.assert_allclose(L, np.broadcast_to(expected, (4, 3)), rtol=1e-5, atol=0)


# --- debug_single_ray and the semantics inside a sphere (test_render.py) --


def _render(js, **kw):
    params = IntegratorParams(assured_depth=2, max_bounces=8, **kw)
    w, h = js.render_info.width, js.render_info.height
    jscene = jax_build_scene(js)
    out = port_run(port_scene(jscene, js, w, h), params, w, h, n=4)
    ref = jax_ref(jscene, js, JaxParams(assured_depth=2, max_bounces=8, **kw), w, h, n=4)
    assert_close(out, ref, 4)
    return out.reshape(h, w, 3) / 4.0


@pytest.mark.parametrize("mode", ["cpu", "gpu"])
def test_debug_single_ray(mode):
    """Only the emissive sphere shows, first hit only: a 4-sample mean is
    a multiple of 1.5."""
    img = _render(render_scheme(), mode=mode, debug_single_ray=True)
    assert img.max() == pytest.approx(6.0, rel=1e-5)
    assert set(np.unique(np.round(img, 4)).tolist()) <= {0.0, 1.5, 3.0, 4.5, 6.0}


def test_mode_divergence_inside_sphere():
    """Camera inside a big emissive sphere: cpu semantics see it (the far
    root), gpu semantics miss it (the near root only)."""
    js = render_scheme()
    js.scene_members.append(jax_cfg._parse_member(
        _sphere([0, 0, 0], 100.0, [0, 0, 0], {"divert_ray": "Diff", "emissive": [1, 1, 1]})))
    img_cpu = _render(js, mode="cpu", debug_single_ray=True)
    img_gpu = _render(js, mode="gpu", debug_single_ray=True)
    assert (img_gpu.sum(-1) == 0).sum() > (img_cpu.sum(-1) == 0).sum() + 100
    assert (img_cpu.sum(-1) == 3.0).any()
