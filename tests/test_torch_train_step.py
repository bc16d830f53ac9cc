"""The port's `make_train_step` (parallel/distributed.py, one process)
against the JAX package's on a one-device mesh, make_mesh(tile=1,
spp=1): the loss and every gradient, on test_parallel.py's scheme (two
spheres and a DiffSpec free triangle) at 48x24 against a target from a
seed, gpu semantics, max_bounces 4 (test_parallel.py's train step), at 1
sample and at 2 (the step's two-pass path: a second sample re-rendered
with its tape). Gate: the loss within 1e-5 relative, each gradient
within relative L2 1e-3 (exactly 0 where the JAX gradient is). Also the
refusal of a params without `differentiable`, and five steps of gradient
descent on a small walled frame from a perturbed scene back toward the
true scene's image, the loss falling at every step (chip_smoke.py's
phase 10 takes them at 1200x600). The step over a mesh of processes is in
test_torch_parallel.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.models.camera import build_camera as jax_build_camera
from raytrace_tpu.models.scene import build_scene as jax_build_scene
from raytrace_tpu.parallel.distributed import make_train_step as jax_make_train_step
from raytrace_tpu.parallel.mesh import make_mesh
from raytrace_tpu.render.integrator import IntegratorParams as JaxParams
from raytrace_tpu.render.renderer import camera_to_arrays as jax_camera_to_arrays
from raytrace_tpu_torch.models.camera import build_camera
from raytrace_tpu_torch.models.scene import SceneTensors, build_scene, from_reference
from raytrace_tpu_torch.models.walled import walled_scheme
from raytrace_tpu_torch.ops.raygen import camera_to_arrays
from raytrace_tpu_torch.parallel.distributed import make_train_step
from raytrace_tpu_torch.render.integrator import IntegratorParams
from raytrace_tpu_torch.render.renderer import sample_batch
from test_parallel import _tiny_scheme
from test_torch_diff import CAM_FIELDS, rel_l2
from test_torch_scene import reference_fields

W, H = 48, 24
KW = dict(assured_depth=2, max_bounces=4)


@pytest.fixture(scope="module")
def scene():
    js = _tiny_scheme()
    return jax_build_scene(js), js


def _target():
    return np.random.default_rng(7).uniform(0.0, 1.0, (W * H, 3)).astype(np.float32)


def _pixels():
    flat = np.arange(W * H, dtype=np.int32)
    return flat % W, flat // W


def _jax_step(jscene, js, n_samples):
    step = jax_make_train_step(make_mesh(jax.devices()[:1], tile=1, spp=1), W, H,
                               n_samples=n_samples, loss_scale=2.0)
    xs, ys = (jnp.asarray(a) for a in _pixels())
    loss, (g, gc) = step(jscene, jax_camera_to_arrays(jax_build_camera(js.cam, W, H)),
                         JaxParams(differentiable=True, **KW), xs, ys, jnp.int32(3),
                         jnp.asarray(_target()))
    return float(loss), {k: np.asarray(v) for k, v in g.items()}, {
        k: np.asarray(getattr(gc, k)) for k in CAM_FIELDS}


def _port_step(jscene, js, n_samples):
    cam = build_camera(js.cam, W, H)
    sc = SceneTensors(from_reference(reference_fields(jscene)), cam, 0.5)
    step = make_train_step(n_samples=n_samples, loss_scale=2.0)
    xs, ys = (torch.from_numpy(a) for a in _pixels())
    loss, (g, gc) = step(sc, camera_to_arrays(cam, "cpu"),
                         IntegratorParams(differentiable=True, **KW),
                         xs, ys, 3, torch.from_numpy(_target()))
    return float(loss), g, gc


@pytest.mark.parametrize("n_samples", [1, 2])
def test_train_step_matches_jax(scene, n_samples):
    jl, jg, jgc = _jax_step(*scene, n_samples)
    pl, pg, pgc = _port_step(*scene, n_samples)
    assert abs(pl - jl) <= 1e-5 * abs(jl)
    assert set(pg) == {"sph_c", "sph_r", "sph_rgb", "sph_emissive", "ft_v0", "ft_e1", "ft_e2",
                       "ft_norm", "ft_rgb", "ft_emissive"}
    pairs = [(k, v.numpy(), jg[k][: v.shape[0]]) for k, v in pg.items()]
    pairs += [(k, pgc[k].numpy(), jgc[k]) for k in CAM_FIELDS]
    for k, ours, ref in pairs:
        assert np.isfinite(ours).all(), k
        if np.abs(ref).max():
            assert rel_l2(ours, ref) <= 1e-3, f"{k}: relative L2 {rel_l2(ours, ref):.3e}"
        else:
            assert not np.abs(ours).max(), k
    assert np.abs(jg["sph_emissive"]).max() > 0 and np.abs(jg["ft_rgb"]).max() > 0


def test_train_step_refuses_a_forward_params(scene):
    jscene, js = scene
    cam = build_camera(js.cam, W, H)
    sc = SceneTensors(from_reference(reference_fields(jscene)), cam, 0.5)
    xs, ys = (torch.from_numpy(a) for a in _pixels())
    with pytest.raises(ValueError):
        make_train_step()(sc, camera_to_arrays(cam, "cpu"), IntegratorParams(**KW), xs, ys, 0,
                          torch.zeros(W * H, 3))


def perturbed_walled(scene: SceneTensors) -> SceneTensors:
    """The walled scene with its two emitters' emissive halved and its
    four walls' rgb moved by 0.1 (chip_smoke.py's phase 10)."""
    em = scene.sph_emissive.clone()
    em[7:9] *= 0.5
    rgb = scene.sph_rgb.clone()
    rgb[9:13] += 0.1
    return scene.replace(sph_emissive=em, sph_rgb=rgb)


def polyak_step(scene: SceneTensors, loss, grads, fields=("sph_emissive", "sph_rgb"),
                fraction=0.1) -> SceneTensors:
    """A gradient step over `fields` of `fraction` * loss / |g|^2: a
    tenth of the step that would reach a loss of 0 were the loss linear
    (the walls' rgb enter the image as a polynomial of the path length,
    and half that step overshoots)."""
    lr = fraction * float(loss) / sum(float((grads[k] ** 2).sum()) for k in fields)
    return scene.replace(**{k: getattr(scene, k) - lr * grads[k] for k in fields})


def test_descent_on_walled_lowers_the_loss():
    w, h = 32, 16
    ps = walled_scheme(w, h)
    cam = build_camera(ps.cam, w, h)
    true = SceneTensors(build_scene(ps), cam, 0.5)
    params = IntegratorParams(differentiable=True, max_bounces=8)
    flat = torch.arange(w * h, dtype=torch.int32)
    xs, ys = flat % w, flat // w
    with torch.no_grad():
        target = sample_batch(true, params, xs, ys, 0, 1)
    step = make_train_step()
    sc, losses = perturbed_walled(true), []
    for _ in range(5):
        loss, (g, _) = step(sc, camera_to_arrays(cam, "cpu"), params, xs, ys, 0, target)
        losses.append(float(loss))
        sc = polyak_step(sc, loss, g)
    assert all(b < a for a, b in zip(losses, losses[1:])), losses
