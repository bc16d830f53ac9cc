"""The differentiable tier's training step, in one process.

Port of `raytrace_tpu/parallel/distributed.py`'s `DIFF_SCENE_FIELDS`,
`split_diff_scene` (:127-152) and `make_train_step` (:153-201), with
torch autograd in place of `jax.vjp`. The step renders a sample batch
through `renderer.sample_batch` (`params.differentiable`), takes the
mean squared error of the mean image against a target, and pulls the
analytic cotangent of that loss back through the render.

The JAX step runs over a (tile, spp) device mesh and all-reduces the
gradients over it. Here it runs in one process; the all-reduce comes
with the port of the rest of parallel/ (ROADMAP queue 1, item 7), and a
world size above 1 raises until then.

Memory: a render's tape holds every bounce's lane tensors (several GB a
sample at 1200x600). So the step keeps one sample's tape at a time: the
first sample is rendered with its tape and the others without, which
gives the image and the cotangent; then the first tape is pulled back and
each other sample is rendered again with its tape and pulled back. The
same sample ids give the same forward, so the gradient is the one of a
single tape over all samples; a step of n samples renders 2n - 1.
"""
from __future__ import annotations

import torch

from ..models.scene import SceneTensors
from ..ops import raygen
from ..ops.texture import pool_to_f32_flat
from ..render.integrator import IntegratorParams
from ..render.renderer import sample_batch

# the scene fields that take gradients (the JAX package's list, :128-133);
# integer and bool tables (kinds, masks, texture descriptors) take none
DIFF_SCENE_FIELDS = (
    "sph_c", "sph_r", "sph_rgb", "sph_emissive",
    "ft_v0", "ft_e1", "ft_e2", "ft_norm", "ft_rgb", "ft_emissive",
    "mt_v0", "mt_e1", "mt_e2", "mt_const_norm", "mt_rgb_factor",
    "tex_pool", "sky_pool",
)


def split_diff_scene(scene: SceneTensors):
    """scene -> (diff, merge): diff maps each field of DIFF_SCENE_FIELDS
    that the scene holds to a copy of it (the mt_* fields with a mesh,
    sky_pool with a cube map; mt_const_norm and mt_rgb_factor are the
    shading attributes' columns 0:3 and 13:16; the texel pools as flat
    f32 RGB pools, bitwise the values their fetches give), and
    merge(diff) is `scene.replace(**diff)`."""
    diff = {k: getattr(scene, k).clone() for k in DIFF_SCENE_FIELDS
            if k.startswith(("sph_", "ft_"))}
    if scene.mesh is not None:
        m = scene.mesh
        diff.update({k: getattr(scene, k).clone() for k in ("mt_v0", "mt_e1", "mt_e2")})
        diff["mt_const_norm"] = m.attr[:, 0:3].clone()
        diff["mt_rgb_factor"] = m.attr[:, 13:16].clone()
        diff["tex_pool"] = pool_to_f32_flat(m.pool, m.pool_kind)
    if scene.sky is not None:
        diff["sky_pool"] = pool_to_f32_flat(scene.sky.pool, scene.sky.kind)
    return diff, lambda d: scene.replace(**d)


def make_train_step(n_samples: int = 1, loss_scale: float = 1.0):
    """Returns step(scene, cam, params, xs, ys, sample_base, target) ->
    (loss, (scene_grads, cam_grads)): the radiance sums of the pixels
    (xs, ys) over sample ids sample_base .. sample_base + n_samples - 1,
    loss = mean((sums / n_samples - target) ** 2) * loss_scale over the
    (N, 3) target, scene_grads a dict over split_diff_scene's fields and
    cam_grads one over the CameraArrays' tensors (the JAX step's pair).
    scene: SceneTensors; cam: raygen.CameraArrays; params: differentiable
    IntegratorParams. Raises in a torch.distributed group of more than
    one process: the gradients' all-reduce is not ported yet."""
    dist = torch.distributed
    world_size = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if world_size != 1:
        raise NotImplementedError(
            f"make_train_step runs in one process (world size {world_size}); the gradient "
            "all-reduce is not ported yet")
    if n_samples < 1:
        raise ValueError("n_samples must be >= 1")

    def step(scene: SceneTensors, cam: raygen.CameraArrays, params: IntegratorParams, xs, ys,
             sample_base: int, target: torch.Tensor):
        if not params.differentiable:
            raise ValueError("make_train_step needs IntegratorParams(differentiable=True)")
        diff, merge = split_diff_scene(scene)
        leaves = {k: v.detach().requires_grad_() for k, v in diff.items()}
        cam_leaves = {k: v.detach().clone().requires_grad_() for k, v in vars(cam).items()
                      if v is not None}
        sc, cm = merge(leaves), raygen.CameraArrays(**cam_leaves)

        def render(s: int, tape: bool):
            with torch.set_grad_enabled(tape):
                return sample_batch(sc, params, xs, ys, sample_base + s, 1, cam=cm)

        first = render(0, True)
        acc = first.detach()
        for s in range(1, n_samples):
            acc = acc + render(s, False)
        err = acc / n_samples - target
        n_total = err.numel()
        loss = (err * err).sum() / n_total * loss_scale
        # d(loss)/d(sums) = 2 err / (n_total n_samples) loss_scale
        cot = (2.0 * loss_scale / n_total / n_samples) * err
        first.backward(cot)
        del first
        for s in range(1, n_samples):
            render(s, True).backward(cot)

        def grads(d):
            return {k: v.grad if v.grad is not None else torch.zeros_like(v) for k, v in d.items()}

        return loss, (grads(leaves), grads(cam_leaves))

    return step
