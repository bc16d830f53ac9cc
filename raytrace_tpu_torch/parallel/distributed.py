"""Sharded render steps and the training step over the (tile, spp) mesh.

Port of `raytrace_tpu/parallel/distributed.py` on torch.distributed, one
process per device (torchrun; multihost.init, mesh.make_mesh). Pixel
blocks shard over "tile", sample ids over "spp"; each rank renders its
part through the drivers it would use alone, and the partial radiance
sums are all-reduced, the JAX package's psum: NCCL when every rank has a
card of its own, gloo on the CPU (or on CUDA tensors, several ranks on
one card). The training step also all-reduces every scene and camera
gradient over the mesh (the JAX :191).

- make_render_step (the JAX :24): the plain integrator, pixels over
  tile, samples over spp, one all-reduce over spp; gather_tiles puts the
  tile blocks back together.
- make_wavefront_render_step (:48): every rank the whole pixel set
  through the wavefront with its own sample slice, one all-reduce over
  the world.
- make_spp_sharded_step (:89): any driver, a contiguous sample slice per
  rank of a group, one all-reduce; the Renderer's `group=` uses it.
- DIFF_SCENE_FIELDS, split_diff_scene (:127-152) and make_train_step
  (:153-201), with torch autograd in place of `jax.vjp`. The step
  renders a sample batch through `renderer.sample_batch`
  (`params.differentiable`), takes the mean squared error of the mean
  image against a target, and pulls the analytic cotangent of that loss
  back through the render.

Memory: a render's tape holds every bounce's lane tensors (several GB a
sample at 1200x600). So the step keeps one sample's tape at a time: the
first sample is rendered with its tape and the others without, which
gives the image and the cotangent; then the first tape is pulled back and
each other sample is rendered again with its tape and pulled back. The
same sample ids give the same forward, so the gradient is the one of a
single tape over all samples; a step of n samples renders 2n - 1.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from ..models.scene import SceneTensors
from ..ops import raygen
from ..ops.texture import pool_to_f32_flat
from ..render.integrator import IntegratorParams
from ..render.renderer import sample_batch
from ..render.wavefront import wavefront_batch
from ..utils import profiling

# the scene fields that take gradients (the JAX package's list, :128-133);
# integer and bool tables (kinds, masks, texture descriptors) take none
DIFF_SCENE_FIELDS = (
    "sph_c", "sph_r", "sph_rgb", "sph_emissive",
    "ft_v0", "ft_e1", "ft_e2", "ft_norm", "ft_rgb", "ft_emissive",
    "mt_v0", "mt_e1", "mt_e2", "mt_const_norm", "mt_rgb_factor",
    "tex_pool", "sky_pool",
)


def sample_slice(n: int, size: int, rank: int) -> tuple:
    """(offset, count) of rank's contiguous share of n sample ids over
    size ranks: the first n % size ranks take one more, so every id is
    rendered once for any n (the JAX Renderer runs a remainder below the
    device count on one device instead)."""
    q, r = divmod(n, size)
    return rank * q + min(rank, r), q + (rank < r)


def _mesh_coords(mesh):
    """(tile group, spp group, tile size, spp size, tile rank, spp rank)."""
    tile, spp = mesh.get_group("tile"), mesh.get_group("spp")
    return (tile, spp, dist.get_world_size(tile), dist.get_world_size(spp),
            mesh.get_local_rank("tile"), mesh.get_local_rank("spp"))


def tile_block(x: torch.Tensor, n_tile: int, tile_rank: int) -> torch.Tensor:
    """tile_rank's contiguous block of the global pixel array x (the JAX
    P("tile") shard); its length must divide by n_tile."""
    if x.shape[0] % n_tile:
        raise ValueError(f"{x.shape[0]} pixels do not split over {n_tile} tile ranks")
    p = x.shape[0] // n_tile
    return x[tile_rank * p:(tile_rank + 1) * p]


def gather_tiles(block: torch.Tensor, mesh) -> torch.Tensor:
    """The tile blocks of every tile rank concatenated in tile order: the
    global (P, ...) array of a P("tile")-sharded one."""
    group = mesh.get_group("tile")
    parts = [torch.empty_like(block) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, block.contiguous(), group=group)
    return torch.cat(parts)


def make_render_step(mesh):
    """Returns (step, spp_size): step(scene, params, xs, ys, sample_base,
    n_samples) renders this tile rank's block of the global (P,) pixel
    arrays xs, ys through `renderer.sample_batch` at sample ids
    sample_base + spp_rank * n_samples onward, all-reduces the block's
    (P / tile, 3) sums over spp and returns them: spp_size * n_samples
    samples a pixel in all. gather_tiles gives the global array."""
    _, spp_g, n_tile, n_spp, t_rank, s_rank = _mesh_coords(mesh)

    def step(scene: SceneTensors, params: IntegratorParams, xs, ys, sample_base: int,
             n_samples: int) -> torch.Tensor:
        acc = sample_batch(scene, params, tile_block(xs, n_tile, t_rank),
                           tile_block(ys, n_tile, t_rank), sample_base + s_rank * n_samples,
                           n_samples)
        dist.all_reduce(acc, group=spp_g)
        return acc

    return step, n_spp


def make_wavefront_render_step(mesh, width: int, pool: int):
    """Returns (step, n_ranks): step(scene, params, xs, ys, sample_base,
    n_samples) renders every pixel of the tables xs, ys through
    `wavefront.wavefront_batch` at sample ids sample_base + flat_rank *
    n_samples onward (flat_rank the rank's (tile, spp) row-major index:
    sample slices keep every rank's lane pool full), all-reduces the
    (n_pix, 3) sums over the world and returns them: n_ranks * n_samples
    samples a pixel."""
    _, _, n_tile, n_spp, t_rank, s_rank = _mesh_coords(mesh)
    flat_rank = t_rank * n_spp + s_rank
    lanes = {}  # the lane pools (and CUDA graphs) between steps

    def step(scene: SceneTensors, params: IntegratorParams, xs, ys, sample_base: int,
             n_samples: int) -> torch.Tensor:
        img = wavefront_batch(scene, params, xs, ys, sample_base + flat_rank * n_samples,
                              n_samples, width, pool, cache=lanes)
        dist.all_reduce(img)
        return img

    return step, n_tile * n_spp


def make_spp_sharded_step(group, inner: Callable):
    """Wrap a driver `inner(*args, sample_base=, n_samples=, **kw) -> sums`
    into a step over the process group `group` (None: the world) and
    return (step, group size). step(*args, sample_base, n_samples, **kw)
    renders n_samples sample ids IN ALL from sample_base: this rank its
    contiguous slice (sample_slice: the first n_samples % size ranks take
    one more; a rank whose slice is empty still calls inner with 0), then
    one all-reduce of the sums over the group; every rank returns the
    same sums. The JAX step takes a count per device instead; a total
    lets any count split exactly. Every (pixel, sample) stream is the one
    process's, so the result is the rank-order sum of the slices' sums:
    bitwise the one-process render of the same ids up to the order of
    that sum."""
    size, rank = dist.get_world_size(group), dist.get_rank(group)

    def step(*args, sample_base: int, n_samples: int, **kw) -> torch.Tensor:
        offset, count = sample_slice(n_samples, size, rank)
        out = inner(*args, sample_base=sample_base + offset, n_samples=count, **kw)
        with profiling.span("dist.allreduce"):
            dist.all_reduce(out, group=group)
        return out

    return step, size


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


def _all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def make_train_step(mesh=None, n_samples: int = 1, loss_scale: float = 1.0):
    """Returns step(scene, cam, params, xs, ys, sample_base, target) ->
    (loss, (scene_grads, cam_grads)), scene_grads a dict over
    split_diff_scene's fields and cam_grads one over the CameraArrays'
    tensors (the JAX step's pair). scene: SceneTensors; cam:
    raygen.CameraArrays; params: differentiable IntegratorParams.

    mesh None: one process. The radiance sums of the pixels (xs, ys) over
    sample ids sample_base .. sample_base + n_samples - 1, loss =
    mean((sums / n_samples - target) ** 2) * loss_scale over the (N, 3)
    target.

    mesh (make_mesh): the JAX step (:163-192). xs, ys are the global (P,)
    pixel arrays; this rank renders its tile block at sample ids
    sample_base + spp_rank * n_samples onward, and target is its tile
    block (P / tile, 3). The image is the spp all-reduce of the sums over
    n_samples * spp; the loss the tile all-reduce of the block's squared
    error over P * 3; the cotangent 2 * loss_scale / (P * 3) / (n_samples
    * spp) * err is pulled back through this rank's samples, and every
    gradient is all-reduced over the world (one collective of all of them
    flattened). Loss and gradients are the same on every rank."""
    if n_samples < 1:
        raise ValueError("n_samples must be >= 1")
    if mesh is None:
        tile_g = spp_g = world = None
        n_tile, n_spp, t_rank, s_rank = 1, 1, 0, 0
    else:
        tile_g, spp_g, n_tile, n_spp, t_rank, s_rank = _mesh_coords(mesh)
        world = dist.group.WORLD

    def step(scene: SceneTensors, cam: raygen.CameraArrays, params: IntegratorParams, xs, ys,
             sample_base: int, target: torch.Tensor):
        if not params.differentiable:
            raise ValueError("make_train_step needs IntegratorParams(differentiable=True)")
        diff, merge = split_diff_scene(scene)
        leaves = {k: v.detach().requires_grad_() for k, v in diff.items()}
        cam_leaves = {k: v.detach().clone().requires_grad_() for k, v in vars(cam).items()
                      if v is not None}
        sc, cm = merge(leaves), raygen.CameraArrays(**cam_leaves)
        xb, yb = tile_block(xs, n_tile, t_rank), tile_block(ys, n_tile, t_rank)
        base = sample_base + s_rank * n_samples

        def render(s: int, tape: bool):
            with torch.set_grad_enabled(tape):
                return sample_batch(sc, params, xb, yb, base + s, 1, cam=cm)

        first = render(0, True)
        acc = first.detach()
        for s in range(1, n_samples):
            acc = acc + render(s, False)
        total_spp = n_samples * n_spp
        err = _all_reduce(acc.clone(), spp_g) / total_spp - target
        n_total = err.numel() * n_tile
        loss = _all_reduce((err * err).sum(), tile_g) / n_total * loss_scale
        # d(loss)/d(this rank's sums) = 2 err / (n_total total_spp) loss_scale
        cot = (2.0 * loss_scale / n_total / total_spp) * err
        first.backward(cot)
        del first
        for s in range(1, n_samples):
            render(s, True).backward(cot)

        def grads(d):
            return {k: v.grad if v.grad is not None else torch.zeros_like(v) for k, v in d.items()}

        g, gc = grads(leaves), grads(cam_leaves)
        if world is not None:
            # the data-parallel gradient all-reduce (the JAX psum at :191)
            parts = [*g.values(), *gc.values()]
            flat = _all_reduce(torch.cat([p.reshape(-1) for p in parts]), world)
            sums = iter(flat.split([p.numel() for p in parts]))
            g = {k: next(sums).view_as(v) for k, v in g.items()}
            gc = {k: next(sums).view_as(v) for k, v in gc.items()}
        return loss, (g, gc)

    return step
