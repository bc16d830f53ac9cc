"""Renderer driver: one device, the JAX Renderer's choice of driver.

Port of `raytrace_tpu/render/renderer.py` (:394-427, :606-628, `render`
:740-943) with four drivers, chosen in the JAX package's order:

1. `sample_batch_fused` (:125-193): meshless gpu-semantics scenes of at
   most 64 spheres and 64 free triangles, through `trace_tiles`;
2. `sample_batch_mesh` (the JAX `fused_mesh.sample_batch_mesh_fused`,
   :274): gpu-semantics mesh scenes under the same limits, through the
   mesh path kernel;
3. `wavefront.wavefront_batch`: every other forward render (cpu
   semantics, direct-light sampling, debug_single_ray, more than 64
   spheres or free triangles), the XLA integrator over a lane pool, its
   mesh intersection through the `mesh_hit` kernel; on the card one
   iteration is a CUDA graph, captured once per batch shape and kept
   with its lane pool by the Renderer;
4. `sample_batch` (:64-122): the plain integrator over all pixels, one
   sample at a time; the wavefront's oracle, and the one driver of a
   differentiable render (`differentiable=True`, the JAX
   :108-119): the fused kernels and the wavefront have no backward.

A driver flag left None takes that driver when the scene supports it;
False skips it; True demands it and raises NotImplementedError when the
scene does not support it (where the JAX package would quietly route
elsewhere). Every driver takes a cube map: the fused kernels fetch the
sky at a lane's miss, the integrator drivers resolve it from the miss
records. The fused drivers cover up to `samples_per_launch` consecutive
sample ids per launch (the kernels regenerate samples in place, with a
sky too: the JAX driver's one sample a lane with replicas, :472, is a
TPU layout choice); the wavefront takes up to that many per
call (its per-(sample, pixel) slots bound the memory), the plain driver
one at a time. Both integrator drivers run their lanes in the JAX
package's 32x32-tile pixel order. Sample ids continue at `target.count`, so an
incremental or checkpoint-resumed render is bit-exact. The device is
explicit: a CUDA device runs the CUDA kernels, the CPU their plain torch
versions; nothing falls back. So is the generator: `generator="pcg"`
draws every path's numbers from the reference's generator (ops/rng.py) on
every driver, where the JAX package reads its RTPU_RNG at import.

Under torch.distributed (the JAX `devices=`, :354-391, :630-738,
:835-925) a Renderer shards every driver by sample id over its process
group: `group=`, by default the world when torch.distributed is
initialised with more than one process (the JAX default of all attached
devices). Each batch of n samples is split into contiguous slices, the
first n % size ranks taking one more (`parallel.distributed.sample_slice`;
the JAX package runs a remainder below the device count on one device
instead); each rank renders its slice through its own driver on its own
device, one all-reduce sums the (n_pix, 3) f32 batch sums on the device,
and every rank adds the same sums into its target. So every sample id of
a batch is rendered once, `render(samples=k)` adds exactly k, ids
continue at `target.count` (a resume is bitwise), and the targets are
bitwise equal on every rank. The fused drivers sum each lane's samples in order inside
a launch, so a render over two ranks equals the one-process render whose
launches cover the same slices; the plain driver and the wavefront add
per sample, so it equals the rank-order sum of the slices' renders.

The host remainder of the JAX `render` (:740-943) comes along: a tqdm bar
(when tqdm imports) with `utils.profiling.Throughput`'s Mpaths/s, and the
update hook run on a writer thread (`utils.hooks.AsyncHook`, latest-wins,
closed at the end). Left out (ROADMAP, "Not to port"): the TPU's
dispatch caps, `adapt_dispatch_spp` and the `RTPU_*` knobs.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from ..models.camera import build_camera
from ..models.config import Scheme
from ..models.scene import SceneArrays, SceneTensors, build_scene
from ..ops import mesh_kernel as mk
from ..ops import raygen, rng
from ..ops import trace_kernel as tk
from ..utils.hooks import AsyncHook
from ..utils import profiling
from ..utils.profiling import Throughput
from .integrator import IntegratorParams, trace_paths
from .target import RenderTarget
from .wavefront import wavefront_batch

DRIVERS = ("fused", "mesh_fused", "wavefront", "plain")
POOL_CAP = 1 << 17  # the wavefront's lane pool (renderer.py:622)


def params_from_scheme(scheme: Scheme, mode: Optional[str] = None) -> IntegratorParams:
    """The scheme's integrator settings; mode defaults to the scheme's
    `use_gpu` (gpu or cpu semantics)."""
    info = scheme.render_info
    ri = info.rad_info
    return IntegratorParams(
        max_thres=ri.russ_roull_info.max_thres,
        assured_depth=ri.russ_roull_info.assured_depth,
        mode=mode or ("gpu" if info.use_gpu else "cpu"),
        debug_single_ray=ri.debug_single_ray,
        dir_light_samp=ri.dir_light_samp,
    )


def tile_order(width: int, height: int) -> np.ndarray:
    """The JAX Renderer's lane order (renderer.py:444-453): flat pixel
    ids in 32x32 tiles, so that the rays of consecutive lanes (a warp)
    stay close together for the mesh walk."""
    ys, xs = np.divmod(np.arange(width * height, dtype=np.int64), width)
    tile_id = (ys // 32) * (-(-width // 32)) + xs // 32
    return np.lexsort(((ys % 32) * 32 + xs % 32, tile_id))


def sample_batch(scene: SceneTensors, params: IntegratorParams, xs, ys, sample_base: int,
                 n_samples: int, cam: Optional[raygen.CameraArrays] = None) -> torch.Tensor:
    """The plain integrator (renderer.py:64-122): per sample id s in
    sample_base .. sample_base+n_samples-1, seed every lane's stream from
    (x, y, s), raygen and `trace_paths`. xs, ys: (N,) int32 on the scene's
    device; cam: the camera as tensors (raygen.CameraArrays, which takes
    the camera's gradients), or None for the scene's own. Returns the
    (N, 3) f32 radiance sums, in lane order; with
    `params.differentiable` and leaves that require grad (a
    `SceneTensors.replace` view, cam), a tensor to backpropagate from."""
    cam = scene.cam if cam is None else cam
    acc = torch.zeros((xs.numel(), 3), dtype=torch.float32, device=xs.device)
    for s in range(n_samples):
        state = rng.init_state(xs, ys, torch.full_like(xs, sample_base + s))
        state, ro, rd = raygen.generate_paths(state, xs, ys, cam, scene.has_lens,
                                              params.generator)
        L, _ = trace_paths(scene, params, ro, rd, state)
        acc = acc + torch.stack(L, dim=1)
    return acc


def sample_batch_fused(tables: tk.SceneTables, params: IntegratorParams, xs, ys,
                       sample_base: int, n_samples: int, *,
                       samples_per_launch: int) -> torch.Tensor:
    """Radiance SUM over sample ids sample_base .. sample_base+n_samples-1
    of the pixels (xs, ys) (int32 tensors on the tables' device), in
    launches of up to samples_per_launch samples per lane. Returns an
    (n_pix, 3) f32 tensor on that device."""
    acc = torch.zeros((xs.numel(), 3), dtype=torch.float32, device=xs.device)
    for s0 in range(0, n_samples, samples_per_launch):
        spl = min(samples_per_launch, n_samples - s0)
        samp = torch.full_like(xs, sample_base + s0)
        lr, lg, lb, *_ = tk.trace_tiles(
            xs, ys, samp, tables.sph, tables.ft, tables.cam_vec,
            n_sph=tables.n_sph, n_ft=tables.n_ft, has_lens=tables.has_lens,
            assured=params.assured_depth, max_bounces=params.max_bounces,
            samples_per_lane=spl, sky=tables.sky, generator=params.generator,
        )
        acc += torch.stack((lr, lg, lb), dim=1)
    return acc


def sample_batch_mesh(tables: mk.MeshTables, params: IntegratorParams, xs, ys,
                      sample_base: int, n_samples: int, *,
                      samples_per_launch: int) -> torch.Tensor:
    """sample_batch_fused for mesh scenes: radiance SUM over sample ids
    sample_base .. sample_base+n_samples-1 of the pixels (xs, ys), in
    `mesh_trace` launches of up to samples_per_launch samples per lane
    on the scene's route. Returns an (n_pix, 3) f32 tensor."""
    acc = torch.zeros((xs.numel(), 3), dtype=torch.float32, device=xs.device)
    for s0 in range(0, n_samples, samples_per_launch):
        spl = min(samples_per_launch, n_samples - s0)
        samp = torch.full_like(xs, sample_base + s0)
        acc += torch.stack(mk.mesh_trace(
            xs, ys, samp, tables, assured=params.assured_depth,
            max_bounces=params.max_bounces, samples_per_lane=spl,
            generator=params.generator), dim=1)
    return acc


def _pick_driver(flags: dict, supported: dict) -> str:
    asked = [d for d in DRIVERS if flags.get(d) is True]
    if len(asked) > 1:
        raise ValueError(f"more than one driver asked for: {asked}")
    if asked:
        if not supported[asked[0]]:
            raise NotImplementedError(f"the scene is outside the {asked[0]} driver")
        return asked[0]
    return next(d for d in DRIVERS if flags.get(d) is None and supported[d])


class Renderer:
    """Static-scene renderer (the reference's renderer.rs:41-63). `mode`
    overrides the scheme's semantics ("gpu" or "cpu"); use_fused,
    use_mesh_fused and use_wavefront pick the driver (module docstring);
    differentiable sets `params.differentiable`, which only the plain
    driver takes. `scene`: a prebuilt SceneArrays of the scheme (the
    animation pipeline builds the next frame's while this one renders),
    else build_scene(scheme). `generator`: "weyl" or "pcg", every draw's
    family (`params.generator`). `driver` names the one taken; after a
    wavefront render, `stats` holds its iterations and lane-bounces
    (summed over the ranks). `group`: the torch.distributed process group
    to shard samples over (module docstring; default the world when it
    has more than one process); a differentiable Renderer takes none of
    more than one process (the distributed differentiable path is
    parallel.distributed.make_train_step)."""

    def __init__(self, scheme: Scheme, device="cuda", samples_per_launch: int = 256,
                 mode: Optional[str] = None, use_fused: Optional[bool] = None,
                 use_mesh_fused: Optional[bool] = None, use_wavefront: Optional[bool] = None,
                 differentiable: bool = False, scene: Optional[SceneArrays] = None,
                 generator: str = "weyl", group=None):
        with profiling.span("renderer.init"):
            self.device = torch.device(device)
            if self.device.type == "cuda" and not torch.cuda.is_available():
                raise RuntimeError(
                    "device='cuda' was asked for but torch.cuda.is_available() is False")
            if self.device.type not in ("cuda", "cpu"):
                raise ValueError(f"unsupported device {self.device} (cuda or cpu)")
            if samples_per_launch < 1:
                raise ValueError("samples_per_launch must be >= 1")
            dist = torch.distributed
            if group is None and dist.is_available() and dist.is_initialized() and \
                    dist.get_world_size() > 1:
                group = dist.group.WORLD
            self.group = group
            if group is not None and differentiable and dist.get_world_size(group) > 1:
                raise NotImplementedError(
                    "a differentiable Renderer runs in one process; the distributed "
                    "differentiable path is parallel.distributed.make_train_step")
            self.scheme = scheme
            info = scheme.render_info
            self.width, self.height = info.width, info.height
            self.params = dataclasses.replace(params_from_scheme(scheme, mode),
                                              differentiable=differentiable, generator=generator)
            self.mode = self.params.mode
            self.scene = scene if scene is not None else build_scene(scheme)
            self.samples_per_launch = samples_per_launch
            self.camera = build_camera(scheme.cam, self.width, self.height)
            self.target = RenderTarget(self.width, self.height)
            self.stats = {"iterations": 0, "lane_bounces": 0}
            self.driver = _pick_driver(
                {"fused": use_fused, "mesh_fused": use_mesh_fused, "wavefront": use_wavefront},
                {"fused": tk.supports(self.scene, self.params),
                 "mesh_fused": mk.supports(self.scene, self.params),
                 "wavefront": not differentiable, "plain": True})
            max_thres = self.params.max_thres
            n_pix = self.width * self.height
            # the scene is uploaded once per Renderer, not per render() call
            with profiling.span("renderer.tables"):
                if self.driver in ("fused", "mesh_fused"):
                    tables = tk.SceneTables if self.driver == "fused" else mk.MeshTables
                    self.tables = tables(self.scene, self.camera, max_thres).to(self.device)
                    self._batch = (sample_batch_fused if self.driver == "fused"
                                   else sample_batch_mesh)
                    flat = np.arange(n_pix)
                else:
                    self.tables = SceneTensors(self.scene, self.camera, max_thres).to(self.device)
                    self._batch = self._wavefront if self.driver == "wavefront" else self._plain
                    flat = tile_order(self.width, self.height)
                    self._unscramble = torch.from_numpy(flat).to(self.device)
                    self.pool = min(POOL_CAP, -(-n_pix // 1024) * 1024)
                    self._lanes = {}  # the wavefront's lane pools (and CUDA graphs) by batch shape
                self._xs = torch.from_numpy((flat % self.width).astype(np.int32)).to(self.device)
                self._ys = torch.from_numpy((flat // self.width).astype(np.int32)).to(self.device)
            self._step = self._batch
            if group is not None:
                from ..parallel.distributed import make_spp_sharded_step

                self._step, _ = make_spp_sharded_step(group, self._batch)

    def _plain(self, tables, params, xs, ys, sample_base, n_samples, *, samples_per_launch):
        out = sample_batch(tables, params, xs, ys, sample_base, n_samples)
        return torch.empty_like(out).index_copy_(0, self._unscramble, out)  # lane -> pixel order

    def _wavefront(self, tables, params, xs, ys, sample_base, n_samples, *, samples_per_launch):
        acc = None
        for s0 in range(0, n_samples, samples_per_launch):
            img, st = wavefront_batch(tables, params, xs, ys, sample_base + s0,
                                      min(samples_per_launch, n_samples - s0), self.width,
                                      self.pool, return_stats=True, cache=self._lanes)
            for k in st:
                self.stats[k] += st[k]
            acc = img if acc is None else acc + img
        return acc if acc is not None else torch.zeros((xs.numel(), 3), device=xs.device)

    def render(self, samples: Optional[int] = None, batch: Optional[int] = None,
               update_hook: Optional[Callable[[RenderTarget], None]] = None,
               progress: bool = True, async_hook: bool = True) -> np.ndarray:
        """Run `samples` MORE samples (default: the scheme's samps_per_pix)
        in batches of `batch` (default: all at once, or the scheme's
        render_batch when a hook wants the intermediate images); the hook
        runs after every batch, with `async_hook` (the default) on a
        writer thread against a snapshot, latest-wins, the last snapshot
        delivered and the hook's exception re-raised before this returns.
        `progress`: a tqdm bar over the samples (when tqdm imports), its
        postfix the Mpaths/s so far. Returns the (H, W, 3) mean image (row
        0 = bottom)."""
        info = self.scheme.render_info
        total = samples if samples is not None else info.samps_per_pix
        b = batch or (info.render_batch if update_hook is not None else None) or total
        b = max(1, min(b, total)) if total > 0 else 1
        with profiling.call("render", samples=total, batch=b, driver=self.driver):
            profiling.count("render.calls")
            self._render(total, b, update_hook, progress, async_hook)
            with profiling.span("render.mean"):
                return self.target.mean_image()

    def _render(self, total, b, update_hook, progress, async_hook):
        """render's batches: each one `_step` (the chosen driver's batch), the
        copy of its sums to the host, the add into the target and the hook."""
        span = profiling.span
        self.stats = {"iterations": 0, "lane_bounces": 0}
        bar = None
        if progress:
            try:
                from tqdm import tqdm

                bar = tqdm(total=total, desc="samples", unit="spp")
            except Exception:
                bar = None
        meter = Throughput()
        hook = AsyncHook(update_hook) if update_hook is not None and async_hook else update_hook
        n_pix = self.width * self.height
        rendered = 0
        try:
            while rendered < total:
                n = min(b, total - rendered)
                with span("render.step"):
                    out = self._step(
                        self.tables, self.params, self._xs, self._ys,
                        sample_base=self.target.count, n_samples=n,
                        samples_per_launch=self.samples_per_launch,
                    )
                with span("render.copy"):  # waits for the step's kernels
                    sums = out.cpu().numpy()
                with span("render.add"):
                    self.target.add(sums, n)
                profiling.count("render.batches")
                profiling.count("render.dtoh_bytes", sums.nbytes)
                rendered += n
                meter.add(n * n_pix)
                if bar is not None:
                    bar.update(n)
                    bar.set_postfix_str(f"{meter.mpaths_per_s:.1f} Mpaths/s")
                if hook is not None:
                    with span("render.hook"):
                        hook(self.target)
        finally:
            if bar is not None:
                bar.close()
            if isinstance(hook, AsyncHook):
                hook.close()  # flush the final snapshot; re-raise the hook's error
        if self.group is not None and self.driver == "wavefront":
            st = torch.tensor([self.stats[k] for k in self.stats], device=self.device)
            torch.distributed.all_reduce(st, group=self.group)
            self.stats = dict(zip(self.stats, st.tolist()))
