"""Renderer driver: the walled-class main path on one device.

Port of `raytrace_tpu/render/renderer.py` for the fused-kernel path
(`sample_batch_fused` :125-193, `Renderer` :351-506 and `render`
:740-943), for gpu-semantics sphere + free-triangle scenes without a
cube map. One `trace_tiles` launch covers every pixel for up to
`samples_per_launch` consecutive sample ids (the kernel regenerates
samples in place), so any sample count runs through the kernel and the
JAX driver's plain-integrator tail is not needed. Sample ids continue at
`target.count`, so an incremental or checkpoint-resumed render is
bit-exact.

Anything outside that slice raises NotImplementedError; nothing is
routed to a substitute path. The device is explicit: a CUDA device runs
the CUDA kernel, the CPU runs its plain torch version.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from ..models.camera import build_camera
from ..models.config import Scheme
from ..models.scene import build_scene
from ..ops import trace_kernel as tk
from .target import RenderTarget


@dataclass(frozen=True)
class RenderParams:
    """The integrator settings the fused path reads (the JAX package's
    IntegratorParams, render/integrator.py:67-81)."""

    max_thres: float = 0.5
    assured_depth: int = 5
    max_bounces: int = 24
    mode: str = "gpu"
    debug_single_ray: bool = False


def params_from_scheme(scheme: Scheme) -> RenderParams:
    ri = scheme.render_info.rad_info
    return RenderParams(
        max_thres=ri.russ_roull_info.max_thres,
        assured_depth=ri.russ_roull_info.assured_depth,
        mode="gpu" if scheme.render_info.use_gpu else "cpu",
        debug_single_ray=ri.debug_single_ray,
    )


def sample_batch_fused(tables: tk.SceneTables, params: RenderParams, xs, ys,
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
            samples_per_lane=spl,
        )
        acc += torch.stack((lr, lg, lb), dim=1)
    return acc


class Renderer:
    """Static-scene renderer (the reference's renderer.rs:41-63)."""

    def __init__(self, scheme: Scheme, device="cuda", samples_per_launch: int = 256):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("device='cuda' was asked for but torch.cuda.is_available() is False")
        if self.device.type not in ("cuda", "cpu"):
            raise ValueError(f"unsupported device {self.device} (cuda or cpu)")
        self.scheme = scheme
        info = scheme.render_info
        self.width, self.height = info.width, info.height
        self.params = params_from_scheme(scheme)
        # build_scene raises NotImplementedError on meshes and the cube map
        self.scene = build_scene(scheme)
        if not tk.supports(self.scene, self.params):
            raise NotImplementedError(
                "outside the ported slice: needs gpu semantics, no debug_single_ray and "
                f"<= {tk.MAX_PRIMS} spheres and free triangles (ROADMAP queue 1, items 3 and 7)")
        if samples_per_launch < 1:
            raise ValueError("samples_per_launch must be >= 1")
        self.samples_per_launch = samples_per_launch
        self.camera = build_camera(scheme.cam, self.width, self.height)
        self.target = RenderTarget(self.width, self.height)
        # the scene is uploaded once per Renderer, not per render() call
        self.tables = tk.SceneTables(self.scene, self.camera, self.params.max_thres).to(self.device)
        flat = torch.arange(self.width * self.height, dtype=torch.int32)
        self._xs = (flat % self.width).to(self.device)
        self._ys = (flat // self.width).to(self.device)

    def render(self, samples: Optional[int] = None, batch: Optional[int] = None,
               update_hook: Optional[Callable[[RenderTarget], None]] = None) -> np.ndarray:
        """Run `samples` MORE samples (default: the scheme's samps_per_pix)
        in batches of `batch` (default: all at once, or the scheme's
        render_batch when a hook wants the intermediate images); the hook
        runs after every batch. Returns the (H, W, 3) mean image (row 0 =
        bottom)."""
        info = self.scheme.render_info
        total = samples if samples is not None else info.samps_per_pix
        b = batch or (info.render_batch if update_hook is not None else None) or total
        b = max(1, min(b, total)) if total > 0 else 1
        rendered = 0
        while rendered < total:
            n = min(b, total - rendered)
            out = sample_batch_fused(
                self.tables, self.params, self._xs, self._ys, self.target.count, n,
                samples_per_launch=self.samples_per_launch,
            )
            self.target.add(out.cpu().numpy(), n)
            rendered += n
            if update_hook is not None:
                update_hook(self.target)
        return self.target.mean_image()
