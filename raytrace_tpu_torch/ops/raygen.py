"""Camera ray generation: pinhole + optional thin lens, jittered.

Mirrors `raytrace_tpu/ops/raygen.py:35-67` (the reference's
ray/generate.rs:13-66) in two formulations that differ only in the
final normalize of the direction `d + s_x*right + s_y*up + jitter`:

- `start` / `generate`: the fused kernels' `start_sample`
  (`raytrace_tpu/ops/pallas/trace_kernel.py:457-487`), which the CUDA
  kernels follow too: `_norm3`'s rsqrt(max(|d|^2, 1e-30));
- `generate_paths`: the XLA integrator's
  `raygen.generate`, whose last step is `vec.normalize`: a sqrt, then a
  multiply by 1/n (`normalize` below). The integrator and the wavefront
  use it.

Draw order: lens u, v (when the camera has a lens), then jitter u, v,
from the generator named by `generator` (ops/rng.py: "weyl", the
default, or the reference's "pcg"). The camera is the (18,) row of
`ops.trace_kernel.make_cam_vec` as Python floats, or, where gradients
must reach it, a `CameraArrays` of tensors (the JAX renderer's
`CameraArrays`, renderer.py:34-61), whose `row()` stands in for the
floats and gives the same rays bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import rng

# float32 constants, so that host-float promotion cannot change a rounding
TWO_PI = float(np.float32(2.0 * np.pi))
_TINY = float(np.float32(1e-30))


@dataclass
class CameraArrays:
    """The camera as f32 tensors, the differentiable leaf set of camera
    gradients: o, d, up, right (3,); x_cf, y_cf, x_off, y_off 0-dim;
    lens_r 0-dim, or None for a pinhole."""

    o: torch.Tensor
    d: torch.Tensor
    up: torch.Tensor
    right: torch.Tensor
    x_cf: torch.Tensor
    y_cf: torch.Tensor
    x_off: torch.Tensor
    y_off: torch.Tensor
    lens_r: Optional[torch.Tensor] = None

    def row(self) -> list:
        """The 18 entries of make_cam_vec's row as 0-dim tensors (lens_r
        0 for a pinhole; the last, max_thres, is not raygen's and is 0)."""
        zero = torch.zeros_like(self.x_cf)
        return [*self.o.unbind(), *self.d.unbind(), *self.up.unbind(), *self.right.unbind(),
                self.x_cf, self.y_cf, self.x_off, self.y_off,
                zero if self.lens_r is None else self.lens_r, zero]


def camera_to_arrays(cam, device) -> CameraArrays:
    """models.camera.Camera -> CameraArrays on `device` (required: "cuda"
    or "cpu", as every entry point asks), each value the float32 of
    make_cam_vec's row."""
    f32 = lambda v: torch.tensor(np.asarray(v, np.float32), device=device)
    return CameraArrays(o=f32(cam.o), d=f32(cam.d), up=f32(cam.up), right=f32(cam.right),
                        x_cf=f32(cam.x_cf), y_cf=f32(cam.y_cf), x_off=f32(cam.x_off),
                        y_off=f32(cam.y_off), lens_r=None if cam.lens_r is None else f32(cam.lens_r))


def norm3(x, y, z):
    """(x, y, z) * rsqrt(max(|v|^2, 1e-30)) — trace_kernel._norm3."""
    n2 = x * x + y * y + z * z
    inv = torch.rsqrt(torch.where(n2 > _TINY, n2, torch.full_like(n2, _TINY)))
    return x * inv, y * inv, z * inv


def normalize(x, y, z, eps: float = 0.0):
    """sqrt-then-divide normalize (the JAX package's ops/vec.normalize,
    :89-97): n = sqrt(max(|v|^2, max(eps^2, 1e-30))), clamped to eps,
    then v * (1 / n)."""
    n2 = x * x + y * y + z * z
    tiny = float(np.float32(max(eps * eps, 1e-30)))
    n = torch.sqrt(torch.where(n2 > tiny, n2, torch.full_like(n2, tiny)))
    if eps:
        n = torch.clamp(n, min=float(np.float32(eps)))
    inv = 1.0 / n
    return x * inv, y * inv, z * inv


def base_dir(x_idx, y_idx, cam):
    """Pre-jitter, pre-lens ray direction of each pixel (loop-invariant
    over samples). cam: the 18 camera floats as a Python list, or
    CameraArrays.row()'s tensors."""
    x_cf, y_cf, x_off, y_off = cam[12], cam[13], cam[14], cam[15]
    s_x = x_cf * (x_idx.to(torch.float32) - x_off)
    s_y = y_cf * (y_idx.to(torch.float32) - y_off)
    return tuple(cam[3 + k] + s_x * cam[9 + k] + s_y * cam[6 + k] for k in range(3))


def _lens_jitter(state, bd, cam, has_lens: bool, generator: str):
    """Lens + jitter from the base direction `bd`, before the normalize,
    drawn from `generator`. Returns (state, (ox, oy, oz), (dx, dy, dz))."""
    dx, dy, dz = bd
    ox_c, oy_c, oz_c = cam[0], cam[1], cam[2]
    ux, uy, uz = cam[6], cam[7], cam[8]
    rx, ry, rz = cam[9], cam[10], cam[11]
    x_cf, y_cf, lens_r = cam[12], cam[13], cam[16]
    if has_lens:
        state, u = rng.next_f32(state, generator)
        state, v = rng.next_f32(state, generator)
        r_ = torch.sqrt(u)
        th = TWO_PI * v
        lx = (r_ - 0.5) * 2.0 * lens_r * torch.cos(th)
        ly = (r_ - 0.5) * 2.0 * lens_r * torch.sin(th)
        offx, offy, offz = rx * lx + ux * ly, ry * lx + uy * ly, rz * lx + uz * ly
        o = (offx + ox_c, offy + oy_c, offz + oz_c)
        dx, dy, dz = dx - offx, dy - offy, dz - offz
    else:
        one = torch.ones_like(dx)  # 1 * c: the origin's gradient reaches a tensor c
        o = tuple(one * c for c in (ox_c, oy_c, oz_c))
    state, ju = rng.next_f32(state, generator)
    state, jv = rng.next_f32(state, generator)
    jx, jy = (ju - 0.5) * x_cf, (jv - 0.5) * y_cf
    dx = dx + rx * jx + ux * jy
    dy = dy + ry * jx + uy * jy
    dz = dz + rz * jx + uz * jy
    return state, o, (dx, dy, dz)


def start(state, bd, cam, has_lens: bool, generator: str = "weyl"):
    """The fused kernels' raygen: lens + jitter + rsqrt normalize from
    the base direction `bd`. Returns (state, (ox, oy, oz), (dx, dy, dz))."""
    state, o, d = _lens_jitter(state, bd, cam, has_lens, generator)
    return state, o, norm3(*d)


def generate(state, x_idx, y_idx, cam_vec, has_lens: bool, generator: str = "weyl"):
    """state: (N,) u32-in-int64 streams; x_idx, y_idx: (N,) int pixel
    coords; cam_vec: make_cam_vec's (1, 18) row (array or tensor).
    Returns (state, ro, rd), each ray a tuple of three (N,) tensors."""
    cam = [float(v) for v in np.asarray(torch.as_tensor(cam_vec).cpu()).reshape(-1)]
    return start(state, base_dir(x_idx, y_idx, cam), cam, has_lens, generator)


def generate_paths(state, x_idx, y_idx, cam, has_lens: bool, generator: str = "weyl"):
    """The integrator's raygen (`raytrace_tpu/ops/raygen.generate`): as
    `generate`, with the sqrt-then-divide `normalize`; cam is the 18
    camera floats as a Python list, or a CameraArrays (the same rays,
    with the camera's gradients)."""
    if isinstance(cam, CameraArrays):
        cam = cam.row()
    state, o, d = _lens_jitter(state, base_dir(x_idx, y_idx, cam), cam, has_lens, generator)
    return state, o, normalize(*d)
