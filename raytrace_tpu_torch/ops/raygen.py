"""Camera ray generation: pinhole + optional thin lens, jittered.

Mirrors `raytrace_tpu/ops/raygen.py:35-67` (the reference's
ray/generate.rs:13-66) in the formulation of the fused kernel's
`start_sample` (`raytrace_tpu/ops/pallas/trace_kernel.py:457-487`),
which the CUDA kernel follows too: the pre-jitter direction is
`d + s_x*right + s_y*up`, and the final normalize is `_norm3`'s
rsqrt(max(|d|^2, 1e-30)). Draw order: lens u, v (when the camera has a
lens), then jitter u, v, from the default (`weyl`) generator.

The camera is the (18,) row of `ops.trace_kernel.make_cam_vec`.
"""
from __future__ import annotations

import numpy as np
import torch

from . import rng

# float32 constants, so that host-float promotion cannot change a rounding
TWO_PI = float(np.float32(2.0 * np.pi))
_TINY = float(np.float32(1e-30))


def norm3(x, y, z):
    """(x, y, z) * rsqrt(max(|v|^2, 1e-30)) — trace_kernel._norm3."""
    n2 = x * x + y * y + z * z
    inv = torch.rsqrt(torch.where(n2 > _TINY, n2, torch.full_like(n2, _TINY)))
    return x * inv, y * inv, z * inv


def base_dir(x_idx, y_idx, cam):
    """Pre-jitter, pre-lens ray direction of each pixel (loop-invariant
    over samples). cam: the 18 camera floats as a Python list."""
    x_cf, y_cf, x_off, y_off = cam[12], cam[13], cam[14], cam[15]
    s_x = x_cf * (x_idx.to(torch.float32) - x_off)
    s_y = y_cf * (y_idx.to(torch.float32) - y_off)
    return tuple(cam[3 + k] + s_x * cam[9 + k] + s_y * cam[6 + k] for k in range(3))


def start(state, bd, cam, has_lens: bool):
    """Lens + jitter + normalize from the base direction `bd`. Returns
    (state, (ox, oy, oz), (dx, dy, dz))."""
    dx, dy, dz = bd
    ox_c, oy_c, oz_c = cam[0], cam[1], cam[2]
    ux, uy, uz = cam[6], cam[7], cam[8]
    rx, ry, rz = cam[9], cam[10], cam[11]
    x_cf, y_cf, lens_r = cam[12], cam[13], cam[16]
    if has_lens:
        state, u = rng.next_f32(state)
        state, v = rng.next_f32(state)
        r_ = torch.sqrt(u)
        th = TWO_PI * v
        lx = (r_ - 0.5) * 2.0 * lens_r * torch.cos(th)
        ly = (r_ - 0.5) * 2.0 * lens_r * torch.sin(th)
        offx, offy, offz = rx * lx + ux * ly, ry * lx + uy * ly, rz * lx + uz * ly
        o = (offx + ox_c, offy + oy_c, offz + oz_c)
        dx, dy, dz = dx - offx, dy - offy, dz - offz
    else:
        o = tuple(torch.full_like(dx, c) for c in (ox_c, oy_c, oz_c))
    state, ju = rng.next_f32(state)
    state, jv = rng.next_f32(state)
    jx, jy = (ju - 0.5) * x_cf, (jv - 0.5) * y_cf
    dx = dx + rx * jx + ux * jy
    dy = dy + ry * jx + uy * jy
    dz = dz + rz * jx + uz * jy
    return state, o, norm3(dx, dy, dz)


def generate(state, x_idx, y_idx, cam_vec, has_lens: bool):
    """state: (N,) u32-in-int64 streams; x_idx, y_idx: (N,) int pixel
    coords; cam_vec: make_cam_vec's (1, 18) row (array or tensor).
    Returns (state, ro, rd), each ray a tuple of three (N,) tensors."""
    cam = [float(v) for v in np.asarray(torch.as_tensor(cam_vec).cpu()).reshape(-1)]
    return start(state, base_dir(x_idx, y_idx, cam), cam, has_lens)
