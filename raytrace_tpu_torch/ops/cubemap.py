"""The distant cube map: the sky's texel for a ray direction.

Port of `raytrace_tpu/ops/cubemap.sample` (:20-56), which
`raytrace_tpu/render/integrator.sample_cubemap` (:510-543) repeats (the
reference's elements/distant_cube_map.rs:28-76 == trace.wgsl:1199-1249):
the direction normalized as `raygen.normalize` does (a square root, then
a multiply by 1 / n), the face of the dominant |axis| with the WGSL's
`>=` ties (x beats y beats z), uv = 0.5 * (minor * scale / major) + 0.5,
and the nearest texel trunc(clip(uv * size, 0, size - 1)) fetched from
the sky pool in its dtype (`texture.nearest_texel`, `fetch_rgb`), black
where the face's width is 0. Faces are in the WGSL order
[neg_z, pos_z, neg_x, pos_x, neg_y, pos_y] (models/config.FACE_ORDER).

One function serves the integrator, the wavefront and the plain versions
of both fused kernels; `csrc/cubemap.cuh` is the kernels' copy, each
operation rounded on its own as torch rounds it, so that the face and
the texel are the same bit for bit.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch import nn

from .raygen import normalize
from .texture import fetch_rgb, nearest_texel, pool_tensor

FACE_COLS = 5  # the kernels' face rows: offset, width, height, u_scale bits, v_scale bits
# the fused kernels' last C arguments: face table, pool, pool kind, pool length
ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong]


def sample(pool, kind: int, offsets, dims, uv_scales, dx, dy, dz):
    """pool / kind: the sky pool as `texture.pool_tensor` gives it;
    offsets (6,) int32, dims (6, 2) int32 (w, h), uv_scales (6, 2) f32;
    dx, dy, dz: (N,) f32 directions, not necessarily unit. Returns the
    (r, g, b) f32 tensors of the sky in those directions."""
    ok, base3 = texel(offsets, dims, uv_scales, dx, dy, dz)
    zero = torch.zeros_like(dx)
    return tuple(torch.where(ok, c, zero) for c in fetch_rgb(pool, kind, base3))


def texel(offsets, dims, uv_scales, dx, dy, dz):
    """`sample`'s texel: (ok, base3) as `texture.nearest_texel` gives
    them, ok False where the face's width is 0."""
    x, y, z = normalize(dx, dy, dz)
    ax, ay, az = x.abs(), y.abs(), z.abs()
    is_x = (ax >= ay) & (ax >= az)
    is_y = ~is_x & (ay >= ax) & (ay >= az)
    where = torch.where
    face = where(is_x, where(x < 0.0, 2, 3), where(is_y, where(y < 0.0, 4, 5), where(z < 0.0, 0, 1)))
    u = where(is_x, z, x)
    v = where(is_x, y, where(is_y, z, y))
    fact = where(is_x, x, where(is_y, y, z))
    su = 0.5 * (u * uv_scales[face, 0] / fact) + 0.5
    sv = 0.5 * (v * uv_scales[face, 1] / fact) + 0.5
    return nearest_texel(offsets[face], dims[face, 0], dims[face, 1], su, sv)


def face_table(offsets, dims, uv_scales) -> np.ndarray:
    """The (6, FACE_COLS) int32 face table the CUDA kernels stage: offset,
    width, height and the two uv scales' f32 bit patterns."""
    t = np.zeros((6, FACE_COLS), np.int32)
    t[:, 0] = offsets
    t[:, 1:3] = dims
    t[:, 3:5] = np.ascontiguousarray(uv_scales, np.float32).view(np.int32)
    return t


class SkyTables(nn.Module):
    """A scene's cube map as buffers, moved with `.to(device)`: the sky
    pool's bit pattern (`kind` its POOL_* dtype), the three face tables
    of `sample` and `face`, the kernels' `face_table`."""

    def __init__(self, scene):
        super().__init__()
        pool, self.kind = pool_tensor(scene.sky_pool)
        self.register_buffer("pool", pool)
        for name, a, dt in (("offsets", scene.cm_offsets, np.int32), ("dims", scene.cm_dims, np.int32),
                            ("uv_scales", scene.cm_uv_scales, np.float32)):
            self.register_buffer(name, torch.from_numpy(np.ascontiguousarray(a, dt)))
        self.register_buffer("face", torch.from_numpy(
            face_table(scene.cm_offsets, scene.cm_dims, scene.cm_uv_scales)))

    def sample(self, dx, dy, dz):
        """`sample` on this scene's cube map."""
        return sample(self.pool, self.kind, self.offsets, self.dims, self.uv_scales, dx, dy, dz)


def launch_args(sky, dev) -> list:
    """The fused kernels' last C arguments (ARGTYPES) for `sky`, a
    SkyTables or None (null pointers: the kernel without the cube map);
    raises unless the face table and the pool are contiguous on `dev`."""
    if sky is None:
        return [None, None, 0, 0]
    for name in ("face", "pool"):
        t = getattr(sky, name)
        if t.device != dev or not t.is_contiguous():
            raise ValueError(f"sky.{name} must be contiguous on {dev}")
    return [sky.face.data_ptr(), sky.pool.data_ptr(), sky.kind, sky.pool.numel()]
