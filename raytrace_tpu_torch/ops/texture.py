"""Nearest texel fetch from the flat texel pool, in the pool's dtype.

Mirrors `raytrace_tpu/render/integrator._fetch_rgb` (:469-507) and the
descriptor fetch of `mesh_attrs_dense` (:568-585), the reference's
UVRgb32FImage::get_pixel (material/uv_image.rs:10-23): nearest texel,
px = trunc(clip(u * w, 0, w - 1)), no v flip, clamped addressing, black
where the descriptor's width is 0. Offsets stay int32 (pools pass 2^24
texels, past f32's integer range).

Pool dtypes (models/scene._TexPool), held in torch as bit patterns
(torch has no uint32 / uint16 arithmetic on the CPU):
- POOL_U32: one packed word per texel, R | G<<8 | B<<16, stored as int32;
- POOL_U16: RGB u16 components (8-bit sources scaled by 257), stored as int16;
- POOL_F32: RGB f32 components.
Integer texels divide by 255 / 65535 after the gather (a true f32
division, as the JAX package does), bit-identical to an f32 pool.
"""
from __future__ import annotations

import numpy as np
import torch

POOL_F32, POOL_U16, POOL_U32 = 0, 1, 2


def pool_tensor(pool: np.ndarray):
    """numpy texel pool -> (torch tensor of its bit pattern, pool kind)."""
    if pool.dtype == np.uint32:
        return torch.from_numpy(np.ascontiguousarray(pool).view(np.int32)), POOL_U32
    if pool.dtype == np.uint16:
        return torch.from_numpy(np.ascontiguousarray(pool).view(np.int16)), POOL_U16
    if pool.dtype == np.float32:
        return torch.from_numpy(np.ascontiguousarray(pool)), POOL_F32
    raise TypeError(f"texel pool dtype {pool.dtype} (expected uint32, uint16 or float32)")


def _div(x: torch.Tensor, full_scale: float) -> torch.Tensor:
    # a tensor divisor: a scalar one may be turned into a reciprocal multiply
    return x / torch.full_like(x, full_scale)


def fetch_rgb(pool: torch.Tensor, kind: int, base3: torch.Tensor):
    """base3: int32 flat offsets of the R component. Returns (r, g, b)
    f32 tensors shaped like base3."""
    T = pool.numel()
    if kind == POOL_U32:
        w = pool[torch.clamp(base3 // 3, 0, T - 1).long()].to(torch.int64) & 0xFFFFFFFF
        return tuple(_div(((w >> s) & 0xFF).to(torch.float32), 255.0) for s in (0, 8, 16))
    start = torch.clamp(base3, 0, T - 3).long()
    vals = [pool[start + k] for k in range(3)]
    if kind == POOL_U16:
        return tuple(_div((v.to(torch.int32) & 0xFFFF).to(torch.float32), 65535.0) for v in vals)
    return tuple(vals)


def sample_nearest(pool: torch.Tensor, kind: int, off, wid, hei, u, v):
    """off / wid / hei: int32 per-lane descriptors; u, v: f32. Returns
    (ok, (r, g, b)): ok = wid > 0, and black where not ok."""
    wf, hf = wid.to(torch.float32), hei.to(torch.float32)
    zero = torch.zeros_like(u)
    px = torch.minimum(torch.maximum(u * wf, zero), torch.clamp(wf - 1.0, min=0.0)).to(torch.int32)
    py = torch.minimum(torch.maximum(v * hf, zero), torch.clamp(hf - 1.0, min=0.0)).to(torch.int32)
    ok = wid > 0
    base3 = torch.where(ok, off + 3 * (px + py * wid), torch.zeros_like(off))
    rgb = fetch_rgb(pool, kind, base3)
    return ok, tuple(torch.where(ok, c, zero) for c in rgb)
