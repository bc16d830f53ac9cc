"""The pinhole camera and its raygen (the reference renderer's
builder/pr/cam.rs and ray/generate.rs): d and up rotated by the view's
Euler angles Rz(y) Ry(p) Rx(r), right = normalize(normalize(d) x up),
then per (pixel, sample) two jitter draws and a normalize. The two
renderer formulations differ only in that normalize: the fused kernels'
rsqrt(max(|v|^2, 1e-30)) (`norm3`) and the integrator's sqrt-then-divide
(`normalize`)."""
from __future__ import annotations

import numpy as np
import torch

from . import rng

TWO_PI = float(np.float32(2.0 * np.pi))
_TINY = float(np.float32(1e-30))


def _euler(r: float, p: float, y: float) -> np.ndarray:
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]], dtype=np.float64)
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]], dtype=np.float64)
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]], dtype=np.float64)
    return (rz @ ry @ rx).astype(np.float32)


def camera_row(cam: dict, width: int, height: int, max_thres: float) -> list:
    """The 18 camera floats, each a float32 value: o, d, up, right, x_cf,
    y_cf, x_off, y_off, lens radius (0: a pinhole), max_thres."""
    if cam.get("lens_r") is not None:
        raise ValueError("the reference renders pinhole cameras only")
    f32 = lambda a: np.asarray(a, np.float32)
    rot = _euler(*[float(v) for v in f32(cam.get("view_eulers", [0, 0, 0]))])  # f32 angles
    d = rot @ f32(cam["d"])
    up = rot @ f32(cam["up"])
    right = np.cross(d / np.linalg.norm(d), up)
    right = right / np.linalg.norm(right)
    row = np.zeros(18, np.float32)
    row[0:3], row[3:6], row[6:9], row[9:12] = f32(cam["o"]), d, up, right
    row[12:16] = (float(cam["screen_width"]) / width, float(cam["screen_height"]) / height,
                  width / 2.0, height / 2.0)
    row[17] = max_thres
    return [float(v) for v in row]


def norm3(x, y, z):
    n2 = x * x + y * y + z * z
    inv = torch.rsqrt(torch.where(n2 > _TINY, n2, torch.full_like(n2, _TINY)))
    return x * inv, y * inv, z * inv


def normalize(x, y, z, eps: float = 0.0):
    n2 = x * x + y * y + z * z
    tiny = float(np.float32(max(eps * eps, 1e-30)))
    n = torch.sqrt(torch.where(n2 > tiny, n2, torch.full_like(n2, tiny)))
    if eps:
        n = torch.clamp(n, min=float(np.float32(eps)))
    inv = 1.0 / n
    return x * inv, y * inv, z * inv


def primary(cam: list, xs, ys, samples, dtype, fused: bool):
    """(state, origin, direction) of each lane's first ray: xs, ys, samples
    int tensors; fused picks the fused kernels' normalize, else the
    integrator's."""
    state = rng.init_state(xs, ys, samples)
    s_x = cam[12] * (xs.to(dtype) - cam[14])
    s_y = cam[13] * (ys.to(dtype) - cam[15])
    d = [cam[3 + k] + s_x * cam[9 + k] + s_y * cam[6 + k] for k in range(3)]
    one = torch.ones_like(d[0])
    o = tuple(one * c for c in cam[0:3])
    state, ju = rng.next_f32(state, dtype)
    state, jv = rng.next_f32(state, dtype)
    jx, jy = (ju - 0.5) * cam[12], (jv - 0.5) * cam[13]
    d = [d[k] + cam[9 + k] * jx + cam[6 + k] * jy for k in range(3)]
    return state, o, (norm3 if fused else normalize)(*d)
