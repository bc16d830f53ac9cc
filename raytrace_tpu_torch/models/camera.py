"""Scene camera: scheme camera -> render-ready host camera.

Mirrors `raytrace_tpu/models/camera.py` (the reference's
builder/pr/cam.rs:66-80 and ray/generate.rs:13-23): rotate d and up by
the view_eulers rotation Rz(y) @ Ry(p) @ Rx(r), derive the `right`
basis vector, the screen-to-pixel factors and the half-canvas offsets.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np


def euler_matrix(r: float, p: float, y: float) -> np.ndarray:
    """Rz(y) @ Ry(p) @ Rx(r), nalgebra from_euler_angles convention."""
    cr, sr = np.cos(r), np.sin(r)
    cp, sp = np.cos(p), np.sin(p)
    cy, sy = np.cos(y), np.sin(y)
    rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]], dtype=np.float64)
    ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]], dtype=np.float64)
    rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]], dtype=np.float64)
    return (rz @ ry @ rx).astype(np.float32)


@dataclass
class Camera:
    o: np.ndarray  # (3,)
    d: np.ndarray  # (3,) o -> screen center, carries focal distance
    up: np.ndarray  # (3,) unit
    right: np.ndarray  # (3,) normalize(normalize(d) x up)
    x_cf: float
    y_cf: float
    x_off: float
    y_off: float
    lens_r: Optional[float]


def build_camera(cfg, width: int, height: int) -> Camera:
    r, p, y = [float(v) for v in cfg.view_eulers]
    rot = euler_matrix(r, p, y)
    d = rot @ cfg.d
    up = rot @ cfg.up
    right = np.cross(d / np.linalg.norm(d), up)
    right = right / np.linalg.norm(right)
    return Camera(
        o=cfg.o.astype(np.float32),
        d=d.astype(np.float32),
        up=up.astype(np.float32),
        right=right.astype(np.float32),
        x_cf=cfg.screen_width / width,
        y_cf=cfg.screen_height / height,
        x_off=width / 2.0,
        y_off=height / 2.0,
        lens_r=cfg.lens_r,
    )
