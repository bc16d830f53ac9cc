"""Render target: f32 radiance SUM + sample count.

Mirrors `raytrace_tpu/render/target.py`: the exact f32 sum and the count
(not a running mean) make checkpoint / resume exact. Host numpy; the
renderer adds one (H*W, 3) batch sum per render step.
"""
from __future__ import annotations

import numpy as np

from ..utils import profiling


class RenderTarget:
    def __init__(self, width: int, height: int):
        with profiling.span("target.new"):
            self.width = width
            self.height = height
            self.acc = np.zeros((height * width, 3), np.float32)
            self.count = 0

    def add(self, radiance_sum: np.ndarray, n_samples: int):
        self.acc += radiance_sum
        self.count += n_samples

    def mean_image(self) -> np.ndarray:
        """(H, W, 3) f32 mean radiance; row 0 = bottom scanline."""
        return (self.acc / max(self.count, 1)).reshape(self.height, self.width, 3)

    def to_u8_rgba(self) -> np.ndarray:
        """Clamp [0, 1] -> u8 RGBA as the reference's rgb_f_to_u8
        (draw_scene.rs:104-109): (clamp(c, 0, 1) * 255 + 0.5) truncated."""
        u8 = (np.clip(self.mean_image(), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        return np.concatenate([u8, np.full(u8.shape[:2] + (1,), 255, np.uint8)], axis=-1)
