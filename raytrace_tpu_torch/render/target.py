"""Render target: f32 radiance SUM + sample count.

Mirrors `raytrace_tpu/render/target.py`: the exact f32 sum and the count
(not a running mean) make checkpoint / resume exact. The renderer adds
one (H*W, 3) batch sum per render step as the tensor its driver returns:
the sum stays on that device between batches (one f32 add a batch, as
numpy's), the mean is taken there, and `mean_image()` copies it to the
host once, into page-locked memory on a card.

Of the device sum and the host array `acc`, one is the sum at any time.
Reading `acc` brings the device sum to the host (counted as
`target.syncs`) and makes the host array the sum; the next add uploads
it once, so a write into `acc`, in place or by assignment
(`checkpoint.load`, `AsyncHook`'s snapshot), is seen by that add. Each
copy to the host is a `render.copy` span, its bytes counted in
`render.dtoh_bytes`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import profiling


class RenderTarget:
    def __init__(self, width: int, height: int):
        with profiling.span("target.new"):
            self.width = width
            self.height = height
            self.count = 0
            self._host = None  # the sum when _dev is None (None: zeros, made when read)
            self._dev = None  # the sum on the renderer's device, once a tensor was added

    @property
    def acc(self) -> np.ndarray:
        """The (H*W, 3) f32 sum as host numpy, writable in place."""
        if self._dev is not None:
            profiling.count("target.syncs")
            profiling.count("render.dtoh_bytes", self._dev.nbytes)
            with profiling.span("render.copy"):
                self._host, self._dev = self._dev.cpu().numpy(), None
        elif self._host is None:
            self._host = np.zeros((self.height * self.width, 3), np.float32)
        return self._host

    @acc.setter
    def acc(self, value: np.ndarray) -> None:
        self._host, self._dev = value, None

    def add(self, radiance_sum: torch.Tensor, n_samples: int):
        """Add an (H*W, 3) f32 batch sum of n_samples samples, on its device."""
        if self._dev is None:
            self._dev = (torch.zeros_like(radiance_sum) if self._host is None else
                         torch.from_numpy(self._host).to(radiance_sum.device, copy=True))
            self._host = None
        self._dev += radiance_sum
        self.count += n_samples

    def mean_image(self) -> np.ndarray:
        """(H, W, 3) f32 mean radiance, numpy's `acc / max(count, 1)` bit for
        bit; row 0 = bottom scanline. A device sum is divided on its device
        by the count as an f32 tensor there (a CUDA division by a Python
        number multiplies by its reciprocal, an ulp off for most counts),
        and the quotient copied once into a new array the caller owns."""
        dev = self._dev
        if dev is None:
            return (self.acc / max(self.count, 1)).reshape(self.height, self.width, 3)
        mean = dev / torch.full((1,), max(self.count, 1), dtype=torch.float32, device=dev.device)
        out = torch.empty(mean.shape, dtype=torch.float32, pin_memory=dev.is_cuda)
        with profiling.span("render.copy"):  # waits for the device's queued work
            out.copy_(mean)
        profiling.count("render.dtoh_bytes", out.nbytes)
        return out.numpy().reshape(self.height, self.width, 3)

    def to_u8_rgba(self) -> np.ndarray:
        """Clamp [0, 1] -> u8 RGBA as the reference's rgb_f_to_u8
        (draw_scene.rs:104-109): (clamp(c, 0, 1) * 255 + 0.5) truncated."""
        u8 = (np.clip(self.mean_image(), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        return np.concatenate([u8, np.full(u8.shape[:2] + (1,), 255, np.uint8)], axis=-1)
