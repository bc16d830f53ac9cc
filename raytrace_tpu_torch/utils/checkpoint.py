"""Exact render resume: persist the f32 accumulator + sample count.

Mirrors `raytrace_tpu/utils/checkpoint.py` (same .npz keys, so the two
packages read each other's checkpoints). The RNG needs no state: streams
are derived from (pixel, sample id), and sample ids continue at the
saved count.
"""
from __future__ import annotations

import numpy as np

from ..render.target import RenderTarget


def save(path: str, target: RenderTarget) -> None:
    np.savez_compressed(
        path,
        acc=target.acc,
        count=np.int64(target.count),
        width=np.int64(target.width),
        height=np.int64(target.height),
    )


def load(path: str) -> RenderTarget:
    with np.load(path) as z:
        t = RenderTarget(int(z["width"]), int(z["height"]))
        t.acc = z["acc"].astype(np.float32)
        t.count = int(z["count"])
    return t
