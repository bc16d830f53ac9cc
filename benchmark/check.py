"""The comparison that decides `correct`: the batch sums that checked
calls added to the image, against the reference's sums of the same
(pixel, sample) paths, on the check's pixels (whole rows, or pixels
drawn over the frame: traffic.check_pixels).

A call's batch sum is recovered from the mean images the program
returned: m_k c_k - m_{k-1} c_{k-1} (c the target's count; m_{k-1} = 0
on an image's first call), exact to the rounding of those f32 means and
of the image's f32 running sum, which `ULPS` ulps of c m cover. A pixel
is off when any channel differs from the reference by more than REL of
the reference's sum beyond that rounding; `pixels_off_pct` is the share
of the checked pixels lit on either side (a sum above 0, beyond that
rounding) that are off, worst over the checked calls: pixels that no path
lit agree whatever the program does, and in the cpu semantics most of
the a380 frame is such."""
from __future__ import annotations

import numpy as np
import torch

from .reference import paths

REL = 1e-3  # relative gap of one pixel's batch sum (the kernels' own gate)
ULPS = 4
EPS32 = 2.0 ** -24
LANES = 1 << 21  # lanes of one reference launch


def reference_sums(scene, use_gpu: bool, ys, xs, start: int, n: int, *,
                   assured: int, max_bounces: int, work=None) -> torch.Tensor:
    """(len(ys), 3) sums over samples start .. start+n-1, in sample
    order, of the pixels (ys, xs)."""
    dev = scene.sph["c"].device
    ys = torch.as_tensor(np.asarray(ys), dtype=torch.int64, device=dev)
    xs = torch.as_tensor(np.asarray(xs), dtype=torch.int64, device=dev)
    P = xs.numel()
    fn = paths.fused_paths if use_gpu else paths.integrator_paths
    acc = torch.zeros((P, 3), dtype=scene.dtype, device=dev)
    step = max(1, LANES // P)
    for s0 in range(0, n, step):
        k = min(step, n - s0)
        samples = (start + s0 + torch.arange(k, device=dev)).repeat_interleave(P)
        L = fn(scene, xs.repeat(k), ys.repeat(k), samples, assured=assured,
               max_bounces=max_bounces, work=work).view(k, P, 3)
        for j in range(k):
            acc = acc + L[j]
    return acc


def program_sums(cur: np.ndarray, c_cur: int, prev, c_prev: int):
    """(sums, slack): the batch sums recovered from the mean images' checked pixels
    (prev None on an image's first call) and the rounding that bounds
    their error."""
    m1 = np.asarray(cur, np.float64).reshape(-1, 3)
    c1 = float(np.float32(c_cur))
    m0 = np.zeros_like(m1) if prev is None else np.asarray(prev, np.float64).reshape(-1, 3)
    c0 = 0.0 if prev is None else float(np.float32(c_prev))
    return m1 * c1 - m0 * c0, ULPS * EPS32 * (c1 * np.abs(m1) + c0 * np.abs(m0))


def pixels_off_pct(sums: np.ndarray, ref: np.ndarray, slack=0.0) -> float:
    ref, sums = np.asarray(ref, np.float64), np.asarray(sums, np.float64)
    ok = (np.abs(sums - ref) <= REL * np.abs(ref) + slack).all(axis=1)
    lit = (ref != 0).any(axis=1) | ~(np.abs(sums) <= slack).all(axis=1)
    return 100.0 * float((~ok & lit).sum()) / max(int(lit.sum()), 1)
