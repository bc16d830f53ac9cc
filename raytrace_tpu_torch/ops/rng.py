"""Counter RNG keyed by (pixel, sample): the port's explicit generator.

Mirrors `raytrace_tpu/ops/rng.py:45-124` bit for bit: jenkins seeding of
x ^ (y << 16) and the sample id, then one u32 state per lane stepped by
the `weyl` (Weyl increment + lowbias32 finalizer, the default) or `pcg`
(the reference's trace.wgsl:1262-1269) generator. The family is passed
explicitly; nothing here touches torch's global RNG.

torch has no uint32 add or shift on the CPU, so u32 words are held in
int64 tensors in [0, 2**32) and every op is masked back to 32 bits.
With these constants every product stays below 2**63, so nothing
overflows. The CUDA kernel (csrc/trace_kernel.cu) uses uint32_t.
"""
from __future__ import annotations

import torch

GENERATORS = ("weyl", "pcg")
_M = 0xFFFFFFFF
# float32(1.0 / 16777215.0) == 0x1.000002p-24: the 24-bit uniform scale
_INV24 = torch.tensor(1.0 / 16777215.0, dtype=torch.float32)


def as_u32(x: torch.Tensor) -> torch.Tensor:
    """Integer tensor -> its u32 bit pattern held in int64."""
    return x.to(torch.int64) & _M


def jenkins_hash(x: torch.Tensor) -> torch.Tensor:
    """Jenkins one-at-a-time style avalanche (trace.wgsl:1271-1279)."""
    x = as_u32(x)
    x = (x + (x << 10)) & _M
    x = x ^ (x >> 6)
    x = (x + (x << 3)) & _M
    x = x ^ (x >> 11)
    x = (x + (x << 15)) & _M
    return x


def init_state(x_idx, y_idx, sample_idx) -> torch.Tensor:
    """Per-(pixel, sample) stream seed: jenkins(jenkins(x ^ (y << 16)) ^
    jenkins(sample ^ 0x9E3779B9))."""
    pix = as_u32(x_idx) ^ ((as_u32(y_idx) << 16) & _M)
    return jenkins_hash(jenkins_hash(pix) ^ jenkins_hash(as_u32(sample_idx) ^ 0x9E3779B9))


def next_u32(state: torch.Tensor, generator: str = "weyl"):
    """One generator step: returns (new_state, random u32 word)."""
    if generator == "weyl":
        s = (state + 0x9E3779B9) & _M
        w = s ^ (s >> 16)
        w = (w * 0x21F0AAAD) & _M
        w = w ^ (w >> 15)
        w = (w * 0x735A2D97) & _M
        return s, w ^ (w >> 15)
    if generator == "pcg":
        s = (state * 747796405 + 2891336453) & _M
        w = (((s >> ((s >> 28) + 4)) ^ s) * 277803737) & _M
        return s, (w >> 22) ^ w
    raise ValueError(f"unknown generator {generator!r} (expected one of {GENERATORS})")


def next_f32(state: torch.Tensor, generator: str = "weyl"):
    """One uniform f32 in [0, 1] from the top 24 bits: (w >> 8) times
    float32(1/16777215) — a multiply, as in the reference, not a divide."""
    state, word = next_u32(state, generator)
    return state, (word >> 8).to(torch.float32) * _INV24


def next_f32_n(state: torch.Tensor, n: int, generator: str = "weyl"):
    """Draw `n` sequential uniforms; returns (state, tuple of draws)."""
    out = []
    for _ in range(n):
        state, u = next_f32(state, generator)
        out.append(u)
    return state, tuple(out)
