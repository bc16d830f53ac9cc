"""Counter RNG keyed by (pixel, sample): jenkins seeding of x ^ (y << 16)
and the sample id, then one u32 state per lane stepped by the Weyl
increment and the lowbias32 finalizer. u32 words are held in int64
tensors, masked back to 32 bits after every operation."""
from __future__ import annotations

import torch

_M = 0xFFFFFFFF
_INV24 = float(torch.tensor(1.0 / 16777215.0, dtype=torch.float32))  # float32(1/(2^24 - 1))


def as_u32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & _M


def _jenkins(x: torch.Tensor) -> torch.Tensor:
    x = as_u32(x)
    x = (x + (x << 10)) & _M
    x = x ^ (x >> 6)
    x = (x + (x << 3)) & _M
    x = x ^ (x >> 11)
    return (x + (x << 15)) & _M


def init_state(xs, ys, samples) -> torch.Tensor:
    """The stream of each (pixel, sample) lane."""
    pix = as_u32(xs) ^ ((as_u32(ys) << 16) & _M)
    return _jenkins(_jenkins(pix) ^ _jenkins(as_u32(samples) ^ 0x9E3779B9))


def next_f32(state: torch.Tensor, dtype=torch.float32):
    """(state, a uniform in [0, 1]): the word's top 24 bits times
    float32(1 / (2^24 - 1)), then cast to `dtype`."""
    s = (state + 0x9E3779B9) & _M
    w = s ^ (s >> 16)
    w = (w * 0x21F0AAAD) & _M
    w = w ^ (w >> 15)
    w = (w * 0x735A2D97) & _M
    w = w ^ (w >> 15)
    u = (w >> 8).to(torch.float32) * torch.tensor(_INV24, dtype=torch.float32, device=w.device)
    return s, u.to(dtype)


def draws(state: torch.Tensor, n: int, dtype=torch.float32):
    out = []
    for _ in range(n):
        state, u = next_f32(state, dtype)
        out.append(u)
    return state, out
