"""Keyframe animation: the 18 easing functions and per-frame scene
member extraction.

A copy of `raytrace_tpu/models/animation.py` (the reference's
builder/mod.rs:20-60 and builder/inner.rs:113-249, built on the
`keyframe` crate), over the port's own config dataclasses:

* every animated member carries keyframes of (translation,
  euler_angles?, ease_type?, time);
* frame count = floor(last_keyframe_time * framerate)
  (inner.rs:116-119);
* a frame samples each sequence at t = frame / framerate; spheres get
  their center replaced, models their translation and euler_angles
  (inner.rs:128-211), an in-memory model (`ModelMember.loaded`) too;
  free triangles and cube maps are copied verbatim;
* between two keyframes k1 -> k2 the eased progress x in [0, 1] is
  mapped by k1's easing function (the keyframe crate's
  Keyframe::ease_to uses the function of the keyframe being left).

Easing functions follow the keyframe crate: the polynomial families
are closed-form; EaseIn/EaseOut/EaseInOut (no suffix) are the CSS
cubic-bezier presets (0.42,0,1,1) / (0,0,0.58,1) / (0.42,0,0.58,1),
evaluated by Newton-solving the bezier x(s) = t.
"""
from __future__ import annotations

import copy

import numpy as np

from .config import ModelMember, Scheme, SphereMember


# -- easing ---------------------------------------------------------------


def _bezier(p1x, p1y, p2x, p2y):
    """CSS cubic-bezier easing through (0,0),(p1),(p2),(1,1)."""

    def x_of(s):
        return 3 * p1x * s * (1 - s) ** 2 + 3 * p2x * s * s * (1 - s) + s**3

    def y_of(s):
        return 3 * p1y * s * (1 - s) ** 2 + 3 * p2y * s * s * (1 - s) + s**3

    def f(t):
        t = float(np.clip(t, 0.0, 1.0))
        s = t
        for _ in range(8):  # Newton
            xs = x_of(s) - t
            dx = 3 * p1x * (1 - s) * (1 - 3 * s) + 3 * p2x * s * (2 - 3 * s) + 3 * s * s
            if abs(dx) < 1e-8:
                break
            s = float(np.clip(s - xs / dx, 0.0, 1.0))
        return y_of(s)

    return f


def _poly_in(p):
    return lambda t: t**p


def _poly_out(p):
    return lambda t: 1.0 - (1.0 - t) ** p


def _poly_inout(p):
    def f(t):
        if t < 0.5:
            return (2.0**(p - 1)) * t**p
        return 1.0 - ((-2.0 * t + 2.0) ** p) / 2.0

    return f


EASING = {
    "EaseIn": _bezier(0.42, 0.0, 1.0, 1.0),
    "EaseOut": _bezier(0.0, 0.0, 0.58, 1.0),
    "EaseInOut": _bezier(0.42, 0.0, 0.58, 1.0),
    "EaseInQuad": _poly_in(2),
    "EaseInCubic": _poly_in(3),
    "EaseInQuart": _poly_in(4),
    "EaseInQuint": _poly_in(5),
    "EaseOutQuad": _poly_out(2),
    "EaseOutCubic": _poly_out(3),
    "EaseOutQuart": _poly_out(4),
    "EaseOutQuint": _poly_out(5),
    "EaseInOutQuad": _poly_inout(2),
    "EaseInOutCubic": _poly_inout(3),
    "EaseInOutQuart": _poly_inout(4),
    "EaseInOutQuint": _poly_inout(5),
    "Linear": lambda t: t,
    "Hold": lambda t: 0.0,
    "Step": lambda t: 0.0 if t < 0.5 else 1.0,
}


def ease(name: str, t: float) -> float:
    try:
        return EASING[name](float(np.clip(t, 0.0, 1.0)))
    except KeyError:
        raise ValueError(f"Unsupported easing function: {name}")  # builder/mod.rs:57


def sample_sequence(keyframes, values: np.ndarray, t: float) -> np.ndarray:
    """Evaluate a keyframe sequence of per-keyframe `values` (K, D) at
    time t: clamp outside the range, otherwise ease between the
    surrounding pair with the LEFT keyframe's easing."""
    times = [k.time for k in keyframes]
    if t <= times[0]:
        return values[0]
    if t >= times[-1]:
        return values[-1]
    hi = int(np.searchsorted(times, t, side="right"))
    lo = hi - 1
    span = times[hi] - times[lo]
    x = 0.0 if span <= 0 else (t - times[lo]) / span
    y = ease(keyframes[lo].ease_type, x)
    return values[lo] + (values[hi] - values[lo]) * y


def last_timestamp(scheme: Scheme) -> float:
    """Max over members of the final keyframe time (inner.rs:218-249)."""
    best = 0.0
    for m in scheme.scene_members:
        anim = getattr(m, "animation", None)
        if anim is not None and anim.keyframes:
            best = max(best, anim.keyframes[-1].time)
    return best


def extract_frames(scheme: Scheme, framerate: float):
    """Per-frame scene member lists (inner.rs:113-216): n_frames =
    floor(last_time * framerate); frame i samples at t = i/framerate.
    Returns a list of Schemes sharing render_info/cam."""
    max_time = last_timestamp(scheme)
    n_frames = int(max_time * framerate)  # (max_time / (1/framerate)) truncated
    frames = []
    for i in range(n_frames):
        t = i / framerate
        members = []
        for m in scheme.scene_members:
            anim = getattr(m, "animation", None)
            if anim is None or not anim.keyframes:
                members.append(m)
                continue
            kfs = anim.keyframes
            trans = sample_sequence(kfs, np.stack([k.translation for k in kfs]), t)
            m2 = copy.copy(m)
            if isinstance(m, SphereMember):
                m2.c = trans.astype(np.float32)
            elif isinstance(m, ModelMember):
                m2.translation = trans.astype(np.float32)
                eulers = np.stack(
                    [
                        (k.euler_angles if k.euler_angles is not None else np.zeros(3))
                        for k in kfs
                    ]
                )
                m2.euler_angles = sample_sequence(kfs, eulers, t).astype(np.float32)
            members.append(m2)
        f = copy.copy(scheme)
        f.scene_members = members
        frames.append(f)
    return frames
