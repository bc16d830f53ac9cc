"""Port parity: counter RNG and raygen of raytrace_tpu_torch against
raytrace_tpu on the same (pixel, sample) grid. RNG words must be
bit-equal for both generator families; rays agree to 1e-6."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from __graft_entry__ import _inline_walled_scheme
from raytrace_tpu.models.camera import build_camera as jax_build_camera
from raytrace_tpu.ops import raygen as jax_raygen
from raytrace_tpu.ops import rng as jax_rng
from raytrace_tpu.render.renderer import camera_to_arrays
from raytrace_tpu_torch.models.camera import build_camera
from raytrace_tpu_torch.models.walled import walled_scheme
from raytrace_tpu_torch.ops import raygen, rng
from raytrace_tpu_torch.ops.trace_kernel import make_cam_vec

W, H, SAMPLES = 64, 32, 8


def _grid():
    """Every pixel of a 64x32 canvas x 8 sample ids, flattened."""
    pix = np.arange(W * H, dtype=np.int32)
    xs = np.tile(pix % W, SAMPLES)
    ys = np.tile(pix // W, SAMPLES)
    samp = np.repeat(np.arange(SAMPLES, dtype=np.int32) + 1000, W * H)
    return xs, ys, samp


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().astype(np.uint32)


def test_jenkins_hash_bit_equal():
    x = np.random.default_rng(0).integers(0, 2**31 - 1, 4096, dtype=np.int64).astype(np.int32)
    ours = rng.jenkins_hash(torch.from_numpy(x))
    ref = np.asarray(jax_rng.jenkins_hash(jnp.asarray(x)))
    np.testing.assert_array_equal(_u32(ours), ref)


@pytest.mark.parametrize("generator", ["weyl", "pcg"])
def test_streams_bit_equal(generator, monkeypatch):
    monkeypatch.setattr(jax_rng, "GENERATOR", generator)
    xs, ys, samp = _grid()
    state = rng.init_state(torch.from_numpy(xs), torch.from_numpy(ys), torch.from_numpy(samp))
    jstate = jax_rng.init_state(jnp.asarray(xs), jnp.asarray(ys), W, H, jnp.asarray(samp))
    np.testing.assert_array_equal(_u32(state), np.asarray(jstate))
    for _ in range(3):
        state, word = rng.next_u32(state, generator)
        jstate, jword = jax_rng.next_u32(jstate)
        np.testing.assert_array_equal(_u32(state), np.asarray(jstate))
        np.testing.assert_array_equal(_u32(word), np.asarray(jword))
    state, us = rng.next_f32_n(state, 5, generator)
    for u in us:
        jstate, ju = jax_rng.next_f32(jstate)
        # bit-equal floats, not merely close
        np.testing.assert_array_equal(u.numpy().view(np.uint32), np.asarray(ju).view(np.uint32))
    np.testing.assert_array_equal(_u32(state), np.asarray(jstate))


def test_unknown_generator_raises():
    with pytest.raises(ValueError):
        rng.next_u32(torch.zeros(4, dtype=torch.int64), "xorshift")


@pytest.mark.parametrize("lens_r", [None, 0.15])
def test_raygen_matches(lens_r):
    xs, ys, samp = _grid()
    jscheme = _inline_walled_scheme(W, H)
    jscheme.cam.lens_r = lens_r
    scheme = walled_scheme(W, H)
    scheme.cam.lens_r = lens_r
    cam = build_camera(scheme.cam, W, H)

    state = rng.init_state(torch.from_numpy(xs), torch.from_numpy(ys), torch.from_numpy(samp))
    state, ro, rd = raygen.generate(state, torch.from_numpy(xs), torch.from_numpy(ys),
                                    make_cam_vec(cam), has_lens=lens_r is not None)
    jstate = jax_rng.init_state(jnp.asarray(xs), jnp.asarray(ys), W, H, jnp.asarray(samp))
    jstate, jro, jrd = jax_raygen.generate(
        jstate, jnp.asarray(xs), jnp.asarray(ys),
        camera_to_arrays(jax_build_camera(jscheme.cam, W, H)))

    # the same draws were consumed
    np.testing.assert_array_equal(_u32(state), np.asarray(jstate))
    for ours, ref in zip((*ro, *rd), (jro.x, jro.y, jro.z, jrd.x, jrd.y, jrd.z)):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
