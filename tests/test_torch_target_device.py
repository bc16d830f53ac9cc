"""The render target's device sum (`render/target.py`): the running f32
sum lives on the Renderer's device between batches, the mean is taken
there and copied to the host once a call.

On the CPU: adds of tensors, with `acc` read between them or not, give
`acc` and `mean_image()` bit for bit the host numpy target's (an f32 add
a batch, `acc / max(count, 1)`); a write into `acc` is seen by the next
add; checkpoints round-trip; the async hook delivers a snapshot; two
render() calls return arrays of their own; hookless calls never bring the
sum to the host (`target.syncs`).

On the card (`python -m pytest --noconftest -m cuda
tests/test_torch_target_device.py`; no JAX): the device mean is numpy's
quotient for counts where multiplying by the reciprocal is not, a
hookless render copies once into pinned memory, and the fused, mesh and
wavefront drivers resume bitwise."""
import numpy as np
import pytest
import torch

from raytrace_tpu_torch.models import procedural
from raytrace_tpu_torch.models.walled import walled_scheme
from raytrace_tpu_torch.render.renderer import Renderer
from raytrace_tpu_torch.render.target import RenderTarget
from raytrace_tpu_torch.utils import checkpoint, profiling
from raytrace_tpu_torch.utils.hooks import AsyncHook

W, H = 16, 8
COUNTS = (1, 3, 7, 10, 16)
RESUMED = 2**31 + 1665  # a first sample id past 32 signed bits, as the benchmark draws them


def _sums(rng, n=W * H):
    """(n, 3) f32 batch sums over a wide range of magnitudes (and a -0.0)."""
    scale = rng.choice(np.float32([1e-3, 1.0, 77.7, 4e3]), (n, 3))
    out = (rng.random((n, 3), np.float32) * scale).astype(np.float32)
    out[0, 0] = -0.0
    return out


class _NumpyTarget:
    """The host target the device sum replaces: np.zeros, += and acc / count."""

    def __init__(self, count=0):
        self.acc, self.count = np.zeros((W * H, 3), np.float32), count

    def add(self, sums, n):
        self.acc += sums
        self.count += n

    def mean_image(self):
        return (self.acc / max(self.count, 1)).reshape(H, W, 3)


def _same(a, b):
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))


@pytest.mark.parametrize("start", (0, RESUMED))
@pytest.mark.parametrize("reads", ("never", "after every add", "after odd adds"))
def test_device_sum_is_the_numpy_sum(reads, start):
    rng = np.random.default_rng(7)
    t, ref = RenderTarget(W, H), _NumpyTarget(start)
    t.count = start
    _same(t.mean_image(), ref.mean_image())  # nothing added: zeros
    for i, n in enumerate(COUNTS):
        sums = _sums(rng)
        t.add(torch.from_numpy(sums.copy()), n)
        ref.add(sums, n)
        if reads == "after every add" or (reads == "after odd adds" and i % 2):
            _same(t.acc, ref.acc)
        _same(t.mean_image(), ref.mean_image())
    assert t.count == ref.count
    _same(t.acc, ref.acc)


@pytest.mark.parametrize("write", ("in place", "assigned"))
def test_a_write_into_acc_is_seen_by_the_next_add(write):
    rng = np.random.default_rng(3)
    t = RenderTarget(W, H)
    t.add(torch.from_numpy(_sums(rng)), 3)
    v = _sums(rng)
    if write == "in place":
        t.acc[:] = v
    else:
        t.acc = v.copy()
    more = _sums(rng)
    t.add(torch.from_numpy(more), 4)
    _same(t.acc, v + more)
    _same(t.mean_image(), ((v + more) / 7).reshape(H, W, 3))


def test_checkpoint_round_trips_a_device_sum(tmp_path):
    rng = np.random.default_rng(5)
    t, ref = RenderTarget(W, H), _NumpyTarget(RESUMED)
    t.count = RESUMED
    for n in (10, 6):
        sums = _sums(rng)
        t.add(torch.from_numpy(sums), n)
        ref.add(sums, n)
    path = str(tmp_path / "t.npz")
    checkpoint.save(path, t)
    back = checkpoint.load(path)
    assert back.count == ref.count and (back.width, back.height) == (W, H)
    _same(back.acc, ref.acc)
    sums = _sums(rng)
    back.add(torch.from_numpy(sums), 1)  # the loaded host sum is uploaded once
    ref.add(sums, 1)
    _same(back.mean_image(), ref.mean_image())


def test_async_hook_delivers_the_snapshot_not_the_live_target():
    rng = np.random.default_rng(11)
    seen = []
    live = RenderTarget(W, H)
    first = _sums(rng)
    live.add(torch.from_numpy(first), 2)
    hook = AsyncHook(lambda t: seen.append((t.count, t.acc.copy())))
    hook(live)
    live.add(torch.from_numpy(_sums(rng)), 3)  # after the snapshot: not delivered
    hook.close()
    assert len(seen) == 1 and seen[0][0] == 2
    _same(seen[0][1], np.zeros_like(first) + first)  # -0.0 added to zeros reads +0.0


@pytest.mark.parametrize("mode", ("gpu", "cpu"))
def test_render_calls_return_arrays_of_their_own(mode):
    r = Renderer(walled_scheme(W, H, assured=2), device="cpu", mode=mode)
    a = r.render(samples=1, progress=False)
    kept = a.copy()
    b = r.render(samples=1, progress=False)
    assert not np.shares_memory(a, b)
    _same(a, kept)
    assert a.shape == b.shape == (H, W, 3) and not np.array_equal(a, b)


@pytest.mark.parametrize("hook", (False, True))
def test_only_a_hook_brings_the_sum_to_the_host(hook):
    r = Renderer(walled_scheme(W, H, assured=2), device="cpu")
    profiling.reset()
    profiling.enable()
    try:
        for _ in range(2):
            r.render(samples=3, batch=1, progress=False,
                     update_hook=(lambda t: None) if hook else None)
        c = profiling.counters()
    finally:
        profiling.enable(False)
        profiling.reset()
    assert c["render.calls"] == 2 and c["render.batches"] == 6
    assert c["target.syncs"] == (6 if hook else 0)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the device sum's division and copy on the card")


@pytest.mark.cuda
def test_card_mean_is_numpys_quotient():
    """On the card, a real image sum (walled, 1200x600) divided by counts
    3, 7, 10, 16 and 20000 on the device is numpy's f32 quotient bit for
    bit, where multiplying by the reciprocal (torch's CUDA division by a
    Python number) is not."""
    _card()
    r = Renderer(walled_scheme(1200, 600), device="cuda")
    r.render(samples=16, progress=False)
    acc = r.target.acc.copy()
    dev = torch.from_numpy(acc).cuda()
    trapped = 0
    for count in (3, 7, 10, 16, 20000):
        t = RenderTarget(1200, 600)
        t.add(dev, count)
        want = (acc / count).reshape(600, 1200, 3)
        _same(t.mean_image(), want)
        trapped += not np.array_equal((dev / count).cpu().numpy().reshape(want.shape), want)
    assert trapped > 0  # the reciprocal is off somewhere: the quotient above is not an accident


@pytest.mark.cuda
def test_card_hookless_render_copies_once_into_pinned_memory():
    """A hookless render(samples=10) of the a380-class scene: one
    device-to-host copy a call, none of them to pageable memory, and the
    image numpy's mean of the host sum."""
    _card()
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    r = Renderer(procedural.a380_scheme(), device="cuda")
    assert r.driver == "mesh_fused"
    r.render(samples=10, progress=False)  # builds the kernels, the first pinned block
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        img = r.render(samples=10, progress=False)
        torch.cuda.synchronize()
    names = [e.name() for e in prof.profiler.kineto_results.events()
             if e.device_type() == DeviceType.CUDA]
    dtoh = [n for n in names if n.startswith("Memcpy DtoH")]
    assert dtoh and all("Pinned" in n for n in dtoh), dtoh
    assert len(dtoh) == 1, dtoh
    assert not any("Pageable" in n for n in names if n.startswith("Memcpy"))
    _same(img, (r.target.acc / r.target.count).reshape(img.shape))


def _card_renderer(driver):
    if driver == "mesh_fused":
        return Renderer(procedural.a380_scheme(152, 76), device="cuda", samples_per_launch=2)
    return Renderer(walled_scheme(96, 48, assured=2), device="cuda", samples_per_launch=2,
                    mode="cpu" if driver == "wavefront" else "gpu")


@pytest.mark.cuda
@pytest.mark.parametrize("driver", ("fused", "mesh_fused", "wavefront"))
def test_card_resume_is_bitwise(driver, tmp_path):
    """render(6) in batches of 3 against render(3), a checkpoint, and
    render(3) on a new Renderer, bitwise, the images numpy's means; and
    against the same batches with a hook reading the sum after each."""
    _card()
    full = _card_renderer(driver)
    assert full.driver == driver
    img = full.render(samples=6, batch=3, progress=False)
    half = _card_renderer(driver)
    half.render(samples=3, progress=False)
    path = str(tmp_path / "half.npz")
    checkpoint.save(path, half.target)
    resumed = _card_renderer(driver)
    resumed.target = checkpoint.load(path)
    img_r = resumed.render(samples=3, progress=False)
    _same(resumed.target.acc, full.target.acc)
    _same(img_r, img)
    _same(img, (full.target.acc / 6).reshape(img.shape))
    hooked = _card_renderer(driver)
    hooked.render(samples=6, batch=3, progress=False, update_hook=lambda t: t.acc,
                  async_hook=False)
    _same(hooked.target.acc, full.target.acc)
