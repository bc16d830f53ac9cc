"""Port parity for the main path: raytrace_tpu_torch's Renderer on the
CPU (the plain torch version of the kernel) against the JAX package's
sample_batch on the same pixels and sample ids; the Renderer's choice of
driver (scenes outside the fused kernel go to the wavefront, and their
images agree with the JAX package); cube-map scenes through the fused
kernel; exact sample counts and resume; what the port refuses; the CLI;
and that the port runs without jax or flax."""
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from PIL import Image

from raytrace_tpu.models.camera import build_camera as jax_build_camera
from raytrace_tpu.models.scene import build_scene as jax_build_scene
from raytrace_tpu.render.integrator import IntegratorParams
from raytrace_tpu.render.renderer import camera_to_arrays, sample_batch
from raytrace_tpu_torch.models import config as cfg
from raytrace_tpu_torch.models.walled import walled_scheme
from raytrace_tpu_torch.render.renderer import Renderer
from raytrace_tpu_torch.utils import checkpoint as ckpt
from raytrace_tpu_torch.utils.image import encode_png
from test_torch_scene import schemes
from test_torch_trace_kernel import lane_gate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, SPP = 32, 16, 4


def tile_gate(img, ref, t=8):
    """scripts/hw_parity.py: channel-mean diff < 2e-3 and < 2% of 8x8
    tiles off by > 0.06."""
    def tiles(a):
        h, w, _ = a.shape
        return a[: h - h % t, : w - w % t].reshape(h // t, t, w // t, t, 3).mean(axis=(1, 3))

    mean_d = float(np.abs(img.mean(axis=(0, 1)) - ref.mean(axis=(0, 1))).max())
    bad = float((np.abs(tiles(img) - tiles(ref)).max(axis=-1) > 0.06).mean())
    assert mean_d < 2e-3 and bad < 0.02, (mean_d, bad)


@pytest.mark.parametrize("name", ["walled", "mixed"])
def test_renderer_matches_jax_sample_batch(name):
    js, ps = schemes(name, W, H, 5)
    flat = np.arange(W * H, dtype=np.int32)
    ref = np.asarray(sample_batch(
        jax_build_scene(js), camera_to_arrays(jax_build_camera(js.cam, W, H)),
        IntegratorParams(assured_depth=5, max_bounces=24), W, H,
        jnp.asarray(flat % W), jnp.asarray(flat // W), jnp.int32(0), jnp.int32(SPP)))

    r = Renderer(ps, device="cpu", samples_per_launch=3)  # launches of 3 + 1 samples
    img = r.render(samples=SPP)
    assert r.target.count == SPP and img.shape == (H, W, 3)
    lane_gate(r.target.acc, ref)
    tile_gate(img, ref.reshape(H, W, 3) / SPP)
    assert img.mean() > 0.05


def test_resume_bitwise_exact(tmp_path):
    scheme = walled_scheme(W, H)
    full = Renderer(scheme, device="cpu")
    full.render(samples=4, batch=2)

    first = Renderer(scheme, device="cpu")
    first.render(samples=2, batch=2)
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, first.target)

    resumed = Renderer(scheme, device="cpu")
    resumed.target = ckpt.load(path)
    assert resumed.target.count == 2
    resumed.render(samples=2, batch=2)
    assert resumed.target.count == full.target.count == 4
    np.testing.assert_array_equal(resumed.target.acc, full.target.acc)


def _too_many_spheres(s):
    s.scene_members = s.scene_members * 5  # 65 spheres


def _cpu_mode(s):
    s.render_info.use_gpu = False


def _debug_single_ray(s):
    s.render_info.rad_info.debug_single_ray = True


# scenes outside both fused drivers: each change applies to the JAX and
# the port scheme alike; "mesh" adds a 64-triangle surface to 65 spheres
WAVEFRONT_CASES = {"cpu-mode": _cpu_mode, "debug-single-ray": _debug_single_ray,
                   "65-spheres": _too_many_spheres, "mesh": _too_many_spheres}


@pytest.mark.parametrize("name", list(WAVEFRONT_CASES))
def test_wavefront_scenes_render(name):
    """The Renderer routes each scene to the wavefront driver, and its
    image agrees with the JAX package's sample_batch."""
    from raytrace_tpu_torch.models.procedural import make_mesh
    from test_torch_mesh_scene import jax_build_with_mesh

    js, ps = schemes("walled", W, H, 5)
    for s in (js, ps):
        WAVEFRONT_CASES[name](s)
    if name == "mesh":
        mesh = make_mesh(64, 0)
        ps.scene_members.append(cfg.ModelMember(path="<surface>", loaded=[mesh]))
        jscene = jax_build_with_mesh(js, mesh)
    else:
        jscene = jax_build_scene(js)
    r = Renderer(ps, device="cpu", samples_per_launch=3)  # wavefront batches of 3 + 1 samples
    assert r.driver == "wavefront"
    assert (r.tables.n_mesh_tris > 0) == (name == "mesh")
    img = r.render(samples=SPP)
    assert r.target.count == SPP and r.stats["iterations"] > 0
    flat = np.arange(W * H, dtype=np.int32)
    params = IntegratorParams(assured_depth=5, max_bounces=24, mode=r.mode,
                              debug_single_ray=r.params.debug_single_ray)
    ref = np.asarray(sample_batch(
        jscene, camera_to_arrays(jax_build_camera(js.cam, W, H)), params, W, H,
        jnp.asarray(flat % W), jnp.asarray(flat // W), jnp.int32(0), jnp.int32(SPP)))
    lane_gate(r.target.acc, ref)
    tile_gate(img, ref.reshape(H, W, 3) / SPP)
    assert img.mean() > 0.01


def _sky_scheme(tmp_path):
    """The mixed scene (open to the sky) under a cube map."""
    from test_torch_cubemap import add_sky, write_faces

    return add_sky(schemes("mixed", W, H, 5)[1], cfg, cfg.parse_member, write_faces(tmp_path))


def test_sky_scene_renders(tmp_path):
    """A meshless cube-map scene takes trace_tiles (its plain version
    here); the image passes the tile gate against the wavefront's, and
    the sky shows: the scene without it is darker."""
    scheme = _sky_scheme(tmp_path)
    r = Renderer(scheme, device="cpu", samples_per_launch=3)
    assert r.driver == "fused" and r.tables.sky is not None
    img = r.render(samples=SPP)
    wave = Renderer(scheme, device="cpu", use_wavefront=True)
    assert wave.driver == "wavefront" and wave.tables.sky is not None
    tile_gate(img, wave.render(samples=SPP))
    no_sky = Renderer(schemes("mixed", W, H, 5)[1], device="cpu").render(samples=SPP)
    assert img.mean() > 1.5 * no_sky.mean()
    assert np.abs(img - no_sky).max(-1).mean() > 0.05  # most pixels see it


def test_sky_resume_bitwise_exact(tmp_path):
    scheme = _sky_scheme(tmp_path)
    full = Renderer(scheme, device="cpu")
    full.render(samples=4, batch=2)
    first = Renderer(scheme, device="cpu")
    first.render(samples=2)
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, first.target)
    resumed = Renderer(scheme, device="cpu")
    resumed.target = ckpt.load(path)
    resumed.render(samples=2)
    assert resumed.target.count == full.target.count == 4
    np.testing.assert_array_equal(resumed.target.acc, full.target.acc)


@pytest.fixture(scope="module")
def octa_scheme(tmp_path_factory):
    from test_torch_mesh_scene import octa_schemes, write_gltf

    path = write_gltf(tmp_path_factory.mktemp("octa") / "m.gltf", textured=True)
    return octa_schemes(path, W, H)[1]


@pytest.mark.parametrize("async_hook", [True, False], ids=["async", "sync"])
@pytest.mark.parametrize("kw,driver", [
    ({}, "fused"), ({"use_fused": False}, "wavefront"),
    ({"use_fused": False, "use_wavefront": False}, "plain"),
    ({"mode": "cpu", "use_wavefront": False}, "plain"),
    ({"mesh": True}, "mesh_fused"), ({"mesh": True, "use_mesh_fused": False}, "wavefront"),
], ids=["fused", "wavefront", "plain", "plain-cpu", "mesh_fused", "mesh-wavefront"])
def test_render_exact_sample_count_all_drivers(octa_scheme, kw, driver, async_hook):
    """render(k) adds exactly k samples on every driver
    (tests/test_render.py:334), also across launches of
    samples_per_launch samples and in batches that do not divide k, with
    an update hook that sees every batch's count (the async one, which
    coalesces, at least the last) and the final target."""
    kw = dict(kw)
    scheme = octa_scheme if kw.pop("mesh", False) else walled_scheme(W, H)
    r = Renderer(scheme, device="cpu", samples_per_launch=2, **kw)
    assert r.driver == driver
    counts = []
    r.render(samples=3, batch=2, update_hook=lambda t: counts.append(t.count),
             async_hook=async_hook, progress=False)
    assert r.target.count == 3 and counts[-1] == 3
    assert set(counts) <= {2, 3} if async_hook else counts == [2, 3]
    r.render(samples=2, progress=False)
    assert r.target.count == 5
    assert np.isfinite(r.target.acc).all() and r.target.acc.mean() > 0


def test_wavefront_matches_plain_driver():
    """The two integrator drivers: the lane pool against all pixels at
    once, both in the 32x32-tile lane order."""
    scheme = walled_scheme(W, H)
    a = Renderer(scheme, device="cpu", mode="cpu", use_wavefront=True)
    b = Renderer(scheme, device="cpu", mode="cpu", use_wavefront=False)
    a.render(samples=3)
    b.render(samples=3)
    np.testing.assert_allclose(a.target.acc, b.target.acc, rtol=1e-4, atol=1e-4)
    assert a.stats["lane_bounces"] >= W * H * 3


def test_resume_bitwise_exact_cpu_semantics(tmp_path):
    """Checkpoint resume through the wavefront driver in cpu semantics."""
    scheme = walled_scheme(W, H)
    full = Renderer(scheme, device="cpu", mode="cpu")
    assert full.driver == "wavefront"
    full.render(samples=4, batch=2)
    first = Renderer(scheme, device="cpu", mode="cpu")
    first.render(samples=2)
    path = str(tmp_path / "ck.npz")
    ckpt.save(path, first.target)
    resumed = Renderer(scheme, device="cpu", mode="cpu")
    resumed.target = ckpt.load(path)
    resumed.render(samples=2)
    assert resumed.target.count == full.target.count == 4
    np.testing.assert_array_equal(resumed.target.acc, full.target.acc)


@pytest.mark.parametrize("kw", [
    {"mode": "cpu", "use_fused": True}, {"use_mesh_fused": True},
    {"use_fused": True, "use_wavefront": True}, {"mode": "metal"},
], ids=["fused-cpu-mode", "mesh-fused-no-mesh", "two-drivers", "bad-mode"])
def test_explicit_driver_outside_its_scenes_raises(kw):
    """An explicit True for a driver the scene is outside raises; nothing
    routes elsewhere quietly."""
    with pytest.raises((NotImplementedError, ValueError)):
        Renderer(walled_scheme(W, H), device="cpu", **kw)


def test_cuda_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        Renderer(walled_scheme(W, H), device="cuda")


def test_png_round_trip():
    img = np.random.default_rng(0).integers(0, 256, (5, 7, 4), dtype=np.uint8)
    import io

    back = np.asarray(Image.open(io.BytesIO(encode_png(img))))
    np.testing.assert_array_equal(back, img[::-1])  # row 0 = bottom, flipped on save


def test_cli_writes_png_and_resumes(tmp_path):
    from raytrace_tpu_torch import cli

    yml = tmp_path / "walled.yml"
    yml.write_text(
        "render_info: {width: 32, height: 16, samps_per_pix: 2,\n"
        "  rad_info: {russ_roull_info: {assured_depth: 3, max_thres: 0.5}}}\n"
        "cam: {d: [0, 0, -5], o: [0, -1, 0], up: [0, 1, 0], screen_width: 10, screen_height: 5}\n"
        "scene_members:\n"
        "- !Sphere {c: [0, 10, -15], r: 5, coloring: !Solid [0, 0, 0],\n"
        "   mat: {divert_ray: Diff, emissive: [5, 5, 5]}}\n"
        "- !Sphere {c: [0, -510, -10], r: 500, coloring: !Solid [0.75, 0.75, 0.75],\n"
        "   mat: {divert_ray: Diff}}\n")
    out, ck = tmp_path / "out.png", tmp_path / "ck.npz"
    cli.main([str(yml), "no_ui", "--device", "cpu", "--out", str(out), "--checkpoint", str(ck)])
    png = np.asarray(Image.open(out))
    assert png.shape == (16, 32, 4) and png[..., :3].max() > 0
    assert ckpt.load(str(ck)).count == 2
    cli.main([str(yml), "--device", "cpu", "--samples", "1", "--out", str(out),
              "--resume", str(ck), "--checkpoint", str(ck)])
    assert ckpt.load(str(ck)).count == 3


def test_cli_renders_cube_map_scheme(tmp_path, capsys):
    """A !DistantCubeMap scheme: face paths relative to the scheme resolve
    against its directory."""
    from raytrace_tpu_torch import cli
    from test_torch_cubemap import write_faces

    faces = "".join(f"    {n}: [{os.path.basename(p)}, {us}, {vs}]\n"
                    for n, (p, us, vs) in write_faces(tmp_path).items())
    yml = tmp_path / "sky.yml"
    yml.write_text(
        "render_info: {width: 32, height: 16, samps_per_pix: 2,\n"
        "  rad_info: {russ_roull_info: {assured_depth: 3, max_thres: 0.5}}}\n"
        "cam: {d: [0, 0, -5], o: [0, -1, 0], up: [0, 1, 0], screen_width: 10, screen_height: 5}\n"
        "scene_members:\n"
        "- !Sphere {c: [0, -1, -6], r: 1, coloring: !Solid [0.75, 0.75, 0.75],\n"
        "   mat: {divert_ray: Spec}}\n"
        f"- !DistantCubeMap\n{faces}")
    out = tmp_path / "out.png"
    cli.main([str(yml), "no_ui", "--device", "cpu", "--out", str(out)])
    assert "fused driver" in capsys.readouterr().out
    png = np.asarray(Image.open(out))
    assert png.shape == (16, 32, 4) and (png[..., :3].max(-1) > 0).mean() > 0.9


def test_cli_mode_cpu(tmp_path, capsys):
    from raytrace_tpu_torch import cli

    yml = tmp_path / "walled.yml"
    yml.write_text(
        "render_info: {width: 32, height: 16, samps_per_pix: 2,\n"
        "  rad_info: {russ_roull_info: {assured_depth: 3, max_thres: 0.5}}}\n"
        "cam: {d: [0, 0, -5], o: [0, -1, 0], up: [0, 1, 0], screen_width: 10, screen_height: 5}\n"
        "scene_members:\n"
        "- !Sphere {c: [0, 10, -15], r: 5, coloring: !Solid [0, 0, 0],\n"
        "   mat: {divert_ray: Diff, emissive: [5, 5, 5]}}\n"
        "- !Sphere {c: [0, -510, -10], r: 500, coloring: !Solid [0.75, 0.75, 0.75],\n"
        "   mat: {divert_ray: Diff}}\n")
    out = tmp_path / "out.png"
    cli.main([str(yml), "no_ui", "--device", "cpu", "--mode", "cpu", "--out", str(out)])
    assert "cpu semantics, wavefront driver" in capsys.readouterr().out
    png = np.asarray(Image.open(out))
    assert png.shape == (16, 32, 4) and png[..., :3].max() > 0
    with pytest.raises(SystemExit):
        cli.main([str(yml), "--device", "cpu", "--mode", "metal", "--out", str(out)])


def test_port_runs_without_jax():
    """The port renders with neither jax, flax nor the JAX package
    imported (a subprocess: conftest imports jax in this one)."""
    code = (
        "import sys\n"
        "from raytrace_tpu_torch.models.walled import walled_scheme\n"
        "from raytrace_tpu_torch.render.renderer import Renderer\n"
        "import raytrace_tpu_torch.cli\n"
        "img = Renderer(walled_scheme(32, 16), device='cpu').render(samples=1)\n"
        "assert img.shape == (16, 32, 3) and img.mean() > 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'raytrace_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_cpu_semantics_render_runs_without_jax():
    """A cpu-semantics render with direct-light sampling, through the
    wavefront, with neither jax, flax nor the JAX package imported."""
    code = (
        "import sys\n"
        "from raytrace_tpu_torch.models.walled import walled_scheme\n"
        "from raytrace_tpu_torch.render.renderer import Renderer\n"
        "s = walled_scheme(32, 16)\n"
        "s.render_info.rad_info.dir_light_samp = True\n"
        "r = Renderer(s, device='cpu', mode='cpu')\n"
        "img = r.render(samples=1)\n"
        "assert r.driver == 'wavefront' and r.params.dir_light_samp, r.driver\n"
        "assert img.shape == (16, 32, 3) and img.mean() > 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'raytrace_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
