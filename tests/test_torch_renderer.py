"""Port parity for the main path: raytrace_tpu_torch's Renderer on the
CPU (the plain torch version of the kernel) against the JAX package's
sample_batch on the same pixels and sample ids; exact resume; what the
port refuses; the CLI; and that the port runs without jax or flax."""
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


def _mesh_too_many_spheres(s):
    """A mesh scene beyond the mesh path: 65 spheres (the walled ones)."""
    from raytrace_tpu_torch.models.procedural import make_mesh

    _too_many_spheres(s)
    s.scene_members.append(cfg.ModelMember(path="<surface>", loaded=[make_mesh(64, 0)]))


@pytest.mark.parametrize("change", [
    lambda s: setattr(s.render_info, "use_gpu", False),
    lambda s: setattr(s.render_info.rad_info, "debug_single_ray", True),
    _too_many_spheres,
    lambda s: s.scene_members.append(cfg.CubeMapMember(faces={})),
    _mesh_too_many_spheres,
], ids=["cpu-mode", "debug-single-ray", "65-spheres", "cubemap", "mesh"])
def test_unsupported_scenes_raise(change):
    scheme = walled_scheme(W, H)
    change(scheme)
    with pytest.raises(NotImplementedError):
        Renderer(scheme, device="cpu")


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
