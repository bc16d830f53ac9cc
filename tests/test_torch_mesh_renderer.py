"""Port parity for the mesh main path: raytrace_tpu_torch's Renderer on a
`!Model` scheme on the CPU (the plain torch version of the mesh kernel)
against the JAX package's sample_batch on the same pixels and sample
ids; mesh scenes outside the mesh path kernel through the wavefront;
exact resume; what the port refuses; the CLI on a `!Model` scheme; and
that a mesh render runs without jax."""
import os
import subprocess
import sys

import numpy as np
import jax.numpy as jnp
import pytest
from PIL import Image

from raytrace_tpu.models import config as jax_cfg
from raytrace_tpu.models.camera import build_camera as jax_build_camera
from raytrace_tpu.models.scene import build_scene as jax_build_scene
from raytrace_tpu.render.integrator import IntegratorParams
from raytrace_tpu.render.renderer import camera_to_arrays, sample_batch
from raytrace_tpu_torch.models import config as cfg
from raytrace_tpu_torch.ops import mesh_kernel as mk
from raytrace_tpu_torch.render.renderer import Renderer
from raytrace_tpu_torch.utils import checkpoint as ckpt
from test_torch_mesh_path import assert_close
from test_torch_mesh_scene import octa_schemes, write_gltf
from test_torch_renderer import tile_gate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H, SPP = 32, 16, 4


@pytest.fixture(scope="module")
def gltf_path(tmp_path_factory):
    return write_gltf(tmp_path_factory.mktemp("mesh") / "m.gltf", textured=True)


def test_renderer_matches_jax_sample_batch(gltf_path):
    js, ps = octa_schemes(gltf_path, W, H)
    flat = np.arange(W * H, dtype=np.int32)
    ref = np.asarray(sample_batch(
        jax_build_scene(js), camera_to_arrays(jax_build_camera(js.cam, W, H)),
        IntegratorParams(assured_depth=3, max_bounces=24), W, H,
        jnp.asarray(flat % W), jnp.asarray(flat // W), jnp.int32(0), jnp.int32(SPP)))
    r = Renderer(ps, device="cpu", samples_per_launch=3)  # launches of 3 + 1 samples
    assert isinstance(r.tables, mk.MeshTables) and r.tables.route == "brute"
    img = r.render(samples=SPP)
    assert r.target.count == SPP and img.shape == (H, W, 3)
    assert_close(r.target.acc, ref, SPP)
    tile_gate(img, ref.reshape(H, W, 3) / SPP)
    assert img.mean() > 0.01


def test_resume_bitwise_exact(gltf_path, tmp_path):
    _, scheme = octa_schemes(gltf_path, W, H)
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


@pytest.mark.parametrize("change", [
    lambda s: s.scene_members.append(cfg.CubeMapMember(faces={})),
], ids=["cubemap"])
def test_unsupported_mesh_scenes_raise(gltf_path, change):
    _, scheme = octa_schemes(gltf_path, W, H)
    change(scheme)
    with pytest.raises(NotImplementedError):
        Renderer(scheme, device="cpu")


def _cpu_mode(s, mod, parse):
    s.render_info.use_gpu = False


def _debug_single_ray(s, mod, parse):
    """debug_single_ray, and an emissive sphere in front of the
    octahedra for the first hits to show (the scene's own emitter is out
    of the frame)."""
    s.render_info.rad_info.debug_single_ray = True
    s.scene_members.append(parse(mod.Tagged("Sphere", {
        "c": [-2.5, 1.2, -6.0], "r": 0.8, "coloring": mod.Tagged("Solid", [0, 0, 0]),
        "mat": {"divert_ray": "Diff", "emissive": [3.0, 3.0, 3.0]}})))


@pytest.mark.parametrize("change", [_cpu_mode, _debug_single_ray],
                         ids=["cpu-mode", "debug-single-ray"])
def test_wavefront_mesh_scenes_render(gltf_path, change):
    """Mesh scenes outside the mesh path kernel route to the wavefront
    (its mesh hits through `mesh_hit`), and the image agrees with the JAX
    package's sample_batch (its XLA cluster walk)."""
    js, ps = octa_schemes(gltf_path, W, H)
    change(js, jax_cfg, jax_cfg._parse_member)
    change(ps, cfg, cfg.parse_member)
    r = Renderer(ps, device="cpu", samples_per_launch=3)
    assert r.driver == "wavefront" and r.tables.mesh is not None
    img = r.render(samples=SPP)
    assert r.target.count == SPP and img.shape == (H, W, 3)
    flat = np.arange(W * H, dtype=np.int32)
    params = IntegratorParams(assured_depth=3, max_bounces=24, mode=r.mode,
                              debug_single_ray=r.params.debug_single_ray)
    ref = np.asarray(sample_batch(
        jax_build_scene(js), camera_to_arrays(jax_build_camera(js.cam, W, H)), params, W, H,
        jnp.asarray(flat % W), jnp.asarray(flat // W), jnp.int32(0), jnp.int32(SPP)))
    assert_close(r.target.acc, ref, SPP)
    tile_gate(img, ref.reshape(H, W, 3) / SPP)
    assert img.mean() > 0.01


def test_mesh_resume_bitwise_exact_cpu_semantics(gltf_path, tmp_path):
    _, scheme = octa_schemes(gltf_path, W, H)
    full = Renderer(scheme, device="cpu", mode="cpu")
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


def _model_yaml(tmp_path, gltf):
    yml = tmp_path / "mesh.yml"
    yml.write_text(
        "render_info: {width: 32, height: 16, samps_per_pix: 2,\n"
        "  rad_info: {russ_roull_info: {assured_depth: 3, max_thres: 0.5}}}\n"
        "cam: {d: [0, 0, 6], o: [0, 0, -14], up: [0, 1, 0], screen_width: 8, screen_height: 4}\n"
        "scene_members:\n"
        "- !Sphere {c: [0, 60, -30], r: 40, coloring: !Solid [0, 0, 0],\n"
        "   mat: {divert_ray: Diff, emissive: [2, 2, 2]}}\n"
        f"- !Model {{path: {os.path.basename(gltf)}, uniform_scale: 2.5,\n"
        "   translation: [0, 0, 0], euler_angles: [0.3, 0.5, 0]}\n")
    return yml


def test_cli_renders_model_scheme(tmp_path):
    from raytrace_tpu_torch import cli

    gltf = write_gltf(tmp_path / "oct.gltf", textured=True)  # resolved next to the scheme
    out = tmp_path / "out.png"
    cli.main([str(_model_yaml(tmp_path, gltf)), "no_ui", "--device", "cpu", "--out", str(out)])
    png = np.asarray(Image.open(out))
    assert png.shape == (16, 32, 4) and png[..., :3].max() > 0


def test_mesh_render_runs_without_jax(tmp_path):
    """A !Model scheme renders with neither jax, flax nor the JAX package
    imported (a subprocess: conftest imports jax in this one)."""
    write_gltf(tmp_path / "oct.gltf")
    yml = _model_yaml(tmp_path, tmp_path / "oct.gltf")
    code = (
        "import sys\n"
        "from raytrace_tpu_torch.models.config import load_scheme\n"
        "from raytrace_tpu_torch.render.renderer import Renderer\n"
        f"r = Renderer(load_scheme({str(yml)!r}), device='cpu')\n"
        "img = r.render(samples=2)\n"
        "assert r.scene.n_mesh_tris == 8 and img.shape == (16, 32, 3), (r.scene.n_mesh_tris, img.shape)\n"
        "assert (img >= 0).all() and img.max() < 1e3, img.max()\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'raytrace_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
