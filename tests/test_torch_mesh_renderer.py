"""Port parity for the mesh main path: raytrace_tpu_torch's Renderer on a
`!Model` scheme on the CPU (the plain torch version of the mesh kernel)
against the JAX package's sample_batch on the same pixels and sample
ids; mesh scenes outside the mesh path kernel through the wavefront;
a mesh scene with a cube map through the mesh kernel; exact resume; the
CLI on a `!Model` scheme; and that a mesh render runs without jax."""
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
from raytrace_tpu_torch.models.gltf import LoadedMesh, Primitive
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
    # 40 triangles, over the brute route's gate (MAX_BRUTE_TRIS): the walk
    assert isinstance(r.tables, mk.MeshTables) and r.tables.route == "walk"
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


def test_sky_mesh_scene_renders(gltf_path, tmp_path):
    """A mesh scene with a cube map takes mesh_trace (its plain version
    here); the image passes the tile gate against the wavefront's, and a
    resume is bitwise."""
    from test_torch_cubemap import add_sky, write_faces

    _, scheme = octa_schemes(gltf_path, W, H)
    add_sky(scheme, cfg, cfg.parse_member, write_faces(tmp_path))
    r = Renderer(scheme, device="cpu", samples_per_launch=3)
    assert r.driver == "mesh_fused" and r.tables.sky is not None
    img = r.render(samples=SPP)
    wave = Renderer(scheme, device="cpu", use_mesh_fused=False)
    assert wave.driver == "wavefront"
    tile_gate(img, wave.render(samples=SPP))
    assert img.mean() > 0.05
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


def _tiny_mesh_scheme(dir_light_samp):
    """The 24-triangle ring of `__graft_entry__._tiny_mesh` (:172) in front
    of an emissive sphere, in gpu semantics."""
    n = 24
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    v0 = np.stack([np.cos(th), np.sin(th), -6.0 + 0.1 * np.sin(3 * th)], -1)
    e1 = np.stack([-0.4 * np.sin(th), 0.4 * np.cos(th), np.zeros_like(th)], -1)
    e2 = np.random.default_rng(3).normal(0, 0.2, (n, 3)) + np.array([0, 0, 0.3])
    nn = np.cross(e1, e2)
    nn /= np.maximum(np.linalg.norm(nn, axis=1, keepdims=True), 1e-9)
    idx = np.stack([np.arange(n), np.arange(n) + n, np.arange(n) + 2 * n], 1).astype(np.int32)
    mesh = LoadedMesh(primitives=[Primitive(
        poses=np.concatenate([v0, v0 + e1, v0 + e2]).astype(np.float32),
        norms=np.concatenate([nn] * 3).astype(np.float32), indices=idx,
        rgb_factor=np.array([0.7, 0.5, 0.4], np.float32), metal_factor=0.3, rough_factor=0.5)],
        trans_mat=np.eye(4, dtype=np.float32))
    s = cfg.parse_scheme({
        "render_info": {"width": 32, "height": 32, "samps_per_pix": 4, "use_gpu": True,
                        "rad_info": {"dir_light_samp": dir_light_samp,
                                     "russ_roull_info": {"assured_depth": 2, "max_thres": 0.5}}},
        "cam": {"d": [0, 0, -4.0], "o": [0, 0, 0], "up": [0, 1, 0], "view_eulers": [0, 0, 0],
                "screen_width": 6.0, "screen_height": 6.0},
        "scene_members": [cfg.Tagged("Sphere", {
            "c": [1.8, 1.8, -6.0], "r": 1.5, "coloring": cfg.Tagged("Solid", [0, 0, 0]),
            "mat": {"divert_ray": "Diff", "emissive": [4, 4, 4]}})],
    })
    s.scene_members.append(cfg.ModelMember(path="<tiny>", loaded=[mesh]))
    return s


def test_gpu_mesh_scene_with_dls_takes_the_mesh_kernel():
    """A gpu-semantics mesh scheme with dir_light_samp takes the mesh path
    kernel (`mk.supports` has no DLS clause, unlike the JAX
    fused_mesh.supports, which sends it to the wavefront): direct-light
    sampling runs in cpu semantics only, so the image is the one without
    DLS, bit for bit, and agrees with the wavefront's under the tile gate
    (scripts/hw_parity.py)."""
    fused = Renderer(_tiny_mesh_scheme(True), device="cpu")
    assert fused.driver == "mesh_fused" and fused.params.dir_light_samp
    img = fused.render(samples=SPP)
    wave = Renderer(_tiny_mesh_scheme(True), device="cpu", use_mesh_fused=False)
    assert wave.driver == "wavefront"
    ref = wave.render(samples=SPP)
    tile_gate(img, ref)
    no_dls = Renderer(_tiny_mesh_scheme(False), device="cpu")
    assert no_dls.driver == "mesh_fused"
    np.testing.assert_array_equal(no_dls.render(samples=SPP), img)
    assert img.mean() > 0.01


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
