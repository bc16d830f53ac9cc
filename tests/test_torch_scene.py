"""Port parity: scheme parsing, scene arrays, packed tables and camera
vector of raytrace_tpu_torch against raytrace_tpu. Also holds the scene
builders that the other test_torch_* files share."""
import dataclasses

import numpy as np
import pytest

from __graft_entry__ import _inline_walled_scheme
from raytrace_tpu.models import config as jax_cfg
from raytrace_tpu.models.camera import build_camera as jax_build_camera
from raytrace_tpu.models.scene import build_scene as jax_build_scene
from raytrace_tpu.ops.pallas import trace_kernel as jax_tk
from raytrace_tpu_torch.models import config as cfg
from raytrace_tpu_torch.models.camera import build_camera
from raytrace_tpu_torch.models.scene import SceneArrays, build_scene, from_reference
from raytrace_tpu_torch.models.walled import walled_scheme
from raytrace_tpu_torch.ops import trace_kernel as tk


def _mixed_members(mod):
    """tests/test_pallas.py:203-218: spheres + free triangles, two
    dielectrics with different n, two DiffSpecs with different diffp, an
    emissive sphere and an emissive triangle."""
    def sphere(c, r, rgb, mat):
        return mod.Tagged("Sphere", {"c": c, "r": r, "coloring": mod.Tagged("Solid", rgb), "mat": mat})

    def tri(verts, norm, rgb, mat):
        return mod.Tagged("FreeTriangle", {"verts": verts, "norm": norm, "rgb": rgb, "mat": mat})

    return [
        sphere([0.0, 0.0, -6.0], 1.0, [0.9, 0.9, 0.9],
               {"divert_ray": mod.Tagged("Dielectric", {"n_out": 1.0, "n_in": 1.5})}),
        sphere([2.5, 0.0, -7.0], 1.0, [0.9, 0.6, 0.6],
               {"divert_ray": mod.Tagged("Dielectric", {"n_out": 1.0, "n_in": 1.2})}),
        sphere([0.0, 6.0, -8.0], 2.0, [0, 0, 0], {"divert_ray": "Diff", "emissive": [8, 8, 8]}),
        tri([[-4, -2, -9], [4, -2, -9], [0, -2, -1]], [0, 1, 0], [0.7, 0.7, 0.3],
            {"divert_ray": mod.Tagged("DiffSpec", {"diffp": 0.4})}),
        tri([[-4, 2, -9], [4, 2, -9], [0, 3, -4]], [0, -1, 0], [0.3, 0.7, 0.7],
            {"divert_ray": mod.Tagged("DiffSpec", {"diffp": 0.8})}),
        tri([[-1, -1, -3], [1, -1, -3], [0, 1, -3]], [0, 0, 1], [1, 1, 1],
            {"divert_ray": "Spec", "emissive": [2, 2, 2]}),
    ]


def schemes(name, width, height, assured):
    """(JAX scheme, port scheme) of the walled or the mixed scene."""
    js = _inline_walled_scheme(width, height, assured=assured)
    ps = walled_scheme(width, height, assured=assured)
    if name == "mixed":
        js.scene_members = [jax_cfg._parse_member(m) for m in _mixed_members(jax_cfg)]
        ps.scene_members = [cfg.parse_member(m) for m in _mixed_members(cfg)]
    return js, ps


def reference_fields(jscene):
    return {f.name: np.asarray(getattr(jscene, f.name)) for f in dataclasses.fields(jscene)}


SCENES = ["walled", "mixed"]


@pytest.mark.parametrize("name", SCENES)
def test_build_scene_matches_jax(name):
    js, ps = schemes(name, 64, 32, 2)
    jscene, scene = jax_build_scene(js), build_scene(ps)
    for f in dataclasses.fields(SceneArrays):
        if f.name.startswith("inst_cl_"):  # the port's own (the JAX scene packs them
            assert getattr(scene, f.name).shape[0] == 0, f.name  # into mk_*): no instancing
            continue
        ours, ref = getattr(scene, f.name), getattr(jscene, f.name)
        if isinstance(ours, np.ndarray):
            assert ours.dtype == np.asarray(ref).dtype, f.name
            np.testing.assert_array_equal(ours, np.asarray(ref), err_msg=f.name)
        else:
            assert ours == ref, f.name
    # and through the reference's own arrays
    via_ref = from_reference(reference_fields(jscene))
    for f in dataclasses.fields(SceneArrays):
        np.testing.assert_array_equal(getattr(via_ref, f.name), getattr(scene, f.name), err_msg=f.name)


@pytest.mark.parametrize("name", SCENES)
@pytest.mark.parametrize("lens_r", [None, 0.2])
def test_tables_and_cam_vec_bit_equal(name, lens_r):
    js, ps = schemes(name, 64, 32, 2)
    js.cam.lens_r = ps.cam.lens_r = lens_r
    jsph, jft = jax_tk.pack_scene_tables(jax_build_scene(js))
    sph, ft = tk.pack_scene_tables(build_scene(ps))
    for ours, ref in ((sph, jsph), (ft, jft)):
        assert ours.dtype == ref.dtype and ours.shape == ref.shape
        np.testing.assert_array_equal(ours.view(np.uint32), ref.view(np.uint32))
    jcv = jax_tk.make_cam_vec(jax_build_camera(js.cam, 64, 32), 0.5)
    cv = tk.make_cam_vec(build_camera(ps.cam, 64, 32), 0.5)
    np.testing.assert_array_equal(cv.view(np.uint32), jcv.view(np.uint32))


def test_load_scheme_matches_jax(tmp_path):
    yml = tmp_path / "s.yml"
    yml.write_text(
        "render_info: {width: 40, height: 20, samps_per_pix: 3, gpu_render_batch: 2,\n"
        "  rad_info: {russ_roull_info: {assured_depth: 3, max_thres: 0.6}}}\n"
        "cam: {d: [0, 0, -4], o: [0, 0, 1], up: [0, 2, 0], view_eulers: [0.1, 0.2, 0.3],\n"
        "  screen_width: 8, screen_height: 4, lens_r: 0.1}\n"
        "scene_members:\n"
        "- !Sphere {c: [0, 0, -5], r: 1, coloring: !Solid [0.5, 0.5, 0.5], mat: {divert_ray: Diff}}\n"
        "- !FreeTriangle {verts: [[0, 0, -3], [1, 0, -3], [0, 1, -3]], norm: [0, 0, 2], rgb: [1, 0, 0],\n"
        "   mat: {divert_ray: !Dielectric {n_out: 1.0, n_in: 1.4}, emissive: [1, 1, 1]}}\n")
    js, ps = jax_cfg.load_scheme(str(yml)), cfg.load_scheme(str(yml))
    ji, pi = js.render_info, ps.render_info
    assert (pi.width, pi.height, pi.samps_per_pix, pi.render_batch, pi.use_gpu) == \
        (ji.width, ji.height, ji.samps_per_pix, ji.render_batch, ji.use_gpu)
    prr, jrr = pi.rad_info.russ_roull_info, ji.rad_info.russ_roull_info
    assert (prr.assured_depth, prr.max_thres) == (jrr.assured_depth, jrr.max_thres) == (3, 0.6)
    jc, pc = jax_build_camera(js.cam, 40, 20), build_camera(ps.cam, 40, 20)
    for k in ("o", "d", "up", "right"):
        np.testing.assert_array_equal(getattr(pc, k), getattr(jc, k))
    for k in ("x_cf", "y_cf", "x_off", "y_off", "lens_r"):
        assert getattr(pc, k) == getattr(jc, k)
    for ours, ref in zip(tk.pack_scene_tables(build_scene(ps)),
                         jax_tk.pack_scene_tables(jax_build_scene(js))):
        np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("member", [
    # every member kind of the reference is ported (animated models too:
    # tests/test_torch_animation.py); what neither package knows is refused
    cfg.Tagged("Light", {"c": [0, 0, 0]}),
    cfg.Tagged("Sphere", {"c": [0, 0, -5], "r": 1.0, "coloring": cfg.Tagged("Texture", "t.png"),
                          "mat": {"divert_ray": "Diff"}}),
])
def test_build_scene_rejects_unported_members(member):
    scheme = walled_scheme(32, 16)
    with pytest.raises(ValueError):
        scheme.scene_members.append(cfg.parse_member(member))
        build_scene(scheme)


def test_build_scene_takes_cube_map(tmp_path):
    """The walled scheme with a !DistantCubeMap member: every SceneArrays
    field equals the JAX build's, the sky's among them, and the packed
    tables stay those of the scene without it."""
    from test_torch_cubemap import add_sky, write_faces

    value = write_faces(tmp_path)
    js, ps = schemes("walled", 64, 32, 2)
    add_sky(js, jax_cfg, jax_cfg._parse_member, value)
    add_sky(ps, cfg, cfg.parse_member, value)
    jscene, scene = jax_build_scene(js), build_scene(ps)
    assert scene.has_cubemap and scene.cm_dims.min() > 0
    for f in dataclasses.fields(SceneArrays):
        if f.name.startswith("inst_cl_"):  # the port's own (the JAX scene packs them
            assert getattr(scene, f.name).shape[0] == 0, f.name  # into mk_*): no instancing
            continue
        ours, ref = getattr(scene, f.name), getattr(jscene, f.name)
        if isinstance(ours, np.ndarray):
            assert ours.dtype == np.asarray(ref).dtype, f.name
            np.testing.assert_array_equal(ours, np.asarray(ref), err_msg=f.name)
        else:
            assert ours == ref, f.name
    plain = build_scene(schemes("walled", 64, 32, 2)[1])
    for ours, ref in zip(tk.pack_scene_tables(scene), tk.pack_scene_tables(plain)):
        np.testing.assert_array_equal(ours, ref)


def test_from_reference_rejects_mesh():
    """Meshes are carried across now; mesh fields that do not hold
    n_mesh_tris rows are rejected."""
    js, _ = schemes("walled", 32, 16, 2)
    fields = reference_fields(jax_build_scene(js))
    fields["n_mesh_tris"] = np.asarray(12)
    with pytest.raises(ValueError):
        from_reference(fields)
