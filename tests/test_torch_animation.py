"""Port parity for keyframe animation: the 18 easings bit-equal to the JAX
package's on a grid of t, `sample_sequence`, `last_timestamp` and
`extract_frames` on a scheme with an animated sphere and an animated glTF
model (each frame's build_scene arrays equal to the JAX build's), the
animation YAML parse, an in-memory model (`ModelMember.loaded`) placed and
animated as the same mesh from its file is, and the procedural animated
schemes."""
import dataclasses

import numpy as np
import pytest

from raytrace_tpu.models import animation as jax_anim
from raytrace_tpu.models import config as jax_cfg
from raytrace_tpu.models.scene import build_scene as jax_build_scene
from raytrace_tpu.ops.pallas import trace_kernel as jax_tk
from raytrace_tpu_torch.models import animation as anim
from raytrace_tpu_torch.models import config as cfg
from raytrace_tpu_torch.models import gltf, procedural
from raytrace_tpu_torch.models.scene import build_scene
from raytrace_tpu_torch.ops import trace_kernel as tk
from test_torch_mesh_scene import _assert_scene_equal, write_gltf

GRID = np.concatenate([np.linspace(-0.25, 1.25, 601), [0.5 - 1e-7, 0.5, 0.5 + 1e-7, 1e-9]])


def test_easing_names_match():
    assert list(anim.EASING) == list(jax_anim.EASING) and len(anim.EASING) == 18


@pytest.mark.parametrize("name", list(jax_anim.EASING))
def test_easing_bit_equal(name):
    ours = np.array([anim.ease(name, t) for t in GRID], np.float64)
    ref = np.array([jax_anim.ease(name, t) for t in GRID], np.float64)
    np.testing.assert_array_equal(ours.view(np.uint64), ref.view(np.uint64))
    assert ours[GRID <= 0].max() <= 1e-12 or name == "Hold"


def test_unknown_easing_raises():
    with pytest.raises(ValueError):
        anim.ease("EaseInSine", 0.5)


def _yaml(path, gltf_path):
    path.write_text(
        "render_info: {width: 64, height: 32, samps_per_pix: 2, animation: true,\n"
        "  framerate: 6, anim_pipeline_depth: 3,\n"
        "  rad_info: {russ_roull_info: {assured_depth: 3, max_thres: 0.5}}}\n"
        "cam: {d: [0, 0, 6], o: [0, 0, -14], up: [0, 1, 0], screen_width: 8, screen_height: 4}\n"
        "scene_members:\n"
        "- !Sphere {c: [0, 60, -30], r: 40, coloring: !Solid [0, 0, 0],\n"
        "   mat: {divert_ray: Diff, emissive: [2, 2, 2]}}\n"
        "- !Sphere {c: [2.5, -1, -3], r: 1, coloring: !Solid [0.9, 0.9, 0.9],\n"
        "   mat: {divert_ray: Spec},\n"
        "   animation: {keyframes: [\n"
        "     {translation: [2.5, -1, -3], time: 0.0, ease_type: EaseIn},\n"
        "     {translation: [1.0, 0.5, -2], time: 0.5, ease_type: EaseOutQuint},\n"
        "     {translation: [-1.0, 0.0, -4], time: 1.0}]}}\n"
        f"- !Model {{path: {gltf_path}, uniform_scale: 0.9, translation: [0, 0, 0],\n"
        "   euler_angles: [0, 0, 0],\n"
        "   animation: {keyframes: [\n"
        "     {translation: [-1, 0, 0], euler_angles: [0, 0.2, 0], time: 0.0,\n"
        "      ease_type: EaseInOutCubic},\n"
        "     {translation: [1, 0.5, 0], euler_angles: [0.3, 0.9, 0.1], time: 0.75},\n"
        "     {translation: [2, 0.5, 1], time: 1.25, ease_type: Step}]}}\n")
    return str(path)


@pytest.fixture(scope="module")
def animated(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("anim")
    yml = _yaml(tmp / "anim.yml", write_gltf(tmp / "m.gltf", textured=True))
    return jax_cfg.load_scheme(yml), cfg.load_scheme(yml)


def test_animation_parse_matches_jax(animated):
    js, ps = animated
    ji, pi = js.render_info, ps.render_info
    assert (pi.animation, pi.framerate, pi.anim_pipeline_depth) == \
        (ji.animation, ji.framerate, ji.anim_pipeline_depth) == (True, 6.0, 3)
    for jm, pm in zip(js.scene_members, ps.scene_members):
        ja, pa = jm.animation, pm.animation
        assert (ja is None) == (pa is None)
        if ja is None:
            continue
        assert len(pa.keyframes) == len(ja.keyframes)
        for jk, pk in zip(ja.keyframes, pa.keyframes):
            assert (pk.time, pk.ease_type) == (jk.time, jk.ease_type)
            np.testing.assert_array_equal(pk.translation, jk.translation)
            assert pk.translation.dtype == jk.translation.dtype == np.float32
            if jk.euler_angles is None:
                assert pk.euler_angles is None
            else:
                np.testing.assert_array_equal(pk.euler_angles, jk.euler_angles)
    # the last keyframe's easing defaults to EaseInOut
    assert ps.scene_members[1].animation.keyframes[-1].ease_type == "EaseInOut"


def test_sample_sequence_and_last_timestamp_match_jax(animated):
    js, ps = animated
    assert anim.last_timestamp(ps) == jax_anim.last_timestamp(js) == 1.25
    for jm, pm in zip(js.scene_members[1:], ps.scene_members[1:]):
        kfs, jkfs = pm.animation.keyframes, jm.animation.keyframes
        values = np.stack([k.translation for k in kfs])
        for t in np.linspace(-0.2, 1.5, 86):
            np.testing.assert_array_equal(anim.sample_sequence(kfs, values, t),
                                          jax_anim.sample_sequence(jkfs, values, t))


def test_extract_frames_match_jax(animated):
    """floor(1.25 s x 6) = 7 frames; each frame's members and scene arrays
    (spheres packed as the kernel packs them, the mesh and its clusters)
    equal to the JAX build's."""
    js, ps = animated
    frames, jframes = anim.extract_frames(ps, 6.0), jax_anim.extract_frames(js, 6.0)
    assert len(frames) == len(jframes) == 7
    for f, jf in zip(frames, jframes):
        assert f.render_info is ps.render_info  # frames share the scheme's render info
        np.testing.assert_array_equal(f.scene_members[1].c, jf.scene_members[1].c)
        for k in ("translation", "euler_angles"):
            np.testing.assert_array_equal(getattr(f.scene_members[2], k),
                                          getattr(jf.scene_members[2], k))
        scene, jscene = build_scene(f), jax_build_scene(jf)
        _assert_scene_equal(scene, jscene)
        for ours, ref in zip(tk.pack_scene_tables(scene), jax_tk.pack_scene_tables(jscene)):
            np.testing.assert_array_equal(ours, ref)
    moved = [f.scene_members[1].c.tolist() for f in frames]
    assert len({tuple(c) for c in moved}) == 7  # the sphere moves every frame
    assert ps.scene_members[1].c.tolist() == [2.5, -1.0, -3.0]  # the scheme is not changed


def test_loaded_model_animates_as_its_file(tmp_path):
    """A ModelMember whose meshes are in memory (`loaded`, as the
    procedural a380-class surface) is placed by its translation, scale and
    Euler angles as the same mesh loaded from its file: the same scene
    arrays up to the f64 products' rounding; the identity placement keeps
    the meshes themselves."""
    path = write_gltf(tmp_path / "m.gltf", textured=True, normal_map=True)
    base = gltf.load_model(path, np.zeros(3), 1.0, np.zeros(3))
    assert gltf.place_meshes(base, np.zeros(3, np.float32), 1.0, np.zeros(3)) is base
    place = dict(translation=np.array([1.0, -0.5, 2.0], np.float32), uniform_scale=0.7,
                 euler_angles=np.array([0.3, -0.4, 0.2], np.float32))
    file_scheme = procedural.a380_cam_scheme(32, 16, 1)
    mem_scheme = procedural.a380_cam_scheme(32, 16, 1)
    file_scheme.scene_members.append(cfg.ModelMember(path=path, **place))
    mem_scheme.scene_members.append(cfg.ModelMember(path="<in memory>", loaded=base, **place))
    a, b = build_scene(file_scheme), build_scene(mem_scheme)
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, np.ndarray) and x.dtype.kind == "f":
            np.testing.assert_allclose(y, x, rtol=1e-5, atol=1e-5, err_msg=f.name)
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(y, x, err_msg=f.name)


def test_procedural_animations():
    """The animated walled and a380-class schemes: framerate frames over
    one second, their keyframed members moving, a frame's scene built."""
    walled = procedural.animated_walled_scheme(64, 32, 2, framerate=8)
    frames = anim.extract_frames(walled, walled.render_info.framerate)
    assert len(frames) == 8 and walled.render_info.animation
    eases = {k.ease_type for m in walled.scene_members[1:3] for k in m.animation.keyframes}
    assert {"EaseInOut", "EaseInCubic", "Step", "Hold"} <= eases
    assert len({tuple(f.scene_members[1].c) for f in frames}) == 8
    a380 = procedural.animated_a380_scheme(64, 32, 2, framerate=4,
                                           mesh=procedural.make_mesh(512, n_textures=0))
    frames = anim.extract_frames(a380, 4.0)
    assert len(frames) == 4
    v0 = [build_scene(f).mt_v0 for f in frames]
    assert all(not np.array_equal(v0[0], v) for v in v0[1:])
    assert frames[0].scene_members[-1].loaded is frames[3].scene_members[-1].loaded
