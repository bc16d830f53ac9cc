"""Port parity for the differentiable tier: the port's gradients (torch
autograd through `renderer.sample_batch` with
`IntegratorParams(differentiable=True)`, a `SceneTensors.replace` view
and a tensor camera) against `jax.grad` of the JAX package's
`sample_batch` on the same pixels, sample ids and loss, for every field
of `DIFF_SCENE_FIELDS` a scene holds and the camera's o, d, up, right.

The loss is sum(radiance sums * w), w uniform in [0, 1) from a seed. The
JAX side differentiates one dict of every field (its split_diff_scene's,
plus mt_attr) once per case, with `use_clusters=False` on the mesh cases
(its chunked mesh hit: its cluster walk reads copies of the vertices,
and gives them no gradient). The port's mt_const_norm / mt_rgb_factor
are held against the JAX gradient of mt_attr's columns 0:3 / 13:16,
which its shading reads.

Gate: relative L2 <= 1e-3 per field, and exactly 0 where the JAX
gradient is 0. Scenes: test_diff.py's spheres (48x24, both semantics),
test_parallel.py's scheme with its DiffSpec free triangle (gpu; cpu with
direct-light sampling), the textured, normal-mapped octahedra under a
sky (gpu) and a textured floor of two mesh triangles under a sky, lit by
a near emitter (cpu with direct-light sampling, where the mesh vertices
and the shading normal take gradients), the mesh cases at assured depth
5 (test_torch_integrator.py: self-hits decided by ulps flip at 2).

Also: the differentiable forward bitwise the forward render; the loop's
all-dead exit bitwise the full max_depth loop, image and gradients;
central differences on the port against its gradient (a free-triangle
vertex, a mesh vertex, the camera's o and d, a texel), each asserting
that no lane's hit kind or id, and no texel fetched, changes at +-eps; the drivers that refuse
a differentiable render; and the JAX package's two mesh-gradient faults
(ROADMAP queue 3)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raytrace_tpu.models import config as jax_cfg
from raytrace_tpu.models.camera import build_camera as jax_build_camera
from raytrace_tpu.models.scene import build_scene as jax_build_scene
from raytrace_tpu.parallel.distributed import split_diff_scene as jax_split_diff_scene
from raytrace_tpu.render.integrator import IntegratorParams as JaxParams
from raytrace_tpu.render.renderer import camera_to_arrays as jax_camera_to_arrays
from raytrace_tpu.render.renderer import sample_batch as jax_sample_batch
from raytrace_tpu_torch.models import config as cfg
from raytrace_tpu_torch.models.camera import build_camera
from raytrace_tpu_torch.models.gltf import LoadedMesh, Primitive, TextureData
from raytrace_tpu_torch.models.scene import SceneTensors, from_reference
from raytrace_tpu_torch.models.walled import walled_scheme
from raytrace_tpu_torch.ops import cubemap, texture
from raytrace_tpu_torch.ops.raygen import camera_to_arrays
from raytrace_tpu_torch.parallel.distributed import DIFF_SCENE_FIELDS, split_diff_scene
from raytrace_tpu_torch.render import integrator as itg
from raytrace_tpu_torch.render import renderer as rnd
from raytrace_tpu_torch.render.integrator import IntegratorParams
from raytrace_tpu_torch.render.renderer import Renderer, sample_batch
from raytrace_tpu_torch.render.wavefront import wavefront_batch
from test_diff import _scheme as spheres_scheme
from test_parallel import _tiny_scheme as freetri_scheme
from test_torch_cubemap import add_sky, write_faces
from test_torch_mesh_scene import jax_build_with_mesh, octa_schemes, write_gltf
from test_torch_scene import reference_fields

W, H, SPP, MAX_BOUNCES = 48, 24, 2, 6
RTOL = 1e-3  # relative L2 per field
CAM_FIELDS = ("o", "d", "up", "right")
CASES = {  # name: (scene, IntegratorParams fields)
    "spheres-gpu": ("spheres", dict(mode="gpu", assured_depth=2)),
    "spheres-cpu": ("spheres", dict(mode="cpu", assured_depth=2)),
    "freetri-gpu": ("freetri", dict(mode="gpu", assured_depth=2)),
    "freetri-cpu-dls": ("freetri", dict(mode="cpu", assured_depth=2, dir_light_samp=True)),
    "octahedra-sky-gpu": ("octahedra-sky", dict(mode="gpu", assured_depth=5)),
    "floor-cpu-dls": ("floor", dict(mode="cpu", assured_depth=5, dir_light_samp=True)),
}
# the untextured floor without a sky, for the mesh vertex's central difference
# alone: a vertex moves the barycentrics of every hit, and so the texel of some
FD_CASES = {"plain-floor-cpu-dls": ("plain-floor", CASES["floor-cpu-dls"][1])}
SPH = ("sph_c", "sph_r", "sph_rgb", "sph_emissive")
FT = ("ft_v0", "ft_e1", "ft_e2", "ft_norm", "ft_rgb", "ft_emissive")
MT = ("mt_v0", "mt_e1", "mt_e2", "mt_const_norm", "mt_rgb_factor", "tex_pool", "sky_pool")
SCENE_FIELDS = {"spheres": SPH, "freetri": SPH + FT, "octahedra-sky": SPH + FT + MT,
                "floor": SPH + MT}
# fields whose JAX gradient must be non-zero, so that the comparison holds something
NONZERO = {
    "spheres-gpu": ("sph_rgb", "sph_emissive"),
    "spheres-cpu": SPH + CAM_FIELDS,
    "freetri-gpu": ("sph_rgb", "sph_emissive", "ft_rgb"),
    "freetri-cpu-dls": SPH + ("ft_v0", "ft_e1", "ft_e2", "ft_norm", "ft_rgb") + CAM_FIELDS,
    "octahedra-sky-gpu": ("sph_rgb", "sph_emissive", "ft_rgb", "mt_rgb_factor", "tex_pool",
                          "sky_pool"),
    "floor-cpu-dls": SPH + MT + CAM_FIELDS,
}


def floor_mesh(textured=True):
    """Two mesh triangles, a slightly warped floor, with an 8x8 u8 base
    colour texture: constant shading normals (no normal map)."""
    g = np.random.default_rng(5)
    poses = np.array([[-6, 0.0, 2], [6, 0.2, 2], [6, -0.1, -12], [-6, 0.1, -12]], np.float32)
    norms = np.tile(np.array([[0.02, 1.0, -0.01]], np.float32), (4, 1))
    raw = g.integers(40, 256, (8, 8, 3), dtype=np.uint8)
    tex = TextureData(pixels=raw.astype(np.float32) / 255.0, pixels_raw=raw,
                      coords=np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32))
    return LoadedMesh(primitives=[Primitive(
        poses=poses, norms=norms, indices=np.array([[0, 1, 2], [0, 2, 3]], np.int32),
        rgb_factor=np.array([0.8, 0.75, 0.7], np.float32), rgb_tex=tex if textured else None,
        metal_factor=0.2, rough_factor=0.6)], trans_mat=np.eye(4, dtype=np.float32))


def floor_scheme():
    """The floor under a diffuse, a dielectric and a near emissive sphere
    (JAX scheme; the mesh is added by jax_build_with_mesh)."""
    def sphere(c, r, rgb, mat):
        return jax_cfg.Tagged("Sphere", {"c": c, "r": r, "coloring": jax_cfg.Tagged("Solid", rgb),
                                         "mat": mat})

    raw = {
        "render_info": {
            "width": W, "height": H, "samps_per_pix": SPP,
            "rad_info": {"debug_single_ray": False, "dir_light_samp": True,
                         "russ_roull_info": {"assured_depth": 5, "max_thres": 0.5}},
            "use_gpu": False},
        "cam": {"d": [0, -1.5, -6], "o": [0, 2.5, 4], "up": [0, 1, 0], "view_eulers": [0, 0, 0],
                "screen_width": 8.0, "screen_height": 4.0},
        "scene_members": [
            sphere([2.0, 3.0, -4.0], 0.8, [0, 0, 0], {"divert_ray": "Diff", "emissive": [20, 20, 20]}),
            sphere([-1.0, 0.9, -5.0], 1.0, [0.8, 0.6, 0.5], {"divert_ray": "Diff"}),
            sphere([1.6, 0.6, -6.0], 0.6, [0.9, 0.9, 0.9],
                   {"divert_ray": jax_cfg.Tagged("Dielectric", {"n_out": 1.0, "n_in": 1.5})}),
        ],
    }
    return jax_cfg.parse_scheme(raw)


def build_jax_scene(name, tmp):
    """(JAX SceneArrays, JAX scheme) of a scene name of CASES."""
    if name == "spheres":
        js = spheres_scheme()
    elif name == "freetri":
        js = freetri_scheme()
    elif name == "octahedra-sky":
        js, _ = octa_schemes(write_gltf(tmp / "m.gltf", textured=True, normal_map=True), W, H)
        add_sky(js, jax_cfg, jax_cfg._parse_member, write_faces(tmp))
    else:
        js = floor_scheme()
        if name == "floor":
            add_sky(js, jax_cfg, jax_cfg._parse_member, write_faces(tmp))
        return jax_build_with_mesh(js, floor_mesh(textured=name == "floor")), js
    return jax_build_scene(js), js


def pixels():
    flat = np.arange(W * H, dtype=np.int32)
    return flat % W, flat // W


def weights():
    return np.random.default_rng(0).uniform(0.0, 1.0, (W * H, 3)).astype(np.float32)


def jax_grads(jscene, js, kw, use_clusters=False, only=None):
    """jax.grad of the loss over every field of the JAX split_diff_scene
    (with mt_attr) and the camera; `only` names one field to take alone.
    Returns (field grads, camera grads)."""
    diff, _ = jax_split_diff_scene(jscene)
    diff["mt_attr"] = jscene.mt_attr
    if only is not None:
        diff = {only: diff[only]}
    xs, ys = (jnp.asarray(a) for a in pixels())
    params = JaxParams(differentiable=True, use_clusters=use_clusters, max_bounces=MAX_BOUNCES,
                       **kw)

    def loss(d, cam):
        acc = jax_sample_batch(jscene.replace(**d), cam, params, W, H, xs, ys, jnp.int32(0), SPP)
        return jnp.sum(acc * weights())

    cam = jax_camera_to_arrays(jax_build_camera(js.cam, W, H))
    g, gc = jax.grad(loss, argnums=(0, 1))(diff, cam)
    return {k: np.asarray(v) for k, v in g.items()}, {k: np.asarray(getattr(gc, k))
                                                     for k in CAM_FIELDS}


def port_scene(jscene, js):
    return SceneTensors(from_reference(reference_fields(jscene)), build_camera(js.cam, W, H),
                        0.5)


def port_params(kw, differentiable=True):
    return IntegratorParams(differentiable=differentiable, max_bounces=MAX_BOUNCES, **kw)


def port_render(scene, js, kw, leaves=None, cam_leaves=None, differentiable=True):
    """The port's sample_batch over every pixel; leaves (field -> tensor)
    replace the scene's fields, cam_leaves the camera's tensors."""
    xs, ys = (torch.from_numpy(a) for a in pixels())
    sc = scene.replace(**leaves) if leaves else scene
    cam = dataclasses.replace(camera_to_arrays(build_camera(js.cam, W, H), "cpu"),
                              **(cam_leaves or {}))
    return sample_batch(sc, port_params(kw, differentiable), xs, ys, 0, SPP, cam=cam)


def port_grads(scene, js, kw):
    """(image, field grads, camera grads) of the port's loss."""
    diff, _ = split_diff_scene(scene)
    leaves = {k: v.requires_grad_() for k, v in diff.items()}
    cam = camera_to_arrays(build_camera(js.cam, W, H), "cpu")
    cam_leaves = {k: getattr(cam, k).requires_grad_() for k in CAM_FIELDS}
    out = port_render(scene, js, kw, leaves, cam_leaves)
    (out * torch.from_numpy(weights())).sum().backward()
    grad = lambda t: t.grad if t.grad is not None else torch.zeros_like(t)
    return (out.detach(), {k: grad(v) for k, v in leaves.items()},
            {k: grad(v) for k, v in cam_leaves.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """case -> dict: the JAX scene and scheme, the port scene, the port's
    image and gradients, and `jax()`, the JAX gradients; each computed
    once, when first asked for."""
    scenes, cache = {}, {}

    def get(case):
        if case not in cache:
            name, kw = {**CASES, **FD_CASES}[case]
            if name not in scenes:
                jscene, js = build_jax_scene(name, tmp_path_factory.mktemp(name))
                scenes[name] = (jscene, js, port_scene(jscene, js))
            jscene, js, scene = scenes[name]
            img, grads, cam_grads = port_grads(scene, js, kw)
            run = cache[case] = dict(jscene=jscene, js=js, scene=scene, kw=kw, img=img,
                                     grads=grads, cam_grads=cam_grads)
            run["jax"] = functools.cache(lambda: jax_grads(jscene, js, kw))
        return cache[case]

    return get


def jax_field(run, field):
    """The JAX gradient of `field` over the port's rows (the JAX package
    pads spheres and free triangles to 8 rows and the mesh to 2,048)."""
    g, gc = run["jax"]()
    if field in CAM_FIELDS:
        return gc[field]
    n = run["grads"][field].shape[0]
    cols = {"mt_const_norm": slice(0, 3), "mt_rgb_factor": slice(13, 16)}
    if field in cols:
        return g["mt_attr"][:n, cols[field]]
    return g[field][:n]


def rel_l2(ours, ref):
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(ours - ref) / np.linalg.norm(ref))


FIELD_CASES = [(c, f) for c, (name, _) in CASES.items() for f in SCENE_FIELDS[name] + CAM_FIELDS]


@pytest.mark.parametrize("case,field", FIELD_CASES, ids=[f"{c}-{f}" for c, f in FIELD_CASES])
def test_grad_matches_jax(runs, case, field):
    run = runs(case)
    ours = (run["cam_grads"] if field in CAM_FIELDS else run["grads"])[field].numpy()
    ref = jax_field(run, field)
    assert ours.shape == ref.shape and np.isfinite(ours).all()
    if not np.abs(ref).max(initial=0.0):
        assert not np.abs(ours).max(initial=0.0), f"{field}: JAX gives 0, the port does not"
    else:
        assert rel_l2(ours, ref) <= RTOL, f"{field}: relative L2 {rel_l2(ours, ref):.3e}"


@pytest.mark.parametrize("case", list(CASES))
def test_gradients_reach_the_fields(runs, case):
    """The comparisons above hold non-zero gradients where a scene has them."""
    run = runs(case)
    zero = [f for f in NONZERO[case] if not np.abs(jax_field(run, f)).max()]
    assert not zero, f"JAX gradients of {zero} are 0"


@pytest.mark.parametrize("case", list(CASES))
def test_differentiable_forward_is_the_forward_render(runs, case):
    run = runs(case)
    plain = port_render(run["scene"], run["js"], run["kw"], differentiable=False)
    assert torch.equal(run["img"], plain)


def _full_loop(scene, params, ro, rd, state):
    """trace_paths without its all-dead exit: max_depth bounces always."""
    st = itg.init_lanes(scene, params, ro, rd, state)
    for _ in range(itg.max_depth(params)):
        st = itg._bounce_step(scene, params, st)
    if itg.tracks_miss(scene, params):
        return itg.resolve_sky(scene, st["L"], st["miss_d"], st["miss_w"]), st["rng"]
    return st["L"], st["rng"]


@pytest.mark.parametrize("case", ["spheres-cpu", "octahedra-sky-gpu", "floor-cpu-dls"])
def test_all_dead_exit_is_bitwise_the_full_loop(runs, case, monkeypatch):
    run = runs(case)
    monkeypatch.setattr(rnd, "trace_paths", _full_loop)
    img, grads, cam_grads = port_grads(run["scene"], run["js"], run["kw"])
    assert torch.equal(img, run["img"])
    for k, g in {**grads, **cam_grads}.items():
        assert torch.equal(g, {**run["grads"], **run["cam_grads"]}[k]), k


# --- central differences on the port ---------------------------------------


def _loss_and_hits(run, field, index, value, monkeypatch):
    """The loss in f64 with field[index] = value, and the (kind, idx) of
    every closest_hit call of the render (shadow rays too) and the texel
    of every texture and sky fetch."""
    hits = []
    real_hit, real_texel = itg.closest_hit, texture.nearest_texel

    def record_hit(*a, **k):
        out = real_hit(*a, **k)
        hits.append((out[1].clone(), out[2].clone()))
        return out

    def record_texel(*a, **k):
        out = real_texel(*a, **k)
        hits.append((out[0].clone(), out[1].clone()))
        return out

    for mod, name, fn in ((itg, "closest_hit", record_hit), (texture, "nearest_texel", record_texel),
                          (cubemap, "nearest_texel", record_texel)):
        monkeypatch.setattr(mod, name, fn)
    try:
        with torch.no_grad():
            if field in CAM_FIELDS:
                cam = camera_to_arrays(build_camera(run["js"].cam, W, H), "cpu")
                t = getattr(cam, field).clone()
                t[index] = value
                out = port_render(run["scene"], run["js"], run["kw"], cam_leaves={field: t})
            else:
                diff, _ = split_diff_scene(run["scene"])
                t = diff[field]
                t[index] = value
                out = port_render(run["scene"], run["js"], run["kw"], {field: t})
    finally:
        monkeypatch.undo()
    return float((out.double() * torch.from_numpy(weights()).double()).sum()), hits


FD = {  # check: (case, field, coordinate, eps, rtol)
    "free-triangle-vertex": ("freetri-cpu-dls", "ft_v0", (0, 2), 1e-3, 1e-2),
    "mesh-vertex": ("plain-floor-cpu-dls", "mt_v0", (0, 1), 1e-4, 1e-2),
    "camera-o": ("spheres-cpu", "o", (2,), 1e-3, 1e-2),
    "camera-d": ("spheres-cpu", "d", (2,), 3e-4, 1e-2),
    "texel": ("floor-cpu-dls", "tex_pool", (61,), 1e-2, 1e-3),
}


@pytest.mark.parametrize("check", list(FD))
def test_central_difference_matches_the_gradient(runs, check, monkeypatch):
    """At a coordinate with a non-zero gradient: no lane's hit kind or id,
    and no texel fetched, moves at +-eps, and (L(x+eps) - L(x-eps)) / 2
    eps in f64 is the gradient within rtol. The renders are f32, so eps
    is as large as the hits allow (a geometric one moves the f32 roundings
    of every lane it touches, about 1e-3 of the difference here)."""
    case, field, index, eps, rtol = FD[check]
    run = runs(case)
    g = (run["cam_grads"] if field in CAM_FIELDS else run["grads"])[field]
    base = (getattr(camera_to_arrays(build_camera(run["js"].cam, W, H), "cpu"), field)
            if field in CAM_FIELDS else split_diff_scene(run["scene"])[0][field])
    x = float(base[index])
    _, hits = _loss_and_hits(run, field, index, x, monkeypatch)
    lp, hp = _loss_and_hits(run, field, index, x + eps, monkeypatch)
    lm, hm = _loss_and_hits(run, field, index, x - eps, monkeypatch)
    for other in (hp, hm):
        assert len(other) == len(hits) and all(
            torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) for a, b in zip(hits, other)), \
            f"{check}: a hit kind or id, or a texel, changes at +-{eps}"
    fd, ad = (lp - lm) / (2 * eps), float(g[index])
    assert ad != 0.0 and abs(fd - ad) <= rtol * abs(ad), f"{check}: fd {fd} against {ad}"


# --- the drivers that refuse it ---------------------------------------------


def _small_walled():
    return walled_scheme(16, 8)


@pytest.mark.parametrize("flag", ["use_fused", "use_wavefront"])
def test_renderer_refuses_a_driver_without_backward(flag):
    with pytest.raises(NotImplementedError):
        Renderer(_small_walled(), device="cpu", differentiable=True, **{flag: True})


def test_renderer_refuses_the_mesh_kernel(tmp_path):
    _, ps = octa_schemes(write_gltf(tmp_path / "m.gltf"), 16, 8, n_inst=1, with_extras=False)
    with pytest.raises(NotImplementedError):
        Renderer(ps, device="cpu", differentiable=True, use_mesh_fused=True)
    assert Renderer(ps, device="cpu").driver == "mesh_fused"


def test_differentiable_renderer_takes_sample_batch():
    r = Renderer(_small_walled(), device="cpu", differentiable=True)
    forward = Renderer(_small_walled(), device="cpu", use_fused=False, use_wavefront=False)
    assert r.driver == "plain" and r.params.differentiable
    np.testing.assert_array_equal(r.render(samples=2), forward.render(samples=2))


def test_wavefront_refuses_a_differentiable_render():
    scene = SceneTensors(from_reference(reference_fields(jax_build_scene(spheres_scheme()))),
                         build_camera(spheres_scheme().cam, W, H), 0.5)
    xs, ys = (torch.from_numpy(a) for a in pixels())
    with pytest.raises(ValueError):
        wavefront_batch(scene, port_params(CASES["spheres-gpu"][1]), xs, ys, 0, 1, W, 1024)


def test_replace_refuses_what_the_scene_lacks():
    scene = SceneTensors(from_reference(reference_fields(jax_build_scene(spheres_scheme()))),
                         build_camera(spheres_scheme().cam, W, H), 0.5)
    for field in ("mt_v0", "tex_pool", "sky_pool", "sph_valid"):
        with pytest.raises(ValueError):
            scene.replace(**{field: torch.zeros(3)})
    assert set(split_diff_scene(scene)[0]) == set(SPH + FT) <= set(DIFF_SCENE_FIELDS)


# --- the JAX package's mesh-gradient faults (ROADMAP queue 3) --------------


def test_reference_shading_copies_take_no_gradient(runs):
    """JAX lists mt_const_norm and mt_rgb_factor in DIFF_SCENE_FIELDS,
    but its shading reads their copies in mt_attr: exactly 0 for the
    fields, not for the columns."""
    g, _ = runs("floor-cpu-dls")["jax"]()
    assert not np.abs(g["mt_const_norm"]).max() and not np.abs(g["mt_rgb_factor"]).max()
    assert np.abs(g["mt_attr"][:, 0:3]).max() > 0 and np.abs(g["mt_attr"][:, 13:16]).max() > 0


def test_reference_cluster_walk_gives_vertices_no_gradient(runs):
    """With use_clusters on (its default), the JAX mesh hit reads the
    cluster copies cl_v0 / cl_e1 / cl_e2: mt_v0's gradient is exactly 0
    where the chunked path's is not."""
    run = runs("floor-cpu-dls")
    g, _ = jax_grads(run["jscene"], run["js"], run["kw"], use_clusters=True, only="mt_v0")
    assert not np.abs(g["mt_v0"]).max() and np.abs(run["jax"]()[0]["mt_v0"]).max() > 0
