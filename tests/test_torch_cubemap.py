"""Port parity for the distant cube map: the `!DistantCubeMap` parse, the
sky pool and face tables of `build_scene` and `from_reference`,
`ops/cubemap.sample` against the JAX package's `ops/cubemap.sample` and
`integrator.sample_cubemap`, and `trace_tiles_reference` with the sky
against the JAX `trace_tiles` (Pallas interpret mode) plus its driver's
resolve outside the kernel (renderer.py:169-178). Also holds the face
writer the other sky tests share.

Faces are small PNGs written with PIL (4x3 to 16x16, every texel
distinct), with non-unit and negative uv scales."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from PIL import Image

from raytrace_tpu.models import config as jax_cfg
from raytrace_tpu.models.camera import build_camera as jax_build_camera
from raytrace_tpu.models.scene import build_scene as jax_build_scene
from raytrace_tpu.ops import cubemap as jax_cubemap
from raytrace_tpu.ops.pallas import trace_kernel as jax_tk
from raytrace_tpu.ops.vec import Vec3
from raytrace_tpu.render.integrator import sample_cubemap as jax_sample_cubemap
from raytrace_tpu_torch.models import config as cfg
from raytrace_tpu_torch.models.camera import build_camera
from raytrace_tpu_torch.models.scene import SceneArrays, build_scene, from_reference
from raytrace_tpu_torch.ops import cubemap, texture
from raytrace_tpu_torch.ops import trace_kernel as tk
from test_torch_scene import reference_fields, schemes
from test_torch_trace_kernel import lane_gate

# (w, h) and (u_scale, v_scale) of each face, in FACE_ORDER
FACE_SHAPES = [(4, 3), (16, 16), (5, 7), (8, 6), (3, 9), (12, 10)]
FACE_SCALES = [(1.0, 1.0), (1.0, 1.0), (-1.0, 0.5), (0.8, -1.25), (1.0, 1.0), (-0.6, -1.0)]
SKY_FIELDS = ("cm_offsets", "cm_dims", "cm_uv_scales", "sky_pool")


def write_faces(face_dir, repeated=False):
    """Six PNG faces (distinct texels, a seed per face) -> the
    !DistantCubeMap value {name: [path, u_scale, v_scale]}. repeated:
    pos_y names neg_z's file."""
    value = {}
    for i, name in enumerate(cfg.FACE_ORDER):
        w, h = FACE_SHAPES[i]
        path = face_dir / f"{name}.png"
        if repeated and name == "pos_y":
            path = face_dir / "neg_z.png"
        else:
            g = np.random.default_rng(100 + i)
            rgb = g.permutation(256 * 256 * 256)[: w * h]  # distinct texels
            px = np.stack([rgb & 255, (rgb >> 8) & 255, rgb >> 16], -1).astype(np.uint8)
            Image.fromarray(px.reshape(h, w, 3)).save(path)
        value[name] = [str(path), *FACE_SCALES[i]]
    return value


def add_sky(scheme, mod, parse, value):
    """Appends the !DistantCubeMap member to a scheme of package `mod`."""
    scheme.scene_members.append(parse(mod.Tagged("DistantCubeMap", value)))
    return scheme


def _sky_schemes(tmp_path, repeated=False, name="mixed", w=64, h=32, assured=2):
    value = write_faces(tmp_path, repeated)
    js, ps = schemes(name, w, h, assured)
    return (add_sky(js, jax_cfg, jax_cfg._parse_member, value),
            add_sky(ps, cfg, cfg.parse_member, value))


def test_load_scheme_cube_map_matches_jax(tmp_path):
    """The YAML parse of a !DistantCubeMap member: six faces in the WGSL
    order, each [path, u_scale, v_scale], face paths relative to the
    scheme resolved against its directory."""
    value = write_faces(tmp_path)
    faces = "".join(f"    {n}: [{n}.png, {us}, {vs}]\n" for n, (_, us, vs) in value.items())
    yml = tmp_path / "sky.yml"
    yml.write_text(
        "render_info: {width: 32, height: 16, samps_per_pix: 2}\n"
        "cam: {d: [0, 0, -4], o: [0, 0, 1], up: [0, 1, 0], screen_width: 8, screen_height: 4}\n"
        "scene_members:\n"
        "- !Sphere {c: [0, 0, -5], r: 1, coloring: !Solid [0.5, 0.5, 0.5], mat: {divert_ray: Diff}}\n"
        f"- !DistantCubeMap\n{faces}")
    js, ps = jax_cfg.load_scheme(str(yml)), cfg.load_scheme(str(yml))
    jm, pm = js.scene_members[1], ps.scene_members[1]
    assert isinstance(pm, cfg.CubeMapMember)
    for name in cfg.FACE_ORDER:
        a, b = getattr(pm, name), getattr(jm, name)
        assert (a.path, a.u_scale, a.v_scale) == (b.path, b.u_scale, b.v_scale), name
    jscene, scene = jax_build_scene(js), build_scene(ps)
    for f in SKY_FIELDS:
        np.testing.assert_array_equal(getattr(scene, f), np.asarray(getattr(jscene, f)), f)
    assert scene.has_cubemap and jscene.has_cubemap


@pytest.mark.parametrize("repeated", [False, True], ids=["six-files", "repeated-path"])
def test_sky_pool_and_face_tables_match_jax(tmp_path, repeated):
    """sky_pool (a packed u32 pool: every face is u8), cm_offsets, cm_dims
    and cm_uv_scales bit for bit; a repeated face path is decoded once
    and shares its offset; from_reference carries them and has_cubemap."""
    js, ps = _sky_schemes(tmp_path, repeated)
    jscene, scene = jax_build_scene(js), build_scene(ps)
    assert scene.has_cubemap and scene.sky_pool.dtype == np.uint32
    for f in SKY_FIELDS:
        ours, ref = getattr(scene, f), np.asarray(getattr(jscene, f))
        assert ours.dtype == ref.dtype, f
        np.testing.assert_array_equal(ours.view(np.uint32) if f == "cm_uv_scales" else ours,
                                      ref.view(np.uint32) if f == "cm_uv_scales" else ref, f)
    texels = sum(w * h for w, h in FACE_SHAPES)
    if repeated:
        assert scene.cm_offsets[5] == scene.cm_offsets[0]
        texels -= FACE_SHAPES[5][0] * FACE_SHAPES[5][1]
        assert tuple(scene.cm_dims[5]) == FACE_SHAPES[0]
    assert scene.sky_pool.size == texels
    assert scene.tex_pool.size == 1  # the mesh texture pool stays apart
    via_ref = from_reference(reference_fields(jscene))
    for f in SceneArrays.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(via_ref, f), getattr(scene, f), err_msg=f)


def _sky_arrays(kind, seed=0):
    """A sky of the six FACE_SHAPES faces in a pool of `kind`: f32 texels
    (R = the texel's index in the pool, G = its face, B noise), or the
    u32 / u16 forms of random u8 texels. Returns (pool numpy, offsets,
    dims, scales)."""
    dims = np.array(FACE_SHAPES, np.int32)
    sizes = dims[:, 0] * dims[:, 1]
    offsets = (3 * np.concatenate([[0], np.cumsum(sizes)[:-1]])).astype(np.int32)
    n = int(sizes.sum())
    scales = np.array(FACE_SCALES, np.float32)
    g = np.random.default_rng(seed)
    if kind == "f32":
        face = np.repeat(np.arange(6), sizes).astype(np.float32)
        pool = np.stack([np.arange(n, dtype=np.float32), face, g.uniform(0, 1, n)], -1)
        return pool.astype(np.float32).reshape(-1), offsets, dims, scales
    u8 = g.integers(0, 256, (n, 3), dtype=np.uint8)
    if kind == "u16":
        return u8.astype(np.uint16).reshape(-1) * np.uint16(257), offsets, dims, scales
    packed = (u8[:, 0].astype(np.uint32) | (u8[:, 1].astype(np.uint32) << np.uint32(8))
              | (u8[:, 2].astype(np.uint32) << np.uint32(16)))
    return packed, offsets, dims, scales


def _both(kind, d):
    """(port RGB, JAX cubemap.sample RGB, JAX sample_cubemap RGB), (N, 3)
    numpy each, for the (N, 3) f32 directions d."""
    pool, offsets, dims, scales = _sky_arrays(kind)
    pt, pk = texture.pool_tensor(pool)
    ours = cubemap.sample(pt, pk, torch.from_numpy(offsets), torch.from_numpy(dims),
                          torch.from_numpy(scales), *(torch.from_numpy(np.ascontiguousarray(d[:, k]))
                                                      for k in range(3)))
    ref = np.asarray(jax_cubemap.sample(jnp.asarray(pool), jnp.asarray(offsets), jnp.asarray(dims),
                                        jnp.asarray(scales), jnp.asarray(d)))
    scene = types.SimpleNamespace(sky_pool=jnp.asarray(pool), cm_offsets=jnp.asarray(offsets),
                                  cm_dims=jnp.asarray(dims), cm_uv_scales=jnp.asarray(scales))
    ref2 = jax_sample_cubemap(scene, Vec3(*(jnp.asarray(d[:, k]) for k in range(3))))
    return torch.stack(ours, -1).numpy(), ref, np.stack([np.asarray(c) for c in ref2], -1)


def _planted():
    """Axis directions, both signs of every face (off-axis too), and ties:
    |x| = |y|, |y| = |z|, |x| = |z|, all equal, each with flipped signs;
    not unit, as rays are not."""
    base = [[1, 0, 0], [0, 1, 0], [0, 0, 1], [0.3, 0.2, 0.9], [0.9, -0.4, 0.1], [-0.2, 0.7, 0.5],
            [1, 1, 0], [0, 1, 1], [1, 0, 1], [1, 1, 1], [0.5, 0.5, 0.2], [0.2, 0.6, 0.6],
            [0.7, 0.1, 0.7], [2.0, -2.0, 2.0], [0.31, 0.31, 0.31]]
    signs = np.array([[sx, sy, sz] for sx in (1, -1) for sy in (1, -1) for sz in (1, -1)])
    d = (np.array(base, np.float32)[:, None, :] * signs[None]).reshape(-1, 3)
    return np.concatenate([d, 3.5 * d]).astype(np.float32)


@pytest.mark.parametrize("kind", ["u32", "u16", "f32"])
def test_sample_planted_directions_equal_jax(kind):
    """Every face, both signs, and the >= ties (x beats y beats z) give
    the JAX package's RGB bit for bit, through both of its functions."""
    d = _planted()
    ours, ref, ref2 = _both(kind, d)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, ref2)
    if kind == "f32":  # each face is reached with both signs and the ties pick the JAX face
        assert set(ours[:, 1].astype(int).tolist()) == set(range(6))


def test_sample_random_directions_match_jax():
    """4,096 seeded directions: RGB equal on >= 99.9% of them (XLA on the
    CPU contracts the norm's dot product, the port rounds each product),
    and never another face or more than one texel off."""
    g = np.random.default_rng(42)
    d = (g.normal(size=(4096, 3)) * g.uniform(0.5, 4.0, (4096, 1))).astype(np.float32)
    ours, ref, ref2 = _both("f32", d)
    for r in (ref, ref2):
        same = (ours == r).all(-1)
        assert same.mean() >= 0.999, same.mean()
        np.testing.assert_array_equal(ours[:, 1], r[:, 1])  # the face
        _, offsets, dims, _ = _sky_arrays("f32")
        face = ours[:, 1].astype(int)
        local = [(v.astype(np.int64) - offsets[face] // 3) for v in (ours[:, 0], r[:, 0])]
        w = dims[face, 0]
        assert (np.abs(local[0] % w - local[1] % w) <= 1).all()
        assert (np.abs(local[0] // w - local[1] // w) <= 1).all()


def test_sample_black_where_a_face_is_empty():
    pool, offsets, dims, scales = _sky_arrays("u32")
    dims[3] = 0  # pos_x
    pt, pk = texture.pool_tensor(pool)
    d = torch.tensor([[2.0, 0.1, 0.2], [-2.0, 0.1, 0.2]])
    rgb = cubemap.sample(pt, pk, torch.from_numpy(offsets), torch.from_numpy(dims),
                         torch.from_numpy(scales), *d.T)
    out = torch.stack(rgb, -1)
    assert (out[0] == 0).all() and (out[1] > 0).any()


def test_texel_is_the_one_sample_reads():
    """cubemap.texel names the texel `sample` fetches: on the f32 pool,
    whose R is the texel's index, R == base3 // 3 on every planted
    direction."""
    pool, offsets, dims, scales = _sky_arrays("f32")
    pt, pk = texture.pool_tensor(pool)
    d = torch.from_numpy(_planted())
    args = (torch.from_numpy(offsets), torch.from_numpy(dims), torch.from_numpy(scales), *d.T)
    ok, base3 = cubemap.texel(*args)
    rgb = cubemap.sample(pt, pk, *args)
    assert bool(ok.all()) and torch.equal(rgb[0], (base3 // 3).to(torch.float32))


def test_launch_args_null_without_a_sky():
    """The fused kernels' last C arguments: null pointers without a sky;
    with one, its face table, pool, pool kind and length, on the device
    asked for or a ValueError."""
    cpu = torch.device("cpu")
    assert cubemap.launch_args(None, cpu) == [None, None, 0, 0]
    pool, offsets, dims, scales = _sky_arrays("u32")
    sky = cubemap.SkyTables(types.SimpleNamespace(sky_pool=pool, cm_offsets=offsets,
                                                  cm_dims=dims, cm_uv_scales=scales))
    args = cubemap.launch_args(sky, cpu)
    assert len(args) == len(cubemap.ARGTYPES)
    assert args == [sky.face.data_ptr(), sky.pool.data_ptr(), texture.POOL_U32, pool.size]
    with pytest.raises(ValueError):
        cubemap.launch_args(sky, torch.device("meta"))


# --- trace_tiles with the sky ----------------------------------------------

W, H, ASSURED, MAX_BOUNCES = 64, 32, 2, 12


def _tiles_setup(tmp_path):
    js, ps = _sky_schemes(tmp_path, w=W, h=H, assured=ASSURED)
    jscene, scene = jax_build_scene(js), build_scene(ps)
    tables = tk.SceneTables(scene, build_camera(ps.cam, W, H), 0.5)
    flat = np.arange(W * H, dtype=np.int32)
    xs, ys = (flat % W).reshape(-1, 128), (flat // W).reshape(-1, 128)
    return js, jscene, tables, xs, ys


def test_trace_tiles_sky_matches_jax_route(tmp_path):
    """spl 1: the plain version with the sky against the JAX kernel plus
    its driver's resolve outside it (renderer.py:169-178): all 9 outputs
    under the lane gate; the sky lights most of the frame."""
    js, jscene, tables, xs, ys = _tiles_setup(tmp_path)
    samp = np.full_like(xs, 5)
    statics = dict(n_sph=tables.n_sph, n_ft=tables.n_ft, has_lens=False, assured=ASSURED,
                   max_bounces=MAX_BOUNCES, samples_per_lane=1)
    jsph, jft = jax_tk.pack_scene_tables(jscene)
    jcv = jax_tk.make_cam_vec(jax_build_camera(js.cam, W, H))
    with pltpu.force_tpu_interpret_mode():
        ref = [np.asarray(r).reshape(-1) for r in jax_tk.trace_tiles(
            jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(samp), jnp.asarray(jsph),
            jnp.asarray(jft), jnp.asarray(jcv), interpret=True, **statics)]
    md = [jnp.asarray(ref[3 + k]) for k in range(3)]
    missed = (md[0] != 0.0) | (md[1] != 0.0) | (md[2] != 0.0)
    sky = jax_sample_cubemap(jscene, Vec3(jnp.where(missed, md[0], 1.0), md[1], md[2]))
    for k, c in enumerate((sky.x, sky.y, sky.z)):
        ref[k] = np.asarray(ref[k] + jnp.where(missed, ref[6 + k] * c, 0.0))

    launches = dict(tk.LAUNCHES)
    ours = tk.trace_tiles(torch.from_numpy(xs), torch.from_numpy(ys), torch.from_numpy(samp),
                          tables.sph, tables.ft, tables.cam_vec, sky=tables.sky, **statics)
    assert tk.LAUNCHES == launches  # CPU tensors never reach the CUDA kernel
    for o_, r_ in zip(ours, ref):
        lane_gate(o_.numpy().reshape(-1), r_)
    assert float(np.asarray(missed).mean()) > 0.3
    no_sky = tk.trace_tiles(torch.from_numpy(xs), torch.from_numpy(ys), torch.from_numpy(samp),
                            tables.sph, tables.ft, tables.cam_vec, **statics)
    assert float(ours[0].sum()) > 1.5 * float(no_sky[0].sum())
    for k in range(3, 9):  # the miss records do not depend on the sky
        assert torch.equal(ours[k], no_sky[k])


def test_trace_tiles_sky_regenerates(tmp_path):
    """spl 4 with the sky == the sum of four spl-1 launches (lane gate):
    the sky is added at each sample's miss, so lanes keep regenerating."""
    _, _, tables, xs, ys = _tiles_setup(tmp_path)
    xs, ys = torch.from_numpy(xs.reshape(-1)), torch.from_numpy(ys.reshape(-1))
    kw = dict(n_sph=tables.n_sph, n_ft=tables.n_ft, has_lens=False, assured=ASSURED,
              max_bounces=MAX_BOUNCES, sky=tables.sky)
    args = (tables.sph, tables.ft, tables.cam_vec)
    packed = tk.trace_tiles(xs, ys, torch.full_like(xs, 30), *args, samples_per_lane=4, **kw)
    single = [tk.trace_tiles(xs, ys, torch.full_like(xs, 30 + k), *args, **kw) for k in range(4)]
    for c in range(3):
        lane_gate(packed[c].numpy(), sum(s[c] for s in single).numpy())
