"""Port parity for the fused path-tracing kernel: the port's closest hit,
BSDF and `trace_tiles_reference` (the plain torch version the CUDA
kernel is held against on the card) against the JAX kernel's helpers and
`trace_tiles` in Pallas interpret mode, on the same lanes and sample ids.

Radiance gate (tests/test_pallas.py:72-74): under 1% of lanes may have
|a - b| / (|b| + 1e-3) > 1e-3. Only RNG words are held bit-equal; float
ulps (sin/cos, rsqrt, op fusion) may flip a knife-edge path."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from raytrace_tpu.models.camera import build_camera as jax_build_camera
from raytrace_tpu.models.scene import build_scene as jax_build_scene
from raytrace_tpu.ops.pallas import trace_kernel as jax_tk
from raytrace_tpu_torch.models.camera import build_camera
from raytrace_tpu_torch.models.scene import build_scene
from raytrace_tpu_torch.ops import trace_kernel as tk
from raytrace_tpu_torch.ops.bsdf import uniform_bsdf
from raytrace_tpu_torch.ops.intersect import INF, closest_sph_ft, sphere_disc
from test_torch_scene import schemes

SIZES = {"walled": (32, 32), "mixed": (64, 32)}
ASSURED, MAX_BOUNCES = 3, 12


def lane_gate(ours, ref, frac=0.01):
    mismatch = np.abs(ours - ref) / (np.abs(ref) + 1e-3)
    bad = float((mismatch > 1e-3).mean())
    assert np.isfinite(ours).all()
    assert bad < frac, f"{bad:.4f} of lanes differ; max rel {mismatch.max()}"


def _tables(name):
    js, ps = schemes(name, *SIZES[name], ASSURED)
    return jax_tk.pack_scene_tables(jax_build_scene(js)), build_scene(ps)


def _rays(n, seed):
    g = np.random.default_rng(seed)
    o = g.uniform([-6, -6, -12], [6, 6, 0], (n, 3)).astype(np.float32)
    d = g.normal(size=(n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


@pytest.mark.parametrize("name", ["walled", "mixed"])
def test_closest_sph_ft_matches_jax(name):
    (jsph, jft), scene = _tables(name)
    S, F = scene.n_spheres, scene.n_free_tris
    o, d = _rays(4096, seed=1)
    ray_t = [torch.from_numpy(np.ascontiguousarray(a[:, k])) for a in (o, d) for k in range(3)]
    ray_j = [jnp.asarray(a[:, k]) for a in (o, d) for k in range(3)]
    sph, ft = tk.pack_scene_tables(scene)
    ours = closest_sph_ft(torch.from_numpy(sph), torch.from_numpy(ft), *ray_t, n_sph=S, n_ft=F)
    ref = jax_tk.closest_sph_ft(jnp.asarray(jsph), jnp.asarray(jft), *ray_j,
                                n_sph=S, n_ft=F, hints=jax_tk._PERMISSIVE)
    ref = {k: np.broadcast_to(np.asarray(v), (4096,)) for k, v in ref.items()
           if k not in ("track_kind", "sel_diffp", "sel_n")}
    ours = {k: v.numpy() for k, v in ours.items()}

    hit = ref["t_best"] < INF
    assert 0.1 < hit.mean() < 1.0  # the rays exercise both outcomes
    np.testing.assert_array_equal(ours["kind"] > 0, hit)
    np.testing.assert_allclose(ours["t_best"], ref["t_best"], rtol=1e-5, atol=1e-5)
    if S and F:
        np.testing.assert_array_equal(ours["kind"], ref["kind"])
    is_s, is_f = ours["kind"] == 1, ours["kind"] == 2
    assert is_s.any()
    for k in ("scx", "scy", "scz"):
        np.testing.assert_array_equal(ours[k][is_s], ref[k][is_s])
    for k in ("nxv", "nyv", "nzv"):
        np.testing.assert_array_equal(ours[k][is_f], ref[k][is_f])
    for k in ("rgb_r", "rgb_g", "rgb_b", "em_r", "em_g", "em_b", "has_em", "mkind",
              "diffp", "n_out", "n_in"):
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_uniform_bsdf_matches_jax():
    g = np.random.default_rng(2)
    n = 8192
    _, d = _rays(n, seed=3)
    _, nrm = _rays(n, seed=4)
    cols = dict(
        mkind=g.integers(0, 4, n).astype(np.float32),
        diffp=g.uniform(0, 1, n).astype(np.float32),
        n_out=np.ones(n, np.float32),
        n_in=g.choice([1.2, 1.3, 1.5], n).astype(np.float32),
        **{f"u{k}": g.uniform(0, 1, n).astype(np.float32) for k in range(4)},
    )
    args = [d[:, 0], d[:, 1], d[:, 2], nrm[:, 0], nrm[:, 1], nrm[:, 2],
            cols["mkind"], cols["diffp"], cols["n_out"], cols["n_in"],
            cols["u0"], cols["u1"], cols["u2"], cols["u3"]]
    ours = uniform_bsdf(*[torch.from_numpy(np.ascontiguousarray(a)) for a in args])
    ref = jax_tk.uniform_bsdf(*[jnp.asarray(a) for a in args], hints=jax_tk._PERMISSIVE)
    for o_, r_ in zip(ours, ref):
        np.testing.assert_allclose(o_.numpy(), np.asarray(r_), rtol=0, atol=1e-5)


@pytest.mark.parametrize("name,spl", [("walled", 1), ("walled", 4), ("mixed", 1), ("mixed", 4)])
def test_trace_tiles_reference_matches_jax(name, spl):
    w, h = SIZES[name]
    js, ps = schemes(name, w, h, ASSURED)
    jscene, scene = jax_build_scene(js), build_scene(ps)
    jsph, jft = jax_tk.pack_scene_tables(jscene)
    jcv = jax_tk.make_cam_vec(jax_build_camera(js.cam, w, h))
    flat = np.arange(w * h, dtype=np.int32)
    xs, ys = (flat % w).reshape(-1, 128), (flat // w).reshape(-1, 128)
    samp = np.full_like(xs, 17)
    statics = dict(n_sph=scene.n_spheres, n_ft=scene.n_free_tris, has_lens=False,
                   assured=ASSURED, max_bounces=MAX_BOUNCES, samples_per_lane=spl)

    with pltpu.force_tpu_interpret_mode():
        ref = jax_tk.trace_tiles(jnp.asarray(xs), jnp.asarray(ys), jnp.asarray(samp),
                                 jnp.asarray(jsph), jnp.asarray(jft), jnp.asarray(jcv),
                                 interpret=True, **statics)
    ref = [np.asarray(r) for r in ref]

    tables = tk.SceneTables(scene, build_camera(ps.cam, w, h), 0.5)
    launches = tk.LAUNCHES
    ours = tk.trace_tiles(torch.from_numpy(xs), torch.from_numpy(ys), torch.from_numpy(samp),
                          tables.sph, tables.ft, tables.cam_vec, **statics)
    assert tk.LAUNCHES == launches  # CPU tensors never reach the CUDA kernel
    assert all(o.shape == xs.shape and o.dtype == torch.float32 for o in ours)
    # at spl > 1 only the radiance is meaningful (miss records are last-write-wins)
    for o_, r_ in list(zip(ours, ref))[: 9 if spl == 1 else 3]:
        lane_gate(o_.numpy(), r_)
    assert ref[0].mean() > 0.01  # the scene is lit


def test_samples_per_lane_is_a_sum_of_samples():
    """Regenerating 3 samples in a lane == three single-sample calls."""
    (_, _), scene = _tables("mixed")
    _, ps = schemes("mixed", 64, 32, ASSURED)
    tables = tk.SceneTables(scene, build_camera(ps.cam, 64, 32), 0.5)
    flat = torch.arange(64 * 32, dtype=torch.int32)
    xs, ys = flat % 64, flat // 64
    kw = dict(n_sph=tables.n_sph, n_ft=tables.n_ft, has_lens=False,
              assured=ASSURED, max_bounces=MAX_BOUNCES)
    args = (tables.sph, tables.ft, tables.cam_vec)
    packed = tk.trace_tiles(xs, ys, torch.full_like(xs, 40), *args, samples_per_lane=3, **kw)
    single = [tk.trace_tiles(xs, ys, torch.full_like(xs, 40 + k), *args, **kw) for k in range(3)]
    for c in range(3):
        lane_gate(packed[c].numpy(), sum(s[c] for s in single).numpy())


def test_trace_tiles_rejects_what_it_cannot_run():
    (_, _), scene = _tables("walled")
    _, ps = schemes("walled", 32, 32, ASSURED)
    t = tk.SceneTables(scene, build_camera(ps.cam, 32, 32), 0.5)
    xs = torch.zeros(128, dtype=torch.int32)
    kw = dict(n_ft=0, has_lens=False, assured=1, max_bounces=2)
    with pytest.raises(NotImplementedError):
        tk.trace_tiles(xs, xs, xs, t.sph, t.ft, t.cam_vec, n_sph=65, **kw)
    meta = xs.to("meta")
    with pytest.raises(ValueError):
        tk.trace_tiles(meta, meta, meta, t.sph, t.ft, t.cam_vec, n_sph=13, **kw)
    # the per-thread yardstick runs on the card only
    with pytest.raises(ValueError):
        tk._trace_tiles_per_thread(xs, xs, xs, t.sph, t.ft, t.cam_vec, n_sph=13, **kw)


@pytest.mark.parametrize("name", ["walled", "mixed"])
def test_sphere_geometry_rows_are_the_table_columns(name):
    """The CUDA kernel stages each sphere's 16-byte row (cx, cy, cz, r^2)
    from columns 0-3 of SceneTables.sph: those are the JAX packer's
    centres and radii, and r^2 as one f32 multiply (its __fmul_rn) gives
    the plain version's sphere test (r * r of the row's float radius)
    bit for bit."""
    (jsph, _), scene = _tables(name)
    _, ps = schemes(name, *SIZES[name], ASSURED)
    t = tk.SceneTables(scene, build_camera(ps.cam, *SIZES[name]), 0.5)
    n = scene.n_spheres
    sph = t.sph.numpy()
    np.testing.assert_array_equal(sph[:n, :4], np.asarray(jsph)[:n, :4])
    r = sph[:n, 3]
    r2 = r * r  # f32 products, as staged
    np.testing.assert_array_equal(r2, (r.astype(np.float64) ** 2).astype(np.float32))
    assert (r2 > 0).all()
    o, d = _rays(4096, seed=5)
    ray = [torch.from_numpy(np.ascontiguousarray(a[:, k])) for a in (o, d) for k in range(3)]
    for row, rr in zip(t.sph[:n].tolist(), r2):
        dirv, disc = sphere_disc(*ray, row)
        oc = [ray[k] - row[k] for k in range(3)]
        staged = dirv * dirv - (oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2]
                                - torch.tensor(rr))
        assert torch.equal(disc.view(torch.int32), staged.view(torch.int32))


def _run_iters(tables, xs, ys, base, spl):
    return tk.trace_tiles_reference(
        xs, ys, torch.full_like(xs, base), tables.sph, tables.ft, tables.cam_vec,
        n_sph=tables.n_sph, n_ft=tables.n_ft, has_lens=False, assured=ASSURED,
        max_bounces=MAX_BOUNCES, samples_per_lane=spl, return_iters=True)


@pytest.mark.parametrize("name", ["walled", "mixed"])
def test_iteration_counts_add_over_samples(name):
    """return_iters: a lane's loop iterations and near roots at 4 samples
    per lane are the sums of its counts at one sample per lane over the
    same four sample ids; the branch record has one entry per active
    lane-iteration, and the outputs are the plain call's."""
    w, h = SIZES[name]
    _, scene = _tables(name)
    _, ps = schemes(name, w, h, ASSURED)
    t = tk.SceneTables(scene, build_camera(ps.cam, w, h), 0.5)
    flat = torch.arange(w * h, dtype=torch.int32)
    xs, ys = flat % w, flat // w
    out, (iters, branch, roots) = _run_iters(t, xs, ys, 9, 4)
    assert iters.shape == roots.shape == xs.shape
    assert iters.dtype == roots.dtype == torch.int32
    assert branch.dtype == torch.int8 and branch.shape == (int(iters.max()), xs.numel())
    counts = [_run_iters(t, xs, ys, 9 + k, 1)[1] for k in range(4)]
    single = [c[0] for c in counts]
    assert torch.equal(iters, sum(single))
    assert torch.equal(roots, sum(c[2] for c in counts))
    assert 0 < int(roots.sum()) and bool((roots <= iters * t.n_sph).all())
    assert torch.equal((branch >= 0).sum(0).to(torch.int32), iters)
    assert int(branch.max()) < len(tk.BRANCHES) and int(branch.min()) >= -1
    assert 1 <= int(single[0].min()) and int(single[0].max()) <= MAX_BOUNCES
    plain = tk.trace_tiles_reference(
        xs, ys, torch.full_like(xs, 9), t.sph, t.ft, t.cam_vec, n_sph=t.n_sph, n_ft=t.n_ft,
        has_lens=False, assured=ASSURED, max_bounces=MAX_BOUNCES, samples_per_lane=4)
    for a, b in zip(out, plain):
        assert torch.equal(a, b)
    share = [(branch == c).sum() for c in range(len(tk.BRANCHES))]
    assert share[0] > 0 and share[1] > 0 and share[3] > 0  # misses, diffuse, dielectric
