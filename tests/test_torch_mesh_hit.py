"""Port parity for the mesh nearest hit alone: the port's `mesh_hit` (its
plain version on the CPU, the cluster walk with a lower bound t_min)
against the JAX `mesh_hit_tiles` kernel run in interpret mode (gpu
semantics, t_min = EPS) and against the JAX integrator's
`_mesh_hit_clusters` under cpu semantics (t_min = 20*EPS), on the same
rays and seeds.

The JAX kernel's tables are packed by the JAX package's own
`pack_mesh_tables_np` from the JAX scene's flattened `cl_*` fields and
the port's camera position; its `mk_*` tables are asset-local on
instanced scenes (the octahedra) and are not used.

Gate (tests/test_torch_mesh_ops.py): gids equal on >= 99.5% of lanes;
where they are, t within 1e-5 relative on >= 98% of them and within 2e-4
on all, barycentrics within 1e-3. The slack is XLA contracting
multiply-adds into FMAs on the CPU, which torch does not.

The same cases hold `walk_work` (the tests an exact walk must make,
which set the kernel's bound) against a brute numpy count, and the
invariant the kernel's visiting order rests on: pruning every box by the
final nearest t keeps the nearest hit, bitwise."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from raytrace_tpu.models import config as jax_cfg
from raytrace_tpu.models.gltf import LoadedMesh, Primitive
from raytrace_tpu.models.scene import build_scene as jax_build_scene
from raytrace_tpu.ops.pallas.mesh_hit_kernel import mesh_hit_tiles, pack_mesh_tables_np
from raytrace_tpu.ops.vec import Vec3
from raytrace_tpu.render.integrator import IntegratorParams, _mesh_hit_clusters
from raytrace_tpu_torch.models.camera import build_camera
from raytrace_tpu_torch.models.scene import from_reference
from raytrace_tpu_torch.ops import mesh_kernel as mk
from raytrace_tpu_torch.ops.intersect import EPS, INF
from test_torch_mesh_ops import _rays
from test_torch_mesh_scene import mesh_raw, octa_schemes, surface_scene, write_gltf
from test_torch_scene import reference_fields

N_LANES = 4096  # test_torch_mesh_ops' rays, a multiple of the JAX kernel's 1,024


def _tiny_mesh(n_tris=24):
    """The 24-triangle ring of __graft_entry__.py:172-187."""
    th = np.linspace(0, 2 * np.pi, n_tris, endpoint=False)
    v0 = np.stack([np.cos(th), np.sin(th), -6.0 + 0.1 * np.sin(3 * th)], -1)
    e1 = np.stack([-0.4 * np.sin(th), 0.4 * np.cos(th), np.zeros_like(th)], -1)
    e2 = np.random.default_rng(3).normal(0, 0.2, (n_tris, 3)) + np.array([0, 0, 0.3])
    poses = np.concatenate([v0, v0 + e1, v0 + e2], 0).astype(np.float32)
    idx = np.stack([np.arange(n_tris), np.arange(n_tris) + n_tris,
                    np.arange(n_tris) + 2 * n_tris], 1).astype(np.int32)
    nn = np.cross(e1, e2)
    nn /= np.maximum(np.linalg.norm(nn, axis=1, keepdims=True), 1e-9)
    return LoadedMesh(
        primitives=[Primitive(
            poses=poses, norms=np.concatenate([nn] * 3, 0).astype(np.float32),
            indices=idx, rgb_factor=np.array([0.7, 0.5, 0.4], np.float32),
            metal_factor=0.3, rough_factor=0.5)],
        trans_mat=np.eye(4, dtype=np.float32))


def _ring_scenes():
    js = jax_cfg.parse_scheme(mesh_raw([], 32, 32))
    js.scene_members.append(jax_cfg.ModelMember(
        path="<ring>", uniform_scale=1.0, translation=np.zeros(3, np.float32),
        euler_angles=np.zeros(3, np.float32)))
    from raytrace_tpu.models import scene as jax_scene_mod

    orig_load, orig_resolve = jax_scene_mod.gltf_mod.load_model, jax_scene_mod.resolve_asset_path
    jax_scene_mod.gltf_mod.load_model = lambda *a, **k: [_tiny_mesh()]
    jax_scene_mod.resolve_asset_path = lambda p, d: p
    try:
        jscene = jax_build_scene(js)
    finally:
        jax_scene_mod.gltf_mod.load_model = orig_load
        jax_scene_mod.resolve_asset_path = orig_resolve
    from raytrace_tpu_torch.models import config as cfg

    ps = cfg.parse_scheme(mesh_raw([], 32, 32))
    return jscene, ps, np.array([0.0, 0.0, -6.0]), 2.0


@pytest.fixture(scope="module", params=["ring", "surface", "octahedra"])
def case(request, tmp_path_factory):
    """(JAX scene, port MeshTables, rays o d, seeds) of one scene."""
    if request.param == "ring":
        jscene, ps, center, spread = _ring_scenes()
    elif request.param == "surface":
        jscene, _, _, ps = surface_scene()
        center, spread = np.array([0.0, 0.0, 0.0]), 30.0
    else:
        js, ps = octa_schemes(write_gltf(tmp_path_factory.mktemp("octa") / "m.gltf",
                                         textured=True))
        jscene = jax_build_scene(js)
        center, spread = np.array([0.0, 0.0, 0.0]), 5.0
    scene = from_reference(reference_fields(jscene))
    cam = build_camera(ps.cam, ps.render_info.width, ps.render_info.height)
    tables = mk.MeshTables(scene, cam, 0.5)
    o, d, seed = _rays(17, center, spread)
    # seeds: INF, a finite t (from _rays), and -INF (a dead lane) on a quarter
    seed = np.where(np.arange(N_LANES) % 4 == 3, np.float32(-INF), seed).astype(np.float32)
    return jscene, tables, cam, o, d, seed


def _cols(a):
    """(N, 3) numpy -> a 3-tuple of (N,) tensors."""
    return tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in a.T)


def _port(tables, o, d, seed, t_min):
    t_, g, u, v = mk.mesh_hit(_cols(o), _cols(d), torch.from_numpy(seed), tables, t_min=t_min)
    assert g.dtype == torch.int32
    return tuple(a.numpy() for a in (t_, g, u, v))


def _gate(ours, ref, seed):
    t, g, u, v = ours
    ref_t, ref_g, ref_u, ref_v = ref
    dead = seed == np.float32(-INF)
    assert (g[dead] == -1).all() and (t[dead] == seed[dead]).all()
    hits = (ref_g >= 0).sum()
    assert hits > N_LANES // 10, hits  # the rays do reach the mesh
    same = g == ref_g
    assert same.mean() >= 0.995, f"gids differ on {(~same).sum()} lanes"
    live = same & ~dead
    rel = np.abs(t[live] - ref_t[live]) / np.abs(ref_t[live])
    assert (rel <= 1e-5).mean() >= 0.98, f"t off by > 1e-5 on {(rel > 1e-5).sum()} lanes"
    assert rel.max() <= 2e-4, rel.max()
    hit = same & (g >= 0)
    np.testing.assert_allclose(u[hit], ref_u[hit], atol=1e-3)
    np.testing.assert_allclose(v[hit], ref_v[hit], atol=1e-3)


def test_mesh_hit_matches_mesh_hit_tiles(case):
    """gpu semantics: the JAX Pallas kernel (interpret mode), tables
    packed from the flattened cl_* fields."""
    jscene, tables, cam, o, d, seed = case
    bounds, sbounds, sgbounds, tri = pack_mesh_tables_np(
        np.asarray(jscene.cl_idx), np.asarray(jscene.cl_lo), np.asarray(jscene.cl_hi),
        np.asarray(jscene.cl_v0), np.asarray(jscene.cl_e1), np.asarray(jscene.cl_e2),
        cam_o=cam.o)
    resh = lambda a: jnp.asarray(np.ascontiguousarray(a).reshape(-1, 128))
    ref = mesh_hit_tiles(*(resh(c) for c in (*o.T, *d.T, seed)), jnp.asarray(bounds),
                         jnp.asarray(sbounds), jnp.asarray(sgbounds), jnp.asarray(tri),
                         n_clusters=bounds.shape[0], width=int(jscene.cl_idx.shape[1]),
                         interpret=True)
    _gate(_port(tables, o, d, seed, EPS), tuple(np.asarray(a).reshape(-1) for a in ref), seed)


def test_mesh_hit_cpu_guard_matches_mesh_hit_clusters(case):
    """cpu semantics: the XLA cluster walk with its 20*EPS guard."""
    jscene, tables, _, o, d, seed = case
    ref = _mesh_hit_clusters(jscene, IntegratorParams(mode="cpu"), Vec3(*map(jnp.asarray, o.T)),
                             Vec3(*map(jnp.asarray, d.T)), jnp.asarray(seed))
    _gate(_port(tables, o, d, seed, 20 * EPS), tuple(np.asarray(a) for a in ref), seed)


def test_mesh_hit_guard_excludes_near_hits(case):
    """A hit at EPS <= t < 20*EPS counts in gpu semantics and not in cpu
    semantics: rays started just in front of the hits they found."""
    _, tables, _, o, d, _ = case
    inf = np.full(N_LANES, INF, np.float32)
    t, g, _, _ = _port(tables, o, d, inf, EPS)
    hit = g >= 0
    o2 = (o + d * (t - np.float32(10 * EPS))[:, None]).astype(np.float32)
    _, g_gpu, _, _ = _port(tables, o2[hit], d[hit], inf[hit], EPS)
    t_cpu, g_cpu, _, _ = _port(tables, o2[hit], d[hit], inf[hit], 20 * EPS)
    near = (g_gpu >= 0)
    assert near.mean() > 0.9
    assert ((g_cpu == -1) | (t_cpu >= np.float32(20 * EPS))).all()
    assert (g_cpu != g_gpu).mean() > 0.5


@pytest.mark.parametrize("t_min", [EPS, 20 * EPS])
def test_final_t_pruning_keeps_the_nearest_hit(case, t_min):
    """The invariant that lets the kernel visit boxes in any order under
    its running best: the walk pruned by each ray's final nearest t (a
    box reached at entry <= t) returns the same (t, gid, u, v), bitwise,
    as the walk pruned by the seed."""
    _, tables, _, o, d, seed = case
    ref = _port(tables, o, d, seed, t_min)
    t, g = ref[0], ref[1]
    assert (g >= 0).sum() > N_LANES // 10
    bound = np.where(g >= 0, np.nextafter(t, np.float32(np.inf)), seed).astype(np.float32)
    for ours, want in zip(_port(tables, o, d, bound, t_min), ref):
        np.testing.assert_array_equal(ours, want)


def _slab_numpy(o, d, boxes, bound):
    """(N, B) bool: every ray's slab test against every (B, 8) box in
    float32, reached at entry < bound."""
    dd = np.where(np.abs(d) < np.float32(EPS), np.where(d < 0, -np.float32(EPS), np.float32(EPS)),
                  d).astype(np.float32)
    f = np.float32(1.0) / dd
    with np.errstate(over="ignore"):  # padding boxes (+-3e38) overflow to +-inf, as on the card
        t0 = (boxes[None, :, 0:3] - o[:, None, :]) * f[:, None, :]
        t1 = (boxes[None, :, 3:6] - o[:, None, :]) * f[:, None, :]
    entry = np.minimum(t0, t1).max(axis=2)
    exit_ = np.maximum(t0, t1).min(axis=2)
    return (entry <= exit_) & (exit_ >= 0) & (entry < bound[:, None])


def _numpy_work(tables, o, d, t_best, t_min):
    """walk_work's counts by brute force: every live ray against every box
    of every level, a box counted where its parent is reached."""
    live = t_best >= np.float32(t_min)
    o, d = o[live], d[live]
    bound = np.nextafter(t_best[live], np.float32(np.inf))
    count = tables.count.numpy()
    sg = _slab_numpy(o, d, tables.sgbounds.numpy(), bound)
    sc_tested = np.repeat(sg, mk.SGROUP, axis=1)
    sc = _slab_numpy(o, d, tables.sbounds.numpy(), bound) & sc_tested
    cl_tested = np.repeat(sc, mk.GROUP, axis=1) & (count > 0)[None, :]
    cl = _slab_numpy(o, d, tables.bounds.numpy(), bound) & cl_tested
    return dict(rays=int(live.sum()), slab=[int(sg.size), int(sc_tested.sum()), int(cl_tested.sum())],
                tri=int((cl * count[None, :]).sum()))


def test_walk_work_matches_a_brute_count(case):
    """walk_work's slab and triangle tests, pruned by the final nearest t,
    equal a numpy count over every box; the seed's pruning needs more."""
    _, tables, _, o, d, seed = case
    t = _port(tables, o, d, seed, EPS)[0]
    work = mk.walk_work(_cols(o), _cols(d), torch.from_numpy(t), tables, t_min=EPS)
    assert work == _numpy_work(tables, o, d, t, EPS)
    assert work["rays"] == N_LANES - N_LANES // 4 and work["tri"] > 0
    by_seed = mk.walk_work(_cols(o), _cols(d), torch.from_numpy(seed), tables, t_min=EPS)
    assert by_seed["tri"] >= work["tri"] and by_seed["slab"][1] >= work["slab"][1]


def test_walk_work_dead_lanes_do_nothing(case):
    """Dead lanes (seeded -INF, so their final t is -INF) add no test."""
    _, tables, _, o, d, seed = case
    t = _port(tables, o, d, seed, EPS)[0]
    dead = seed == np.float32(-INF)
    work = lambda m: mk.walk_work(_cols(o[m]), _cols(d[m]), torch.from_numpy(t[m]), tables,
                                  t_min=EPS)
    assert work(dead) == dict(rays=0, slab=[0, 0, 0], tri=0)
    assert work(np.ones_like(dead)) == work(~dead)


def test_mesh_hit_refuses_other_devices(case):
    """CPU tensors run the plain walk, CUDA tensors the kernel; any other
    device raises rather than falling back."""
    _, tables, _, o, d, seed = case
    meta = lambda a: torch.empty(a.shape, dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        mk.mesh_hit(tuple(meta(c) for c in o.T), tuple(meta(c) for c in d.T), meta(seed),
                    tables, t_min=EPS)
