"""The tie rule the cooperative mesh kernels must reproduce, on the CPU.

`mesh_trace` and `mesh_trace_brute` (csrc/mesh_kernel.cu) find the
nearest mesh hit of a warp's live rays with groups of G threads: each
thread scans its own rows in ascending order with strict-< updates, and
the group takes the lexicographically least (t, position) by a butterfly
of shuffles. The kernels must equal their plain versions bitwise, so the
plain versions' tie rule is pinned here at small sizes, with inputs made
from a numpy seed:
- `mesh_hit_brute` and `mesh_hit_walk` on tables with planted exact-t
  ties (duplicated triangles, triangles sharing an edge, rays aimed at
  the edges) return the least row / scan position, against a plain
  sequential numpy scan;
- a numpy emulation of the strided per-rank scan and the butterfly
  reduction, for G = 8, 16 and 32, equals `mesh_hit_brute` bitwise;
- `mesh_trace_reference` gives the same radiance on both routes on the
  octahedra and the 2,097-triangle surface, where no tie is planted;
- `MeshTables.route` is the walk for any mesh (a scene without instancing)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from raytrace_tpu_torch.models import procedural
from raytrace_tpu_torch.models.camera import build_camera
from raytrace_tpu_torch.models.config import ModelMember
from raytrace_tpu_torch.models.scene import build_scene
from raytrace_tpu_torch.ops import mesh_kernel as mk
from raytrace_tpu_torch.ops.intersect import EPS, INF, triangle_tuv
from test_torch_mesh_scene import octa_schemes, surface_scene, write_gltf

N_RAYS = 768
WIDTH = 8  # rows per cluster of the planted walk table
GROUPS = (8, 16, 32)  # threads per ray the kernels may be built with


def _planted(seed=5):
    """(v0, e1, e2) (M, 3) f32 of a triangle soup in front of the origin with
    planted exact-t ties: pairs sharing an edge, and copies of earlier
    triangles (bitwise the same arithmetic, so bitwise the same t)."""
    g = np.random.default_rng(seed)
    n = 48
    v0 = np.stack([g.uniform(-2, 2, n), g.uniform(-2, 2, n), g.uniform(-7, -4, n)], 1)
    e1 = g.normal(0, 0.6, (n, 3)) * np.array([1, 1, 0.2])
    e2 = g.normal(0, 0.6, (n, 3)) * np.array([1, 1, 0.2])
    # every other triangle gets a neighbour across its edge v0 -- v0 + e1
    k = np.arange(0, n, 2)
    nv0, ne1, ne2 = v0[k] + e1[k], -e1[k], e2[k] - e1[k] - 0.5 * e2[k]
    v0, e1, e2 = (np.concatenate(p) for p in ((v0, nv0), (e1, ne1), (e2, ne2)))
    # copies of a third of them, appended in shuffled order
    dup = g.choice(len(v0), len(v0) // 3, replace=False)
    v0, e1, e2 = (np.concatenate([a, a[dup]]) for a in (v0, e1, e2))
    return v0.astype(np.float32), e1.astype(np.float32), e2.astype(np.float32)


def _rays(v0, e1, e2, seed=9):
    """Rays from near the origin: half at random points of random
    triangles, half at the midpoints of their v0 -- v0 + e1 edges (the
    shared ones among them); seeds INF, a finite t, or -INF (dead)."""
    g = np.random.default_rng(seed)
    pick = g.integers(0, len(v0), N_RAYS)
    a, b = g.uniform(0, 1, N_RAYS), g.uniform(0, 1, N_RAYS)
    flip = a + b > 1
    a, b = np.where(flip, 1 - a, a), np.where(flip, 1 - b, b)
    edge = np.arange(N_RAYS) % 2 == 1
    a, b = np.where(edge, 0.5, a), np.where(edge, 0.0, b)
    target = v0[pick] + a[:, None] * e1[pick] + b[:, None] * e2[pick]
    o = g.normal(0, 0.05, (N_RAYS, 3))
    d = target - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    seed_t = np.where(np.arange(N_RAYS) % 5 == 4, np.float32(5.0), np.float32(INF))
    seed_t = np.where(np.arange(N_RAYS) % 7 == 6, np.float32(-INF), seed_t)
    return o.astype(np.float32), d.astype(np.float32), seed_t.astype(np.float32)


def _cols(a):
    return tuple(torch.from_numpy(np.ascontiguousarray(c)) for c in a.T)


def _tuv(o, d, v0, e1, e2):
    """triangle_tuv of every ray against every row: (N, M) t, u, v numpy,
    t INF on a miss (the arithmetic of the kernels' tri_hit)."""
    ray = [c[:, None] for c in (*_cols(o), *_cols(d))]
    t, u, v = triangle_tuv(*ray, *(tuple(torch.from_numpy(c[None, :]) for c in x.T)
                                   for x in (v0, e1, e2)))
    return t.numpy(), u.numpy(), v.numpy()


def _sequential(t, u, v, seed, t_min=EPS):
    """The plain sequential scan: rows in order, strict <, a hit at
    t_min <= t < seed. Returns (t, row (-1: none), u, v) per ray."""
    n = len(seed)
    bt, row = seed.copy(), np.full(n, -1)
    bu, bv = np.zeros(n, np.float32), np.zeros(n, np.float32)
    for w in range(t.shape[1]):
        better = (t[:, w] >= t_min) & (t[:, w] < bt)
        bt = np.where(better, t[:, w], bt)
        row = np.where(better, w, row)
        bu, bv = np.where(better, u[:, w], bu), np.where(better, v[:, w], bv)
    return bt, row, bu, bv


def _brute_tables(v0, e1, e2, perm_seed=3):
    """The brute table of these rows (mk.pack_brute_table's layout: zero
    rows to a BRUTE_CHUNK multiple, gid -1) with ids shuffled, so the
    winning row shows in the gid."""
    m = len(v0)
    cl_idx = np.random.default_rng(perm_seed).permutation(m).astype(np.int32)[None, :]
    tri, gid = mk.pack_brute_table(cl_idx, v0[None], e1[None], e2[None])
    return SimpleNamespace(btri=torch.from_numpy(tri), bgid=torch.from_numpy(gid))


def _planted_ties(o, d, seed, t):
    """Rays whose least t below their seed is held by two rows or more."""
    tt = np.where((t >= EPS) & (t < seed[:, None]), t, np.inf)
    least = tt.min(axis=1)
    return int(((tt == least[:, None]).sum(axis=1) > 1)[np.isfinite(least)].sum())


def test_brute_ties_to_the_least_row():
    v0, e1, e2 = _planted()
    o, d, seed = _rays(v0, e1, e2)
    tables = _brute_tables(v0, e1, e2)
    tri = tables.btri.numpy()
    t, u, v = _tuv(o, d, tri[:, 0:3], tri[:, 3:6], tri[:, 6:9])
    assert _planted_ties(o, d, seed, t) > N_RAYS // 10  # the ties are there
    rt, row, ru, rv = _sequential(t, u, v, seed)
    bt, bg, bu, bv = (a.numpy() for a in mk.mesh_hit_brute(_cols(o), _cols(d),
                                                             torch.from_numpy(seed), tables))
    gid = tables.bgid.numpy()
    assert (row >= 0).sum() > N_RAYS // 2
    np.testing.assert_array_equal(bg, np.where(row >= 0, gid[row], -1))
    for ours, ref in ((bt, rt), (bu, ru), (bv, rv)):
        np.testing.assert_array_equal(ours, ref)


def _walk_tables(v0, e1, e2, cam_o=(0.0, 0.0, 0.0)):
    """The walk's tables of these rows, WIDTH a cluster in row order (the
    last cluster partly padding), through mk.pack_mesh_tables; boxes grown
    by 1e-3 so every hit point lies well inside its cluster's box."""
    m = len(v0)
    c = -(-m // WIDTH)
    cl_idx = np.full((c, WIDTH), -1, np.int32)
    cl_idx.reshape(-1)[:m] = np.arange(m)
    pad = lambda a: np.concatenate([a, np.zeros((c * WIDTH - m, 3), np.float32)]).reshape(
        c, WIDTH, 3)
    pv0, pe1, pe2 = pad(v0), pad(e1), pad(e2)
    corners = np.stack([pv0, pv0 + pe1, pv0 + pe2], 2).reshape(c, WIDTH * 3, 3)
    valid = np.repeat(cl_idx >= 0, 3, axis=1)[..., None]
    lo = np.where(valid, corners, np.inf).min(axis=1) - 1e-3
    hi = np.where(valid, corners, -np.inf).max(axis=1) + 1e-3
    packed = mk.pack_mesh_tables(cl_idx, lo.astype(np.float32), hi.astype(np.float32),
                                 pv0, pe1, pe2, cam_o=np.asarray(cam_o, np.float32))
    return SimpleNamespace(**{k: torch.from_numpy(a) for k, a in packed.items()})


@pytest.mark.parametrize("t_min", [EPS, 20 * EPS])
def test_walk_ties_to_the_least_scan_position(t_min):
    v0, e1, e2 = _planted()
    o, d, seed = _rays(v0, e1, e2)
    tables = _walk_tables(v0, e1, e2)
    rows = tables.tri.numpy().reshape(-1, mk.TRI_COLS)  # scan positions c * W + w
    gid = tables.gid.numpy().reshape(-1)
    t, u, v = _tuv(o, d, rows[:, 0:3], rows[:, 3:6], rows[:, 6:9])
    t = np.where(gid[None, :] >= 0, t, np.float32(INF))  # rows past a cluster's count
    assert _planted_ties(o, d, seed, t) > N_RAYS // 10
    rt, pos, ru, rv = _sequential(t, u, v, seed, t_min=np.float32(t_min))
    wt, wg, wu, wv = (a.numpy() for a in mk.mesh_hit_walk(
        _cols(o), _cols(d), torch.from_numpy(seed), tables, t_min=float(np.float32(t_min))))
    assert (pos >= 0).sum() > N_RAYS // 2
    np.testing.assert_array_equal(wg, np.where(pos >= 0, gid[pos], -1))
    for ours, ref in ((wt, rt), (wu, ru), (wv, rv)):
        np.testing.assert_array_equal(ours, ref)


def _group_scan(t, u, v, seed, g):
    """The kernels' cooperative nearest hit, emulated: rank r of a group of
    g threads scans rows r, r + g, ... in ascending order with strict-<
    updates seeded (seed, -1); then g / 2, g / 4, ..., 1: each thread takes
    its partner's (t, row, u, v) where that is lexicographically less.
    Returns (t, row, u, v) of rank 0 per ray."""
    n, m = t.shape
    ct = np.repeat(seed[:, None], g, axis=1)
    cp = np.full((n, g), -1)
    cu, cv = np.zeros((n, g), np.float32), np.zeros((n, g), np.float32)
    for k in range(0, m, g):
        w = k + np.arange(g)
        tk = t[:, w]
        better = tk < ct
        ct = np.where(better, tk, ct)
        cp = np.where(better, w[None, :], cp)
        cu, cv = np.where(better, u[:, w], cu), np.where(better, v[:, w], cv)
    rank = np.arange(g)
    sh = g // 2
    while sh:
        ot, op, ou, ov = (a[:, rank ^ sh] for a in (ct, cp, cu, cv))
        take = (ot < ct) | ((ot == ct) & (op < cp))
        ct, cp = np.where(take, ot, ct), np.where(take, op, cp)
        cu, cv = np.where(take, ou, cu), np.where(take, ov, cv)
        sh //= 2
    assert (ct == ct[:, :1]).all() and (cp == cp[:, :1]).all()  # every rank agrees
    return ct[:, 0], cp[:, 0], cu[:, 0], cv[:, 0]


@pytest.fixture(scope="module")
def brute_cases():
    """(label, tables, o, d, seed, t, u, v): the planted table, and the
    2,097-triangle surface's brute table under rays from its camera."""
    v0, e1, e2 = _planted()
    planted = _brute_tables(v0, e1, e2)
    cases = [("planted", planted, *_rays(v0, e1, e2))]
    scene, surface = _surface_tables(2097)
    g = np.random.default_rng(11)
    cam_o = np.asarray(build_camera(procedural.a380_cam_scheme(32, 16).cam, 32, 16).o,
                       np.float32)
    o = np.repeat(cam_o[None], N_RAYS, 0) + g.normal(0, 0.01, (N_RAYS, 3)).astype(np.float32)
    tri = surface.btri.numpy()[: scene.n_mesh_tris]
    target = tri[g.integers(0, len(tri), N_RAYS), 0:3] + g.normal(0, 0.3, (N_RAYS, 3))
    d = target - o
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    cases.append(("surface-2097", surface, o, d, np.full(N_RAYS, INF, np.float32)))
    out = []
    for label, tables, o, d, seed in cases:
        tri = tables.btri.numpy()
        out.append((label, tables, o, d, seed,
                    *_tuv(o, d, tri[:, 0:3], tri[:, 3:6], tri[:, 6:9])))
    return out


@pytest.mark.parametrize("g", GROUPS)
def test_group_scan_emulation_equals_brute(brute_cases, g):
    for label, tables, o, d, seed, t, u, v in brute_cases:
        assert tables.btri.shape[0] % g == 0
        et, row, eu, ev = _group_scan(t, u, v, seed, g)
        bt, bg, bu, bv = (a.numpy() for a in mk.mesh_hit_brute(
            _cols(o), _cols(d), torch.from_numpy(seed), tables))
        assert (bg >= 0).sum() > N_RAYS // 4, label
        np.testing.assert_array_equal(bg, np.where(row >= 0, tables.bgid.numpy()[row], -1),
                                      err_msg=label)
        for ours, ref in ((bt, et), (bu, eu), (bv, ev)):
            np.testing.assert_array_equal(ours, ref, err_msg=label)


def _scene_tables(name, tmp_path_factory):
    w, h = 32, 16
    if name == "octahedra":
        path = write_gltf(tmp_path_factory.mktemp("octa") / "m.gltf", textured=True,
                          normal_map=True)
        _, ps = octa_schemes(path, w, h)
        scene, assured = build_scene(ps), 3
    else:
        _, scene, _, ps = surface_scene(2097, w, h)
        assured = 5
    return mk.MeshTables(scene, build_camera(ps.cam, w, h), 0.5), w, h, assured


def _surface_tables(n, w=32, h=16):
    """MeshTables of the procedural surface cut to n triangles (none: no
    mesh member)."""
    scheme = procedural.a380_cam_scheme(w, h)
    if n:
        scheme.scene_members.append(ModelMember(
            path="<surface>", loaded=[procedural.make_mesh(n, n_textures=0)]))
    scene = build_scene(scheme)
    assert scene.n_mesh_tris == n
    return scene, mk.MeshTables(scene, build_camera(scheme.cam, w, h), 0.5)


@pytest.mark.parametrize("extra", [0, 1], ids=["at-the-gate", "past-the-gate"])
def test_route_at_the_gate(extra):
    """No mesh takes the brute route unasked: MeshTables refuses a scene
    without a mesh (0 triangles), and any mesh, down to 1 triangle, takes
    the walk."""
    if extra == 0:
        with pytest.raises(ValueError, match="needs a scene with a mesh"):
            _surface_tables(0)
        return
    _, tables = _surface_tables(extra)
    assert tables.route == "walk"


@pytest.mark.parametrize("name", ["octahedra", "surface-2097"])
def test_reference_routes_agree(tmp_path_factory, name):
    tables, w, h, assured = _scene_tables(name, tmp_path_factory)
    flat = torch.arange(w * h, dtype=torch.int32)
    xs, ys = flat % w, flat // w
    out = {r: torch.stack(mk.mesh_trace_reference(xs, ys, torch.full_like(xs, 3), tables,
                                                  route=r, assured=assured, max_bounces=8,
                                                  samples_per_lane=2))
           for r in ("walk", "brute")}  # the routes of every mesh scene
    assert float(out["walk"].mean()) > 0.0
    assert torch.equal(out["walk"], out["brute"])
