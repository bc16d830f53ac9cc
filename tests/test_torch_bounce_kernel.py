"""The bounce kernels' plain versions (ops/bounce_kernel.py: the CUDA
entries bounce_prims and bounce_shade of csrc/bounce_kernel.cu run them
on CPU tensors) against the JAX integrator, and the integrator split
they rest on against its unsplit formulation.

- `prims_hit` (bounce_prims' plain version) against the JAX
  `closest_hit` on the mixed sphere / free-triangle scene with a
  duplicate sphere and a duplicate triangle (planted exact-t ties: the
  earlier row wins) and rays on the cpu guard's edge (20 EPS), in both
  semantics: kind and idx equal on every lane, t, u, v within 1e-4
  relative (XLA's FMA contraction on the CPU moves them by ulps).
- `shade_step` (bounce_shade's, with the hit and the shadow rays as the
  wavefront hands them over) against the JAX `_bounce_step` from the same
  mid-path lane state, in gpu and cpu semantics, cpu with direct-light
  sampling (walled, two emitters), under a sky, with debug_single_ray and
  on the textured, normal-mapped octahedra with direct-light sampling: the RNG words bitwise; every float within 1e-3
  relative on all but 0.5% of lanes (contraction flips knife-edge lanes).
- `closest_hit` / `_bounce_step`, split into prims_hit, mesh_of,
  merge_mesh, shadow_ray and shade_step, bitwise the unsplit parent
  formulation (kept below), and `Lanes._iteration` (bounce_prims ->
  mesh_hit -> bounce_shade -> assign, through the dispatchers' plain
  versions) bitwise the parent's iteration over the unsplit bounce: every
  buffer after every iteration, images and stats.
- bounce_prims with every emitter's shadow rays in its launch (a scene
  without mesh triangles) bitwise prims_reference then shadow_reference
  for each emitter, and the launches an iteration takes: that one in
  such a scene, and the emitters' own bounce_prims and mesh_hit launches
  in a mesh scene.
- On the card (`-m cuda`): each entry against its plain version on
  in-render lane states, bitwise, and the graphed render against the
  torch bounce's graph (Lanes._torch_iteration), bitwise.
"""
import copy

import numpy as np
import pytest
import torch

from raytrace_tpu_torch.models import procedural
from raytrace_tpu_torch.models.config import ModelMember, Tagged, parse_member
from raytrace_tpu_torch.models.walled import walled_scheme
from raytrace_tpu_torch.ops import bounce_kernel as bk
from raytrace_tpu_torch.ops import mesh_kernel as mk
from raytrace_tpu_torch.ops import raygen, rng
from raytrace_tpu_torch.ops.intersect import EPS, INF, triangle_tuv
from raytrace_tpu_torch.ops.texture import take
from raytrace_tpu_torch.render import integrator as itg
from raytrace_tpu_torch.render import wavefront as wf
from raytrace_tpu_torch.render.integrator import IntegratorParams
from raytrace_tpu_torch.render.renderer import Renderer

# The JAX package and the JAX-side test helpers are imported where the JAX
# tests run (`_jax`), so that the card's tests collect where JAX is absent
# (`python3 -m pytest --noconftest -m cuda tests/test_torch_bounce_kernel.py`).
W, H = 32, 16
ASSURED, MAX_BOUNCES = 2, 6


# --- the parent's unsplit closest_hit and _bounce_step, verbatim ----------


def _parent_closest_hit(scene, params, ro, rd, active=None):
    n = ro[0].shape[0]
    dev = ro[0].device
    t_best = torch.full((n,), INF, dtype=torch.float32, device=dev)
    kind = torch.zeros((n,), dtype=torch.int64, device=dev)
    idx = torch.zeros((n,), dtype=torch.int64, device=dev)
    bu = torch.zeros((n,), dtype=torch.float32, device=dev)
    bv = torch.zeros_like(bu)
    cpu = params.mode == "cpu"

    def guard(t):
        return torch.where(t >= itg.CPU_GUARD, t, torch.full_like(t, INF)) if cpu else t

    if scene.n_spheres:
        c = tuple(scene.sph_c[:, k:k + 1] for k in range(3))
        ts = guard(itg.sphere_t(ro, rd, c, scene.sph_r[:, None], params.mode))
        tmin, amin = ts.min(dim=0)
        better = tmin < t_best
        t_best = torch.where(better, tmin, t_best)
        kind = torch.where(better, itg.KIND_SPHERE, kind)
        idx = torch.where(better, amin, idx)

    if scene.n_free_tris:
        col = lambda a: tuple(a[:, k:k + 1] for k in range(3))
        ts, us, ws = triangle_tuv(*ro, *rd, col(scene.ft_v0), col(scene.ft_e1), col(scene.ft_e2))
        ts = guard(ts)
        tmin, amin = ts.min(dim=0)
        better = tmin < t_best
        t_best = torch.where(better, tmin, t_best)
        kind = torch.where(better, itg.KIND_FREETRI, kind)
        idx = torch.where(better, amin, idx)
        bu = torch.where(better, us.gather(0, amin[None])[0], bu)
        bv = torch.where(better, ws.gather(0, amin[None])[0], bv)

    if scene.n_mesh_tris:
        seed = t_best if active is None else torch.where(
            active, t_best, torch.full_like(t_best, itg.DEAD_SEED))
        tm, gm, um, vm = mk.mesh_hit(tuple(c.detach() for c in ro), tuple(c.detach() for c in rd),
                                     seed.detach(), scene.mesh,
                                     t_min=itg.CPU_GUARD if cpu else EPS)
        won = gm >= 0
        if params.differentiable:
            g = gm.long().clamp(min=0)
            tri = [take(getattr(scene, k), g).unbind(1) for k in ("mt_v0", "mt_e1", "mt_e2")]
            tm, um, vm = triangle_tuv(*ro, *rd, *tri)
        t_best = torch.where(won, tm, t_best)
        kind = torch.where(won, itg.KIND_MESHTRI, kind)
        idx = torch.where(won, gm.long(), idx)
        bu = torch.where(won, um, bu)
        bv = torch.where(won, vm, bv)
    return t_best, kind, idx, bu, bv


def _parent_bounce_step(scene, params, st):
    where3 = itg._where3
    ro, rd, active = st["ro"], st["rd"], st["active"]
    t, kind, idx, bu, bv = _parent_closest_hit(scene, params, ro, rd, active=active)
    if scene.n_mesh_tris:
        state, draws = rng.next_f32_n(st["rng"], 8, params.generator)
        u7 = draws[7]
    else:
        state, (u0, u1, u2, u3, u7) = rng.next_f32_n(st["rng"], 5, params.generator)
        draws = (u0, u1, u2, u3, u1, u2, u3, u7)
    hit = kind != itg.KIND_NONE
    sh = itg._shade_hit(scene, params, ro, rd, t, kind, idx, bu, bv, draws[:7])
    L, ci, inten = st["L"], st["ci"], st["inten"]
    zero = torch.zeros_like(t)
    ah = active & hit
    miss_rec = {}
    if itg.tracks_miss(scene, params):
        am = active & ~hit
        mw = tuple(c * inten for c in ci) if params.mode == "gpu" else ci
        miss_rec = dict(miss_d=where3(am, rd, st["miss_d"]), miss_w=where3(am, mw, st["miss_w"]))

    if params.mode == "gpu":
        add_em = ah & sh["has_em"]
        L = tuple(L[k] + torch.where(add_em, sh["emissive"][k] * ci[k] * inten, zero)
                  for k in range(3))
        ci = where3(add_em, tuple(ci[k] * sh["rgb"][k] for k in range(3)), ci)
        ci = where3(ah, tuple(ci[k] * sh["rgb"][k] for k in range(3)), ci)
        rr_kill = (st["bounce"] >= params.assured_depth) & (
            u7 > float(np.float32(params.max_thres)))
        term = ah & rr_kill
        inv = float(np.float32(1.0) / np.float32(params.max_thres))
        ci_rr = tuple(c * inv for c in ci)
        L = tuple(L[k] + torch.where(term, ci_rr[k] * inten, zero) for k in range(3))
        ci = where3(term, ci_rr, ci)
        survive = ah & ~rr_kill
        inten = torch.where(survive, inten * sh["weight"], inten)
    else:
        L = tuple(L[k] + torch.where(ah, sh["emissive"][k] * ci[k], zero) for k in range(3))
        rr_due = st["bounce"] > params.assured_depth
        rr_pass = torch.where(rr_due, u7 < itg.CPU_RR_THRES, True)
        atten = torch.where(rr_due, torch.full_like(zero, itg.CPU_RR_THRES), torch.ones_like(zero))
        survive = ah & rr_pass
        w = sh["weight"] / atten
        ci = where3(survive, tuple(ci[k] * (sh["rgb"][k] * w) for k in range(3)), ci)
    new_active = survive

    dls = itg.uses_dls(scene, params)
    if dls:
        pd = st["dls"]
        for e in scene.emitters:
            center, em = scene.sph_c[e].unbind(), scene.sph_emissive[e].unbind()
            d_l = raygen.normalize(*(center[k] - pd["pos"][k] for k in range(3)), eps=1e-20)
            light_dot = itg._dot(d_l, pd["norm"])
            omit = (pd["self_idx"] == e) | ((kind == itg.KIND_SPHERE) & (idx == e))
            cand = pd["active"] & (light_dot > 0.0) & ~omit
            _, ks, is_, _, _ = _parent_closest_hit(scene, params, pd["pos"], d_l, active=cand)
            ok = cand & (ks == itg.KIND_SPHERE) & (is_ == e)
            s = light_dot * itg.DLS_NORMZE
            L = tuple(L[k] + torch.where(ok, pd["ci"][k] * (em[k] * s), zero) for k in range(3))

    if params.debug_single_ray:
        sky = scene.sky.sample(*rd) if scene.sky is not None else (zero, zero, zero)
        L = tuple(torch.where(active & ~hit, sky[k], torch.where(ah, sh["emissive"][k], L[k]))
                  for k in range(3))
        new_active = torch.zeros_like(new_active)

    out = dict(ro=where3(new_active, sh["pos"], ro), rd=where3(new_active, sh["new_d"], rd),
               L=L, ci=ci, inten=inten, rng=state, active=new_active,
               bounce=st["bounce"] + new_active.to(torch.int32), **miss_rec)
    if dls:
        out["dls"] = dict(active=new_active & sh["should_dls"], pos=sh["pos"], norm=sh["norm"],
                          ci=ci, self_idx=torch.where(kind == itg.KIND_SPHERE, idx,
                                                      torch.full_like(idx, -1)))
    return out


# --- scenes and lane states -------------------------------------------------


def _jax():
    """The JAX package's pieces these tests hold the port against."""
    import types

    import jax.numpy as jnp

    from raytrace_tpu.models import config
    from raytrace_tpu.models.scene import build_scene
    from raytrace_tpu.ops.vec import Vec3
    from raytrace_tpu.render import integrator
    from test_torch_cubemap import add_sky, write_faces
    from test_torch_integrator import port_scene
    from test_torch_mesh_scene import octa_schemes, write_gltf
    from test_torch_scene import schemes

    return types.SimpleNamespace(
        jnp=jnp, cfg=config, build_scene=build_scene, Vec3=Vec3, Params=integrator.IntegratorParams,
        bounce_step=integrator._bounce_step, closest_hit=integrator.closest_hit, add_sky=add_sky,
        write_faces=write_faces, port_scene=port_scene, octa_schemes=octa_schemes,
        write_gltf=write_gltf, schemes=schemes)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """name -> (JAX scene, port SceneTensors): mixed, mixed with a copy of
    its first sphere and of its first free triangle appended (sphere 3,
    free triangle 3: exact-t ties with rows 0), walled (two emitters),
    mixed under a sky, the octahedra."""
    J = _jax()
    out = {}

    def add(name, js):
        jscene = J.build_scene(js)
        out[name] = (jscene, J.port_scene(jscene, js, W, H))

    add("mixed", J.schemes("mixed", W, H, ASSURED)[0])
    js, _ = J.schemes("mixed", W, H, ASSURED)
    spheres = [m for m in js.scene_members if isinstance(m, J.cfg.SphereMember)]
    tris = [m for m in js.scene_members if not isinstance(m, J.cfg.SphereMember)]
    js.scene_members = spheres + [copy.deepcopy(spheres[0])] + tris + [copy.deepcopy(tris[0])]
    add("ties", js)
    add("walled", J.schemes("walled", W, H, ASSURED)[0])
    js, _ = J.schemes("mixed", W, H, ASSURED)
    J.add_sky(js, J.cfg, J.cfg._parse_member, J.write_faces(tmp_path_factory.mktemp("faces")))
    add("sky", js)
    add("octahedra", J.octa_schemes(J.write_gltf(tmp_path_factory.mktemp("octa") / "m.gltf",
                                                  textured=True, normal_map=True), W, H)[0])
    return out


def _primary(scene):
    flat = torch.arange(W * H, dtype=torch.int32)
    xs, ys = flat % W, flat // W
    return raygen.generate_paths(rng.init_state(xs, ys, torch.full_like(xs, 3)), xs, ys,
                                 scene.cam, scene.has_lens)


def _mid_state(scene, params, bounces=2):
    """The lane state after `bounces` bounces of the frame's primary rays
    (`_bounce_step`): some lanes dead, pending direct-light terms, miss
    records."""
    state, ro, rd = _primary(scene)
    st = itg.init_lanes(scene, params, ro, rd, state)
    for _ in range(bounces):
        st = itg._bounce_step(scene, params, st)
    return st


def _v3(J, t):
    return J.Vec3(*(J.jnp.asarray(c.numpy()) for c in t))


def _to_jax(J, st):
    out = {}
    for k, v in st.items():
        if isinstance(v, dict):
            out[k] = _to_jax(J, v)
        elif isinstance(v, tuple):
            out[k] = _v3(J, v)
        elif k == "rng":
            out[k] = J.jnp.asarray(v.numpy().astype(np.uint32))
        elif k == "self_idx":
            out[k] = J.jnp.asarray(v.numpy().astype(np.int32))
        else:
            out[k] = J.jnp.asarray(v.numpy())
    return out


def _np(v):
    if hasattr(v, "x"):  # a JAX Vec3
        return np.stack([np.asarray(c) for c in (v.x, v.y, v.z)])
    if isinstance(v, tuple):
        return np.stack([c.numpy() for c in v])
    return np.asarray(v)


def _close_lanes(a, b, rtol):
    """The fraction of lanes (the last axis) where a and b are not within
    rtol relative (infinities equal, NaN equal)."""
    ok = np.isclose(a, b, rtol=rtol, atol=rtol * 1e-1, equal_nan=True)
    ok = ok.reshape(-1, a.shape[-1]).all(0)
    return 1.0 - ok.mean()


# --- prims_hit against the JAX closest_hit -----------------------------------


def _prims_rays(scene):
    """The frame's primary rays, one bounce's secondary rays, and eight
    rays toward free triangle 0's plane from points on its centroid's
    normal at 0.5, 0.99, 1.01 and 2 times the cpu guard (20 EPS), from
    both sides."""
    state, ro, rd = _primary(scene)
    params = IntegratorParams(mode="cpu", assured_depth=ASSURED, max_bounces=MAX_BOUNCES)
    st = itg._bounce_step(scene, params, itg.init_lanes(scene, params, ro, rd, state))
    o = [torch.cat([ro[k], st["ro"][k]]) for k in range(3)]
    d = [torch.cat([rd[k], st["rd"][k]]) for k in range(3)]
    v0, e1, e2 = (getattr(scene, k)[0].double() for k in ("ft_v0", "ft_e1", "ft_e2"))
    n = torch.linalg.cross(e1, e2)
    n = n / n.norm()
    c = v0 + (e1 + e2) / 3.0
    for s in (0.5, 0.99, 1.01, 2.0):
        for side in (1.0, -1.0):
            p = (c + side * n * (s * itg.CPU_GUARD)).float()
            for k in range(3):
                o[k] = torch.cat([o[k], p[k:k + 1]])
                d[k] = torch.cat([d[k], (-side * n[k:k + 1]).float()])
    return tuple(o), tuple(d)


@pytest.mark.parametrize("mode", ["gpu", "cpu"])
def test_prims_hit_matches_jax(scenes, mode):
    J = _jax()
    jscene, scene = scenes["ties"]
    ro, rd = _prims_rays(scene)
    n = ro[0].numel()
    active = torch.arange(n) % 7 != 3
    (t, kind, idx, bu, bv), seed = itg.prims_hit(scene, IntegratorParams(mode=mode), ro, rd,
                                                 active)
    jt, jk, ji, ju, jv = (np.asarray(a) for a in J.closest_hit(
        jscene, J.Params(mode=mode), _v3(J, ro), _v3(J, rd),
        active=J.jnp.asarray(active.numpy())))
    np.testing.assert_array_equal(kind.numpy(), jk)
    np.testing.assert_array_equal(idx.numpy(), ji)
    hit = kind.numpy() != itg.KIND_NONE  # a miss: the port's sentinel INF, JAX's inf
    np.testing.assert_allclose(t.numpy()[hit], jt[hit], rtol=1e-4)
    assert (t.numpy()[~hit] == INF).all() and (jt[~hit] > INF).all()
    hit = kind.numpy() == itg.KIND_FREETRI
    np.testing.assert_allclose(bu.numpy()[hit], ju[hit], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(bv.numpy()[hit], jv[hit], rtol=1e-4, atol=1e-5)
    assert torch.equal(seed, torch.where(active, t, torch.full_like(t, itg.DEAD_SEED)))
    # the planted ties: the copies (sphere 3, free triangle 3) never win,
    # their originals do
    sph, ft = kind == itg.KIND_SPHERE, kind == itg.KIND_FREETRI
    assert not bool((sph & (idx == 3)).any()) and not bool((ft & (idx == 3)).any())
    assert bool((sph & (idx == 0)).any()) and bool((ft & (idx == 0)).any())
    # the guard's edge: the last 8 rays, pairs at 0.5, 0.99, 1.01 and 2
    # guards from free triangle 0; cpu semantics drop the two nearer pairs
    own = (ft & (idx == 0))[n - 8:].view(4, 2)
    assert bool(own[2:].all())
    assert bool(own[:2].all()) if mode == "gpu" else not bool(own[:2].any())


# --- shade_step against the JAX _bounce_step ---------------------------------


CASES = {"gpu": ("mixed", dict(mode="gpu")), "cpu": ("mixed", dict(mode="cpu")),
         "cpu-dls": ("walled", dict(mode="cpu", dir_light_samp=True)),
         "sky": ("sky", dict(mode="cpu")), "sky-gpu": ("sky", dict(mode="gpu")),
         "debug": ("mixed", dict(mode="cpu", debug_single_ray=True)),
         "octahedra": ("octahedra", dict(mode="cpu", dir_light_samp=True))}


def _shade_plain(scene, params, st):
    """shade_step with the hit and the shadow rays as the wavefront's
    dispatchers hand them over (their plain versions)."""
    prims = bk.prims_reference(scene, params, st["ro"], st["rd"], st["active"])
    mesh = (itg.mesh_of(scene, params, st["ro"], st["rd"], prims[5]) if scene.n_mesh_tris
            else None)
    hit = bk._merged(scene, params, prims, mesh)
    terms = []
    if itg.uses_dls(scene, params):
        pd = st["dls"]
        for j, e in enumerate(scene.emitters):
            flag = torch.zeros_like(st["active"])
            d_l, seed = bk.shadow_reference(scene, params, pd, prims, mesh, j, flag)
            if mesh is not None:
                flag &= itg.mesh_of(scene, params, pd["pos"], d_l, seed)[1] < 0
            terms.append((itg.shadow_ray(scene, pd, hit[1], hit[2], e)[1], flag))
    return itg.shade_step(scene, params, st, hit, terms)


@pytest.mark.parametrize("case", list(CASES))
def test_shade_step_matches_jax(scenes, case):
    J = _jax()
    name, kw = CASES[case]
    jscene, scene = scenes[name]
    kw = dict(kw, assured_depth=ASSURED, max_bounces=MAX_BOUNCES)
    params = IntegratorParams(**kw)
    st = _mid_state(scene, params, bounces=0 if kw.get("debug_single_ray") else 2)
    assert 0 < int(st["active"].sum()) <= W * H
    out = _shade_plain(scene, params, st)
    ref = J.bounce_step(jscene, J.Params(**kw), _to_jax(J, st))
    assert set(out) == set(ref)
    np.testing.assert_array_equal(out["rng"].numpy().astype(np.uint32), np.asarray(ref["rng"]))
    for k in ("active", "bounce"):
        assert (out[k].numpy() != np.asarray(ref[k])).mean() <= 0.005, k
    for k in ("ro", "rd", "L", "ci", "inten", "miss_d", "miss_w"):
        if k in out:
            assert _close_lanes(_np(out[k]), _np(ref[k]), 1e-3) <= 0.005, k
    if "dls" in out:
        # the record is read where it is pending (a miss's point is ro + rd t
        # at the port's sentinel INF, JAX's inf giving ro)
        pend = out["dls"]["active"].numpy() | np.asarray(ref["dls"]["active"])
        assert pend.any() and (out["dls"]["active"].numpy() != np.asarray(
            ref["dls"]["active"])).mean() <= 0.005
        for k in ("pos", "norm", "ci"):
            assert _close_lanes(_np(out["dls"][k])[:, pend], _np(ref["dls"][k])[:, pend],
                                1e-3) <= 0.005, k
        assert (out["dls"]["self_idx"].numpy() != np.asarray(ref["dls"]["self_idx"])).mean() \
            <= 0.005
    if case == "cpu-dls":  # the direct-light terms reached some lanes
        plain = dict(kw, dir_light_samp=False)
        assert float(out["L"][0].sum()) > float(_shade_plain(
            scene, IntegratorParams(**plain), _mid_state(scene, IntegratorParams(**plain)))[
            "L"][0].sum())


# --- the split against the parent's formulation ------------------------------


def _walled_cases(tmp_path):
    """(scheme, Renderer keywords) of the iteration cases: walled in cpu
    semantics with direct-light sampling (two emitters), and with a
    diffuse free triangle under its small light besides; walled in gpu
    semantics; the 2,097-triangle surface with its textures in cpu
    semantics with direct-light sampling; outdoor spheres under a sky."""
    dls = walled_scheme(W, H, assured=2)
    dls.render_info.rad_info.dir_light_samp = True
    tri = walled_scheme(W, H, assured=2)
    tri.render_info.rad_info.dir_light_samp = True
    tri.scene_members.append(parse_member(Tagged("FreeTriangle", {
        "verts": [[-1.0, 0.3, -9.0], [3.0, 0.3, -9.0], [1.0, 0.3, -5.5]], "norm": [0, 1, 0],
        "rgb": [0.8, 0.8, 0.3], "mat": {"divert_ray": "Diff"}})))
    surf = procedural.a380_cam_scheme(W, H)
    surf.scene_members.append(ModelMember(path="<2,097-triangle surface>", loaded=[
        procedural.make_mesh(2097, n_textures=2, tex_size=16)]))
    surf.render_info = copy.copy(surf.render_info)
    surf.render_info.rad_info = copy.copy(surf.render_info.rad_info)
    surf.render_info.rad_info.dir_light_samp = True
    sky = procedural.outdoor_scheme(procedural.sky_cubemap(str(tmp_path), size=16), W, H)
    return {"walled-dls": (dls, dict(mode="cpu")), "walled-tri-dls": (tri, dict(mode="cpu")),
            "walled-gpu": (walled_scheme(W, H, assured=2), dict(mode="gpu", use_fused=False)),
            "surface-dls": (surf, dict(mode="cpu")), "sky": (sky, dict(mode="cpu"))}


def _equal_trees(a, b):
    for x, y in zip(wf._leaves(a), wf._leaves(b)):
        assert x.dtype == y.dtype and torch.equal(x, y)


@pytest.mark.parametrize("case", ["walled-dls", "walled-gpu", "surface-dls", "sky"])
def test_split_is_the_parent_formulation(case, tmp_path):
    scheme, kw = _walled_cases(tmp_path)[case]
    r = Renderer(scheme, device="cpu", samples_per_launch=2, **kw)
    scene, params = r.tables, r.params
    state, ro, rd = _primary(scene)
    st = itg.init_lanes(scene, params, ro, rd, state)
    for _ in range(4):
        active = st["active"] & (torch.arange(W * H) % 5 != 1)
        for a, b in zip(itg.closest_hit(scene, params, st["ro"], st["rd"], active),
                        _parent_closest_hit(scene, params, st["ro"], st["rd"], active)):
            assert torch.equal(a, b)
        new = itg._bounce_step(scene, params, st)
        _equal_trees(new, _parent_bounce_step(scene, params, st))
        st = new


@pytest.mark.parametrize("case", ["walled-dls", "walled-tri-dls", "walled-gpu", "surface-dls",
                                  "sky"])
def test_iteration_is_the_parent_iteration(case, tmp_path, monkeypatch):
    """Lanes._iteration against the parent's iteration (_torch_iteration
    over the parent's unsplit bounce), every buffer after every
    iteration, then the image and stats of a whole batch."""
    scheme, kw = _walled_cases(tmp_path)[case]
    r = Renderer(scheme, device="cpu", samples_per_launch=2, **kw)
    monkeypatch.setattr(wf, "_bounce_step", _parent_bounce_step)
    new = wf.Lanes(r.tables, r.params, r._xs, r._ys, 2, r.width, 256)
    old = wf.Lanes(r.tables, r.params, r._xs, r._ys, 2, r.width, 256)
    new._start(5)
    old._start(5)
    while bool(old.flag):
        new._iteration()
        old._torch_iteration()
        for a, b in ((new.st, old.st), ((new.unit, new.q, new.iters, new.lane_bounces, new.flag,
                                         new.slots[:-1]),
                                        (old.unit, old.q, old.iters, old.lane_bounces, old.flag,
                                         old.slots[:-1]))):
            _equal_trees(a, b)
    assert not bool(new.flag) and new.stats() == old.stats()
    assert torch.equal(new._image(), old._image())


# --- every emitter's shadow rays in bounce_prims' launch ----------------------


def _lanes(case, tmp_path):
    """The CPU lane pool of an iteration case, its first work handed out."""
    scheme, kw = _walled_cases(tmp_path)[case]
    r = Renderer(scheme, device="cpu", samples_per_launch=2, **kw)
    lanes = wf.Lanes(r.tables, r.params, r._xs, r._ys, 2, r.width, 256)
    lanes._start(0)
    return lanes


def _fused_and_plain(lanes):
    """bounce_prims with the shadow rays in its launch, and prims_reference
    then shadow_reference for each emitter, on the lanes' state: ((hit,
    flags), (hit, flags)); both flag buffers start True on every lane, so
    a row left unwritten shows."""
    scene, params, st = lanes.scene, lanes.params, lanes.st
    emitters, flags, _ = lanes.shadow
    fused, plain = torch.ones_like(flags), torch.ones_like(flags)
    hit = bk.bounce_prims(scene, params, st["ro"], st["rd"], st["active"],
                          shadow=(st["dls"], emitters, fused))
    ref = bk.prims_reference(scene, params, st["ro"], st["rd"], st["active"])
    for j in range(len(scene.emitters)):
        bk.shadow_reference(scene, params, st["dls"], ref, None, j, plain[j])
    return (hit, fused), (ref, plain)


@pytest.mark.parametrize("case", ["walled-dls", "walled-tri-dls"])
def test_fused_shadow_rays_are_prims_then_shadow_reference(case, tmp_path):
    lanes = _lanes(case, tmp_path)
    assert lanes.dls and not lanes.scene.n_mesh_tris
    pending = cast = 0
    for _ in range(6):
        (hit, fused), (ref, plain) = _fused_and_plain(lanes)
        for a, b in zip(hit, ref):
            assert a.dtype == b.dtype and torch.equal(a, b)
        assert torch.equal(fused, plain)
        pending += int(lanes.st["dls"]["active"].sum())
        cast += int(fused.sum())
        lanes._iteration()
    assert pending > 0 and cast > 0  # shadow rays were cast and some reached their emitter
    if case == "walled-tri-dls":
        assert int((ref[1] == itg.KIND_FREETRI).sum()) > 0


def test_fused_shadow_rays_refuse_a_mesh_scene(tmp_path):
    lanes = _lanes("surface-dls", tmp_path)
    st = lanes.st
    with pytest.raises(ValueError, match="mesh hit"):
        bk.bounce_prims(lanes.scene, lanes.params, st["ro"], st["rd"], st["active"],
                        shadow=(st["dls"], *lanes.shadow[:2]))


@pytest.mark.parametrize("case", ["walled-dls", "surface-dls"])
def test_iteration_launches_the_shadow_rays(case, tmp_path, monkeypatch):
    """Lanes._iteration's calls an iteration: without a mesh one
    bounce_prims with the shadow rays, no shadow_prims and no mesh_hit;
    with one the bounce_prims entry 1 + E times (bounce_prims and E
    shadow_prims) and mesh_hit 1 + E times (E of them the shadow rays')."""
    lanes = _lanes(case, tmp_path)
    calls = {"bounce_prims": 0, "fused": 0, "shadow_prims": 0, "mesh_of": 0, "shadow_mesh": 0}

    def counted(name, fn):
        def wrap(*args, **kw):
            calls[name] += 1
            if name == "bounce_prims":
                calls["fused"] += kw.get("shadow") is not None
            if name == "mesh_of":
                calls["shadow_mesh"] += "gid_out" in kw
            return fn(*args, **kw)
        return wrap

    monkeypatch.setattr(bk, "bounce_prims", counted("bounce_prims", bk.bounce_prims))
    monkeypatch.setattr(bk, "shadow_prims", counted("shadow_prims", bk.shadow_prims))
    monkeypatch.setattr(wf, "mesh_of", counted("mesh_of", wf.mesh_of))
    launches = dict(bk.LAUNCHES)
    n = 3
    for _ in range(n):
        lanes._iteration()
    e = len(lanes.scene.emitters)
    if case == "walled-dls":
        want = {"bounce_prims": n, "fused": n, "shadow_prims": 0, "mesh_of": 0, "shadow_mesh": 0}
    else:
        want = {"bounce_prims": n, "fused": 0, "shadow_prims": e * n, "mesh_of": (1 + e) * n,
                "shadow_mesh": e * n}
    assert e > 0 and calls == want
    assert bk.LAUNCHES == launches  # CPU tensors never reach the CUDA kernel


# --- on the card ---------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the bounce kernels build with nvcc and run on the card")


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["walled-dls", "walled-tri-dls", "walled-gpu", "surface-dls",
                                  "sky"])
def test_entries_match_their_plain_versions_on_the_card(case, tmp_path):
    _card()
    scheme, kw = _walled_cases(tmp_path)[case]
    r = Renderer(scheme, device="cuda", samples_per_launch=2, **kw)
    lanes = wf.Lanes(r.tables, r.params, r._xs, r._ys, 2, r.width, 256)
    lanes._start(0)
    scene, params = r.tables, r.params
    for _ in range(6):
        st = lanes.st
        act = st["active"]
        kp = bk.bounce_prims(scene, params, st["ro"], st["rd"], act)
        pp = bk.prims_reference(scene, params, st["ro"], st["rd"], act)
        for k, (a, b) in enumerate(zip(kp, pp)):
            assert torch.equal(a[act], b[act]) if k < 5 else torch.equal(a, b)
        mesh = itg.mesh_of(scene, params, st["ro"], st["rd"], kp[5]) if scene.n_mesh_tris else None
        shadows = [None, None]
        if lanes.dls:
            for s, fn in enumerate((bk.shadow_prims, bk.shadow_reference)):
                emitters, flags, gids = (t if t is None else t.clone() for t in lanes.shadow)
                for j in range(len(scene.emitters)):
                    d_l, seed = fn(scene, params, st["dls"], kp, mesh, j, flags[j])
                    if gids is not None:
                        itg.mesh_of(scene, params, st["dls"]["pos"], d_l, seed, gid_out=gids[j])
                shadows[s] = (emitters, flags, gids)
            assert torch.equal(shadows[0][1], shadows[1][1])
            if mesh is None:  # the launch the render takes: the shadow rays in bounce_prims'
                (hit, fused), (ref, plain) = _fused_and_plain(lanes)
                for k, (x, y) in enumerate(zip(hit, ref)):
                    assert torch.equal(x[act], y[act]) if k < 5 else torch.equal(x, y)
                assert torch.equal(fused, plain) and torch.equal(fused, shadows[1][1])
        a, b = wf._clone(st), wf._clone(st)
        sa, sb = lanes.slots.clone(), lanes.slots.clone()
        bk.bounce_shade(scene, params, a, kp, mesh, shadows[0], lanes.unit, sa, lanes.cap)
        bk.shade_reference(scene, params, b, kp, mesh, shadows[1], lanes.unit, sb, lanes.cap)
        for x, y in zip(wf._leaves(a), wf._leaves(b)):
            assert torch.equal(x, y) or bool(((x == y) | (x.isnan() & y.isnan())).all())
        assert torch.equal(sa[:-1], sb[:-1])
        lanes._iteration()


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["walled-dls", "walled-tri-dls", "surface-dls", "sky"])
def test_graphed_render_is_the_torch_bounce_graph(case, tmp_path, monkeypatch):
    _card()
    scheme, kw = _walled_cases(tmp_path)[case]
    out = {}
    steps, real_stats = [], wf.Lanes.stats

    def stats(self):  # each batch's steps
        steps.append(self.steps)
        return real_stats(self)

    monkeypatch.setattr(wf.Lanes, "stats", stats)
    for kind in ("kernels", "torch"):
        r = Renderer(scheme, device="cuda", samples_per_launch=2, **kw)
        real = wf.Lanes._iteration
        if kind == "torch":
            wf.Lanes._iteration = wf.Lanes._torch_iteration
        try:
            r.render(progress=False, samples=2)  # captures the graph
        finally:
            wf.Lanes._iteration = real
        for counts in (mk.LAUNCHES, bk.LAUNCHES):
            for k in counts:
                counts[k] = 0
        steps.clear()
        img = r.render(progress=False, samples=4)
        out[kind] = (img, dict(r.stats), dict(bk.LAUNCHES), sum(steps))
    (img, st, n, n_steps), (img_t, st_t, n_t, n_steps_t) = out["kernels"], out["torch"]
    np.testing.assert_array_equal(img, img_t)
    # a replay launches STEP_ITERATIONS iterations; walled's bounce_prims
    # takes the shadow rays in each of its launches, the surface's none
    launched = wf.STEP_ITERATIONS * n_steps
    assert st == st_t and n_steps == n_steps_t and n["bounce_shade"] == launched
    if case.startswith("walled"):
        assert n["bounce_prims"] == n["bounce_prims_dls"] == launched
    else:
        assert n["bounce_prims_dls"] == 0 and n["bounce_prims"] == launched * (
            1 + (len(r.tables.emitters) if case == "surface-dls" else 0))
    assert n_t.pop("lanes_assign") == n["lanes_assign"] > 0 and not any(n_t.values())
