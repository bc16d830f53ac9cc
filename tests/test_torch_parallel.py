"""The port's parallel/ (torch.distributed, gloo on the CPU) against the
JAX package's parallel/ on this process's virtual devices.

The port's side runs in `python -m torch.distributed.run --standalone`
children (a free port each launch, so xdist workers do not collide) that
import neither jax nor the JAX package and assert so; each rank writes
its results to a directory, and the tests here read them. Four
launches, one after the other on a thread while the JAX references are
computed: 4 ranks as (tile 2, spp 2), 2 ranks as (2, 1), and the CLI on
2 ranks, a static and an animated scheme. The scene is test_parallel.py's
tiny 64x32 scheme (two spheres, a DiffSpec free triangle), its dict
copied into the worker.

Gates, each stated at its test: make_render_step within rtol = atol =
2e-4 of the JAX step (test_parallel.py:86) and bitwise the rank-order sum
of the port's one-process blocks; make_wavefront_render_step within 1e-4
of the JAX step (test_parallel.py:145); make_spp_sharded_step bitwise the
rank-order sum of its slices; make_train_step's loss within 1e-5
relative of the JAX step's and each gradient within relative L2 1e-3,
bitwise equal on the four ranks; the Renderer over two ranks on each of
its four drivers and on the mesh driver's instanced route (the fleet)
bitwise the rank-order sum of one-process slice renders (the fused
drivers also bitwise the one-process render at samples_per_launch n /
2), the two ranks' targets and table checksums
equal, `render(samples=5)` adding 5, a resume bitwise; the CLI on two
ranks writing, from rank 0 alone, the one-process CLI's PNG and frames.
"""
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from raytrace_tpu.models.camera import build_camera as jax_build_camera
from raytrace_tpu.models.scene import build_scene as jax_build_scene
from raytrace_tpu.parallel.distributed import make_render_step as jax_make_render_step
from raytrace_tpu.parallel.distributed import make_train_step as jax_make_train_step
from raytrace_tpu.parallel.distributed import \
    make_wavefront_render_step as jax_make_wavefront_render_step
from raytrace_tpu.parallel.mesh import _factor as jax_factor
from raytrace_tpu.parallel.mesh import make_mesh as jax_make_mesh
from raytrace_tpu.render.integrator import IntegratorParams as JaxParams
from raytrace_tpu.render.renderer import camera_to_arrays as jax_camera_to_arrays
from raytrace_tpu_torch.models.camera import build_camera
from raytrace_tpu_torch.models.config import parse_scheme
from raytrace_tpu_torch.models.scene import SceneTensors, build_scene
from raytrace_tpu_torch.parallel import multihost
from raytrace_tpu_torch.parallel.distributed import sample_slice
from raytrace_tpu_torch.parallel.mesh import _factor
from raytrace_tpu_torch.render.integrator import IntegratorParams
from raytrace_tpu_torch.render.renderer import Renderer, sample_batch
from test_parallel import _tiny_scheme
from test_torch_diff import CAM_FIELDS, rel_l2

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W, H = 64, 32
SEED = 7  # the train step's target
JAX_KW = dict(assured_depth=2, max_bounces=12)  # test_parallel.py's render params
TRAIN_KW = dict(assured_depth=2, max_bounces=4)  # and its train step's

# Run by the workers and by this process: the scenes and the tables'
# checksum. TINY is test_parallel.py's _tiny_scheme's dict, the port's
# Tagged in the JAX one's place; DRIVERS each Renderer driver's scheme
# and keywords (walled 32x16; the mesh path on a 2,048-triangle cut of
# the procedural surface, two 16x16 textures, at 32x16; "instanced": the
# fleet of 17 instances at 32x16 on the mesh path's instanced route), and
# DRIVER the driver each takes.
SHARED = r"""
import hashlib

from raytrace_tpu_torch.models import procedural
from raytrace_tpu_torch.models.config import ModelMember, Tagged, parse_scheme
from raytrace_tpu_torch.models.walled import walled_scheme

W, H = 64, 32
TINY = {
    "render_info": {
        "width": W, "height": H, "samps_per_pix": 4, "kd_tree_depth": 0,
        "rad_info": {"debug_single_ray": False, "dir_light_samp": False,
                     "russ_roull_info": {"assured_depth": 2, "max_thres": 0.5}},
        "use_gpu": True,
    },
    "cam": {"d": [0, 0, -5], "o": [0, 0, 0], "up": [0, 1, 0], "view_eulers": [0, 0, 0],
            "screen_width": 10.0, "screen_height": 5.0},
    "scene_members": [
        Tagged("Sphere", {"c": [0, 0, -12], "r": 3.0, "coloring": Tagged("Solid", [0.6, 0.2, 0.8]),
                          "mat": {"divert_ray": "Diff"}}),
        Tagged("Sphere", {"c": [0, 8, -12], "r": 4.0, "coloring": Tagged("Solid", [0, 0, 0]),
                          "mat": {"divert_ray": "Diff", "emissive": [5.0, 5.0, 5.0]}}),
        Tagged("FreeTriangle", {"verts": [[-8, -3, -16], [8, -3, -16], [0, 9, -16]],
                                "norm": [0, 0, 1], "rgb": [0.9, 0.9, 0.5],
                                "mat": {"divert_ray": Tagged("DiffSpec", {"diffp": 0.5})}}),
    ],
}


def mesh_scheme():
    s = procedural.a380_cam_scheme(32, 16, 4)
    s.scene_members.append(ModelMember(path="<surface>",
                                       loaded=[procedural.make_mesh(2048, 2, 16)]))
    return s


DRIVERS = {
    "fused": (walled_scheme(32, 16), {}),
    "plain": (walled_scheme(32, 16), dict(use_fused=False, use_wavefront=False)),
    "wavefront": (walled_scheme(32, 16), dict(mode="cpu")),
    "mesh_fused": (mesh_scheme(), {}),
    "instanced": (procedural.fleet_scheme(32, 16, 4), {}),
}
DRIVER = {name: "mesh_fused" if name == "instanced" else name for name in DRIVERS}


def checksum(module):
    h = hashlib.sha256()
    for name, b in sorted(module.named_buffers()):
        h.update(name.encode())
        h.update(b.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()
"""

# One torchrun child: `worker.py <out dir> <what> <seed>`; every rank
# writes <what>_<rank>.npz.
WORKER = SHARED + r"""
import os
import sys

import numpy as np
import torch

torch.set_num_threads(1)
import torch.distributed as dist

from raytrace_tpu_torch.models.camera import build_camera
from raytrace_tpu_torch.models.scene import SceneTensors, build_scene
from raytrace_tpu_torch.ops.raygen import camera_to_arrays
from raytrace_tpu_torch.parallel import distributed as D
from raytrace_tpu_torch.parallel import multihost
from raytrace_tpu_torch.parallel.mesh import make_mesh
from raytrace_tpu_torch.render.integrator import IntegratorParams
from raytrace_tpu_torch.render.renderer import Renderer, sample_batch
from raytrace_tpu_torch.utils import checkpoint as ckpt

out, what, seed = sys.argv[1], sys.argv[2], int(sys.argv[3])
assert multihost.init(device="cpu") and dist.get_backend() == "gloo"
rank, world = dist.get_rank(), dist.get_world_size()
scheme = parse_scheme(TINY)
cam = build_camera(scheme.cam, W, H)
scene = SceneTensors(build_scene(scheme), cam, 0.5)
flat = torch.arange(W * H, dtype=torch.int32)
xs, ys = flat % W, flat // W
params = IntegratorParams(assured_depth=2, max_bounces=12)
res = {}

if what == "mesh4":
    mesh = make_mesh(tile=2, spp=2, device_type="cpu")
    step, spp = D.make_render_step(mesh)
    assert spp == 2 and tuple(mesh.get_coordinate()) == (rank // 2, rank % 2)
    block = step(scene, params, xs, ys, 0, 2)
    res["block"] = block.numpy()
    res["render"] = D.gather_tiles(block, mesh).numpy()
    target = np.random.default_rng(seed).uniform(0.0, 1.0, (W * H, 3)).astype(np.float32)
    train = D.make_train_step(mesh, n_samples=1, loss_scale=2.0)
    loss, (g, gc) = train(scene, camera_to_arrays(cam, "cpu"),
                          IntegratorParams(differentiable=True, assured_depth=2, max_bounces=4),
                          xs, ys, 3, D.tile_block(torch.from_numpy(target), 2, rank // 2))
    res["loss"] = loss.detach().numpy()
    res.update({"g_" + k: v.numpy() for k, v in g.items()})
    res.update({"gc_" + k: v.numpy() for k, v in gc.items()})
    res["pod_shape"] = np.array(multihost.make_pod_mesh(device_type="cpu").shape)
elif what == "render2":
    mesh = make_mesh(device_type="cpu")
    wf, n = D.make_wavefront_render_step(mesh, W, pool=1024)
    assert n == 2 and mesh.shape == (2, 1)
    res["wavefront"] = wf(scene, params, xs, ys, 0, 2).numpy()

    def inner(sc, p, x, y, sample_base, n_samples):
        return sample_batch(sc, p, x, y, sample_base, n_samples)

    spp_step, n = D.make_spp_sharded_step(None, inner)
    res["spp_sharded"] = spp_step(scene, params, xs, ys, sample_base=0, n_samples=5).numpy()

    for name, (sch, kw) in DRIVERS.items():
        r = Renderer(sch, device="cpu", **kw)
        assert r.driver == DRIVER[name] and r.group is dist.group.WORLD, (name, r.driver)
        route = getattr(r.tables, "route", None)
        assert (route == "instanced") == (name == "instanced"), (name, route)
        digests = [None] * world
        dist.all_gather_object(digests, checksum(r.tables))
        assert len(set(digests)) == 1, (name, digests)
        res[name + "_checksum"] = np.array(digests[0])
        r.render(samples=4, progress=False)
        res[name + "_4"] = r.target.acc.copy()
        ck = os.path.join(out, f"ck_{name}_{rank}.npz")
        ckpt.save(ck, r.target)
        r.render(samples=5, progress=False)
        assert r.target.count == 9, r.target.count
        res[name + "_9"] = r.target.acc.copy()
        res[name + "_iterations"] = np.array(r.stats["iterations"])
        resumed = Renderer(sch, device="cpu", **kw)
        resumed.target = ckpt.load(ck)
        resumed.render(samples=5, progress=False)
        assert np.array_equal(resumed.target.acc, r.target.acc), name + ": resume"
    try:
        Renderer(DRIVERS["plain"][0], device="cpu", differentiable=True)
    except NotImplementedError:
        res["differentiable_refused"] = np.array(True)

np.savez(os.path.join(out, f"{what}_{rank}.npz"), **res)
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "raytrace_tpu")]
assert not bad, bad
dist.destroy_process_group()
"""

# the CLI under torchrun, then the same check of its modules
CLI = r"""
import sys

from raytrace_tpu_torch import cli

cli.main(sys.argv[1:])
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "raytrace_tpu")]
assert not bad, bad
"""

WALLED_YML = (
    "render_info: {width: 32, height: 16, samps_per_pix: 3,\n"
    "  rad_info: {russ_roull_info: {assured_depth: 3, max_thres: 0.5}}}\n"
    "cam: {d: [0, 0, -5], o: [0, -1, 0], up: [0, 1, 0], screen_width: 10, screen_height: 5}\n"
    "scene_members:\n"
    "- !Sphere {c: [0, 10, -15], r: 5, coloring: !Solid [0, 0, 0],\n"
    "   mat: {divert_ray: Diff, emissive: [5, 5, 5]}}\n"
    "- !Sphere {c: [-3, -1, -12], r: 1.5, coloring: !Solid [0.8, 0.3, 0.3],\n"
    "   mat: {divert_ray: Diff}}\n"
    "- !Sphere {c: [0, -510, -10], r: 500, coloring: !Solid [0.75, 0.75, 0.75],\n"
    "   mat: {divert_ray: Diff}}\n")

ANIM_YML = (  # two frames of a moving sphere
    "render_info: {width: 32, height: 16, samps_per_pix: 2, animation: true, framerate: 2,\n"
    "  rad_info: {russ_roull_info: {assured_depth: 3, max_thres: 0.5}}}\n"
    "cam: {d: [0, 0, -5], o: [0, -1, 0], up: [0, 1, 0], screen_width: 10, screen_height: 5}\n"
    "scene_members:\n"
    "- !Sphere {c: [0, 10, -15], r: 5, coloring: !Solid [0, 0, 0],\n"
    "   mat: {divert_ray: Diff, emissive: [5, 5, 5]}}\n"
    "- !Sphere {c: [-3, -1, -12], r: 1.5, coloring: !Solid [0.8, 0.3, 0.3],\n"
    "   mat: {divert_ray: Diff},\n"
    "   animation: {keyframes: [{translation: [-3, -1, -12], time: 0},\n"
    "                           {translation: [2, 0, -10], time: 1}]}}\n"
    "- !Sphere {c: [0, -510, -10], r: 500, coloring: !Solid [0.75, 0.75, 0.75],\n"
    "   mat: {divert_ray: Diff}}\n")

NS = {}
exec(SHARED, NS)  # TINY, DRIVERS, checksum in this process


def _launch(n, args, cwd):
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           f"--nproc-per-node={n}", *args]
    proc = subprocess.run(cmd, cwd=cwd, env=env, capture_output=True, text=True, timeout=400)
    assert proc.returncode == 0, \
        f"{args}: rc {proc.returncode}\n{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}"
    return proc.stdout


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The launches, one after the other on a thread started at the first
    test that asks, so that the JAX references are computed meanwhile:
    {"mesh4" / "render2": future of the ranks' results, a list by rank;
    "cli": future of (the static render's stdout, the animation's, the
    directory)}."""
    d = tmp_path_factory.mktemp("dist")
    (d / "worker.py").write_text(WORKER)
    (d / "cli_main.py").write_text(CLI)
    (d / "walled.yml").write_text(WALLED_YML)

    def ranks(what, n):
        _launch(n, [str(d / "worker.py"), str(d), what, str(SEED)], d)
        return [dict(np.load(d / f"{what}_{r}.npz")) for r in range(n)]

    def cli():
        out = _launch(2, [str(d / "cli_main.py"), str(d / "walled.yml"), "no_ui", "--device",
                          "cpu", "--out", str(d / "two.png"), "--checkpoint",
                          str(d / "two.npz")], d)
        (d / "anim").mkdir()
        (d / "anim.yml").write_text(ANIM_YML)
        anim = _launch(2, [str(d / "cli_main.py"), str(d / "anim.yml"), "no_ui", "--device",
                           "cpu"], d / "anim")
        return out, anim, d

    with ThreadPoolExecutor(1) as pool:
        yield {"mesh4": pool.submit(ranks, "mesh4", 4),
               "render2": pool.submit(ranks, "render2", 2), "cli": pool.submit(cli)}


def _jax_setup():
    js = _tiny_scheme()
    flat = np.arange(W * H, dtype=np.int32)
    return (jax_build_scene(js), jax_camera_to_arrays(jax_build_camera(js.cam, W, H)),
            jnp.asarray(flat % W), jnp.asarray(flat // W))


def _port_setup():
    s = parse_scheme(NS["TINY"])
    flat = torch.arange(W * H, dtype=torch.int32)
    return (SceneTensors(build_scene(s), build_camera(s.cam, W, H), 0.5), flat % W, flat // W)


def _slices(render, base, n, size):
    """The rank-order f32 sum of render(base + offset, count) over the
    ranks' sample_slice shares."""
    acc = None
    for r in range(size):
        off, cnt = sample_slice(n, size, r)
        part = render(base + off, cnt)
        acc = part if acc is None else acc + part
    return acc


def test_render_step_matches_jax(runs):
    """4 ranks as (tile 2, spp 2), 2 samples a rank, gathered: within
    rtol = atol = 2e-4 of the JAX step on make_mesh(devices[:4], 2, 2)
    (test_parallel.py:86); bitwise the port's one-process blocks, each
    the sum of its two spp ranks' sample_batch in rank order; every
    rank's gathered array the same."""
    jscene, jcam, jxs, jys = _jax_setup()
    step, _ = jax_make_render_step(jax_make_mesh(jax.devices()[:4], tile=2, spp=2), W, H)
    ref = np.asarray(step(jscene, jcam, JaxParams(**JAX_KW), jxs, jys, jnp.int32(0),
                          jnp.int32(2)))
    scene, xs, ys = _port_setup()
    p = IntegratorParams(**JAX_KW)
    half = W * H // 2
    own = torch.cat([sample_batch(scene, p, xs[b:b + half], ys[b:b + half], 0, 2)
                     + sample_batch(scene, p, xs[b:b + half], ys[b:b + half], 2, 2)
                     for b in (0, half)]).numpy()
    res = runs["mesh4"].result()
    for r, got in enumerate(res):
        np.testing.assert_array_equal(got["render"], res[0]["render"])
        np.testing.assert_array_equal(got["block"], own[(r // 2) * half:(r // 2 + 1) * half])
    np.testing.assert_array_equal(res[0]["render"], own)
    np.testing.assert_allclose(res[0]["render"], ref, rtol=2e-4, atol=2e-4)
    assert res[0]["render"].mean() > 0.01


def test_train_step_matches_jax(runs):
    """make_train_step on 4 ranks as (2, 2), one sample a rank, loss_scale
    2, sample base 3, a target from a seed (each rank its tile block),
    against the JAX make_train_step on make_mesh(devices[:4], 2, 2): the
    loss within 1e-5 relative, each gradient within relative L2 1e-3
    (exactly 0 where the JAX one is), and loss and gradients bitwise equal
    on the four ranks."""
    jscene, jcam, jxs, jys = _jax_setup()
    target = np.random.default_rng(SEED).uniform(0.0, 1.0, (W * H, 3)).astype(np.float32)
    step = jax_make_train_step(jax_make_mesh(jax.devices()[:4], tile=2, spp=2), W, H,
                               n_samples=1, loss_scale=2.0)
    jl, (jg, jgc) = step(jscene, jcam, JaxParams(differentiable=True, **TRAIN_KW), jxs, jys,
                         jnp.int32(3), jnp.asarray(target))
    res = runs["mesh4"].result()
    for got in res[1:]:
        assert set(got) == set(res[0])
        for k in got:
            if k.startswith(("g", "loss")):
                np.testing.assert_array_equal(got[k], res[0][k], err_msg=k)
    ours = res[0]
    assert abs(float(ours["loss"]) - float(jl)) <= 1e-5 * abs(float(jl))
    pairs = [(k, ours["g_" + k], np.asarray(jg[k])[: ours["g_" + k].shape[0]])
             for k in ("sph_c", "sph_r", "sph_rgb", "sph_emissive", "ft_v0", "ft_e1", "ft_e2",
                       "ft_norm", "ft_rgb", "ft_emissive")]
    pairs += [(k, ours["gc_" + k], np.asarray(getattr(jgc, k))) for k in CAM_FIELDS]
    for k, got, ref in pairs:
        assert np.isfinite(got).all(), k
        if np.abs(ref).max():
            assert rel_l2(got, ref) <= 1e-3, f"{k}: relative L2 {rel_l2(got, ref):.3e}"
        else:
            assert not np.abs(got).max(), k
    assert np.abs(ours["g_sph_emissive"]).max() > 0 and np.abs(ours["g_ft_rgb"]).max() > 0


def test_pod_mesh_keeps_spp_within_a_node(runs):
    """make_pod_mesh on 4 ranks of one node (LOCAL_WORLD_SIZE 4): the
    largest of 2, 4, 8 dividing it as the spp axis, (1, 4), on every
    rank (the JAX make_pod_mesh's rule on jax.local_device_count())."""
    assert [tuple(got["pod_shape"]) for got in runs["mesh4"].result()] == [(1, 4)] * 4


def test_wavefront_step_matches_jax(runs):
    """make_wavefront_render_step on 2 ranks (make_mesh: (2, 1)), pool
    1024, 2 samples a rank: within rtol = atol = 1e-4 of the JAX step on
    make_mesh(devices[:2]) (test_parallel.py:145); bitwise the rank-order
    sum of the port's one-process wavefront_batch slices; the same on
    both ranks."""
    from raytrace_tpu_torch.render.wavefront import wavefront_batch

    jscene, jcam, jxs, jys = _jax_setup()
    step, n = jax_make_wavefront_render_step(jax_make_mesh(jax.devices()[:2]), W, H, pool=1024)
    ref = np.asarray(step(jscene, jcam, JaxParams(**JAX_KW), jxs, jys, jnp.int32(0),
                          jnp.int32(2)))
    scene, xs, ys = _port_setup()
    p = IntegratorParams(**JAX_KW)
    own = _slices(lambda b, c: wavefront_batch(scene, p, xs, ys, b, c, W, 1024), 0, 4, 2).numpy()
    res = runs["render2"].result()
    np.testing.assert_array_equal(res[1]["wavefront"], res[0]["wavefront"])
    np.testing.assert_array_equal(res[0]["wavefront"], own)
    np.testing.assert_allclose(res[0]["wavefront"], ref, rtol=1e-4, atol=1e-4)


def test_spp_sharded_step_is_the_sum_of_its_slices(runs):
    """make_spp_sharded_step over the world of 2 with the plain
    sample_batch, 5 samples in all (ids 0-2 and 3-4): bitwise the
    rank-order sum of the one-process slices, on both ranks."""
    scene, xs, ys = _port_setup()
    p = IntegratorParams(**JAX_KW)
    own = _slices(lambda b, c: sample_batch(scene, p, xs, ys, b, c), 0, 5, 2).numpy()
    res = runs["render2"].result()
    for got in res:
        np.testing.assert_array_equal(got["spp_sharded"], own)


@pytest.mark.parametrize("name", ["fused", "plain", "wavefront", "mesh_fused", "instanced"])
def test_renderer_over_two_ranks(runs, name):
    """Renderer(group=the world of 2) on one driver (the fused ones
    through their plain versions; "instanced" the mesh driver on the
    fleet's instanced route, MeshTables.route): render(4) bitwise the rank-order sum
    of one-process renders of ids 0-1 and 2-3 (each a Renderer whose
    target count is the slice's first id), then render(samples=5)
    bitwise the earlier target plus that sum over ids 4-6 and 7-8; the
    two ranks' targets and tables' checksums equal (the checksums also
    this process's); the wavefront's iterations summed over the ranks.
    The fused drivers also equal the one-process render at
    samples_per_launch 2 bitwise, the others the one-process render(4)
    up to the order of the f32 sum (rtol 1e-6, atol 1e-6). The workers
    also held a resume from a checkpoint bitwise."""
    scheme, kw = NS["DRIVERS"][name]

    def one(base, n, stats=None):
        r = Renderer(scheme, device="cpu", **kw)
        r.target.count = base
        r.render(samples=n, progress=False)
        if stats is not None:
            stats.append(r.stats["iterations"])
        return r.target.acc

    iters = []
    ref4 = _slices(one, 0, 4, 2)
    ref9 = ref4 + _slices(lambda b, n: one(b, n, iters), 4, 5, 2)
    whole = Renderer(scheme, device="cpu", samples_per_launch=2, **kw)
    assert whole.driver == NS["DRIVER"][name]
    whole.render(samples=4, progress=False)
    res = runs["render2"].result()
    for got in res:
        np.testing.assert_array_equal(got[name + "_4"], ref4)
        np.testing.assert_array_equal(got[name + "_9"], ref9)
        assert str(got[name + "_checksum"]) == NS["checksum"](whole.tables)
        assert int(got[name + "_iterations"]) == sum(iters)
    if name in ("fused", "mesh_fused", "instanced"):
        np.testing.assert_array_equal(res[0][name + "_4"], whole.target.acc)
    else:
        np.testing.assert_allclose(res[0][name + "_4"], whole.target.acc, rtol=1e-6, atol=1e-6)
    assert ref4.mean() > 0.01


def test_differentiable_renderer_refuses_a_group(runs):
    """Renderer(differentiable=True) under a world of 2 raises
    NotImplementedError (the distributed differentiable path is
    make_train_step)."""
    assert all(bool(got.get("differentiable_refused")) for got in runs["render2"].result())


def test_cli_under_torchrun_writes_from_rank_zero(runs, tmp_path, capsys):
    """The CLI under torchrun on 2 ranks (gloo, --device cpu), 3 samples:
    one "saved" line (rank 0's), its PNG equal to the one-process CLI's
    of the same ids, its checkpoint holding the 3 samples."""
    from raytrace_tpu_torch import cli
    from raytrace_tpu_torch.utils import checkpoint as ckpt

    out, _, d = runs["cli"].result()
    saved = [line for line in out.splitlines() if "saved" in line]
    assert len(saved) == 1 and "2 ranks" in saved[0], out
    (tmp_path / "walled.yml").write_text(WALLED_YML)
    cli.main([str(tmp_path / "walled.yml"), "no_ui", "--device", "cpu", "--out",
              str(tmp_path / "one.png")])
    assert "ranks" not in capsys.readouterr().out
    one = np.asarray(Image.open(tmp_path / "one.png"))
    np.testing.assert_array_equal(np.asarray(Image.open(d / "two.png")), one)
    assert ckpt.load(str(d / "two.npz")).count == 3 and one[..., :3].max() > 0


def test_cli_animation_under_torchrun(runs):
    """An animation scheme through the CLI on 2 ranks: rank 0 alone
    reports and writes anim_frames/<i>.png (each the PNG of a one-process
    Renderer(frame).render(2), which over two ranks of one sample each
    has the same bits) and the video."""
    from raytrace_tpu_torch.models.animation import extract_frames
    from raytrace_tpu_torch.models.config import load_scheme
    from raytrace_tpu_torch.utils.image import encode_png

    _, out, d = runs["cli"].result()
    assert out.count("Number of frames: 2") == 1 and out.count("encoded") == 1, out
    work = d / "anim"
    assert sorted(os.listdir(work / "anim_frames")) == ["0.png", "1.png"]
    assert [p for p in os.listdir(work) if p.startswith("animation.")]
    for i, frame in enumerate(extract_frames(load_scheme(str(d / "anim.yml")), 2.0)):
        r = Renderer(frame, device="cpu")
        r.render(samples=2, progress=False)
        assert (work / "anim_frames" / f"{i}.png").read_bytes() == \
            encode_png(r.target.to_u8_rgba()), i


@pytest.mark.parametrize("n", range(1, 17))
def test_factor_matches_jax(n):
    assert _factor(n) == jax_factor(n)


def test_sample_slice_covers_every_id_once():
    for n in range(12):
        for size in (1, 2, 3, 4):
            shares = [sample_slice(n, size, r) for r in range(size)]
            ids = [i for off, cnt in shares for i in range(off, off + cnt)]
            assert ids == list(range(n)), (n, size, shares)
            assert max(c for _, c in shares) - min(c for _, c in shares) <= 1


def test_init_without_env_initialises_nothing(monkeypatch):
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.init(device="cpu") is False
    assert not torch.distributed.is_initialized()


def test_concurrent_builds_run_nvcc_once(tmp_path, monkeypatch):
    """kernels/build.py under its file lock: two builds at once (threads
    here, the ranks of a torchrun job on the card) compile once, the
    second loading the first's library (nvcc and the load faked)."""
    import threading
    import time

    from raytrace_tpu_torch.kernels import build

    calls = []

    def fake_nvcc(name, flags, src, so, log_path):
        calls.append(name)
        time.sleep(0.3)
        log_path.write_text("log")
        so.write_bytes(b"")
        return 0.3

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", fake_nvcc)
    monkeypatch.setattr(build.ctypes, "CDLL", lambda path: path)
    monkeypatch.setattr(build, "_LOADED", {})
    out = []
    threads = [threading.Thread(target=lambda: out.append(build.build("trace_kernel")))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert calls == ["trace_kernel"] and len(out) == 2
    assert out[0].path == out[1].path and out[0].log == out[1].log == "log"
    assert sorted(b.seconds for b in out) == [0.0, 0.3]
