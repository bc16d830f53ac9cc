"""The fused path-tracing kernel for sphere + free-triangle scenes.

Port of `raytrace_tpu/ops/pallas/trace_kernel.py`. One `trace_tiles`
call runs the whole gpu-semantics path of every lane: counter-RNG seed,
camera raygen, brute-force closest hit over <= 64 spheres and <= 64
free triangles, BSDF sampling, Russian roulette, and in-place
regeneration of `samples_per_lane` consecutive sample ids. It returns
the lane's radiance sum and its last miss record (direction, weight).

- On a CUDA tensor, `trace_tiles` launches the hand-written kernel
  `csrc/trace_kernel.cu` (built by kernels/build.py) or raises: its
  entry `trace_tiles`. `_trace_tiles_per_thread` launches the kernel's
  first design, the yardstick `chip_smoke.py` times it against; no
  render launches it.
- On a CPU tensor, it runs `trace_tiles_reference`, the plain torch
  version of the same function, which the CPU tests hold against the
  JAX kernel and `chip_smoke.py` holds the CUDA kernel against.

Draws come from the default `weyl` counter generator (ops/rng.py).
Not ported: the TPU hardware RNG (`hw_rng`), `block_cols` and the
(8, 128) lane tiling, and `SceneHints` (hints only delete identity
selects; the CUDA kernel implements the permissive semantics).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
from torch import nn

from . import raygen, rng
from .bsdf import uniform_bsdf
from .intersect import EPS, closest_sph_ft, sphere_disc

MAX_PRIMS = 64  # per kind; the kernel keeps both tables in shared memory
SPH_COLS, FT_COLS, CAM_LEN, N_OUT = 15, 23, 18, 9

# launches of the CUDA kernel's `trace_tiles` entry in this process (read by chip_smoke.py)
LAUNCHES = 0


# --- host-side packing (bit-equal to the JAX package's) -------------------


def _sph_dirty(s: np.ndarray):
    return dict(
        rgb=(s[:, 4:7] != 0.0).any(1), em=(s[:, 7:11] != 0.0).any(1),
        kind=s[:, 11] != 0.0, shape=(s[:, 0:3] != 0.0).any(1),
        diffp=s[:, 12] != 0.0, n=(s[:, 13] != 1.0) | (s[:, 14] != 1.0),
    )


def _ft_dirty(f: np.ndarray):
    return dict(
        rgb=(f[:, 12:15] != 0.0).any(1), em=(f[:, 15:19] != 0.0).any(1),
        kind=f[:, 19] != 0.0, shape=(f[:, 9:12] != 0.0).any(1),
        diffp=f[:, 20] != 0.0, n=(f[:, 21] != 1.0) | (f[:, 22] != 1.0),
    )


def _richness_order(dirty: dict) -> np.ndarray:
    """The JAX packer's row order (trace_kernel.py:190-204): attribute-
    poor rows first, stable. It decides exact-t tie-breaks, so the port
    keeps it although it has no select chains to shorten."""
    score = (4 * dirty["em"].astype(int) + dirty["kind"].astype(int)
             + dirty["diffp"].astype(int) + 2 * dirty["n"].astype(int)
             + 3 * dirty["rgb"].astype(int) + 3 * dirty["shape"].astype(int))
    return np.argsort(score, kind="stable")


def pack_scene_tables(scene):
    """SceneArrays -> (sph_table (max(S,1), 15), ft_table (max(F,1), 23))
    numpy f32, rows in the JAX packer's order."""
    S, F = int(scene.n_spheres), int(scene.n_free_tris)
    sph = np.zeros((max(S, 1), SPH_COLS), np.float32)
    if S:
        sph[:S, 0:3] = scene.sph_c[:S]
        sph[:S, 3] = scene.sph_r[:S]
        sph[:S, 4:7] = scene.sph_rgb[:S]
        sph[:S, 7:10] = scene.sph_emissive[:S]
        sph[:S, 10] = scene.sph_has_em[:S]
        sph[:S, 11] = scene.sph_kind[:S]
        sph[:S, 12] = scene.sph_diffp[:S]
        sph[:S, 13] = scene.sph_n_out[:S]
        sph[:S, 14] = scene.sph_n_in[:S]
        sph[:S] = sph[_richness_order(_sph_dirty(sph[:S]))]
    ft = np.zeros((max(F, 1), FT_COLS), np.float32)
    if F:
        ft[:F, 0:3] = scene.ft_v0[:F]
        ft[:F, 3:6] = scene.ft_e1[:F]
        ft[:F, 6:9] = scene.ft_e2[:F]
        ft[:F, 9:12] = scene.ft_norm[:F]
        ft[:F, 12:15] = scene.ft_rgb[:F]
        ft[:F, 15:18] = scene.ft_emissive[:F]
        ft[:F, 18] = scene.ft_has_em[:F]
        ft[:F, 19] = scene.ft_kind[:F]
        ft[:F, 20] = scene.ft_diffp[:F]
        ft[:F, 21] = scene.ft_n_out[:F]
        ft[:F, 22] = scene.ft_n_in[:F]
        ft[:F] = ft[_richness_order(_ft_dirty(ft[:F]))]
    return sph, ft


def make_cam_vec(cam, max_thres: float = 0.5) -> np.ndarray:
    """(1, 18) f32: o, d, up, right, x_cf, y_cf, x_off, y_off, lens_r,
    max_thres."""
    v = np.zeros((1, CAM_LEN), np.float32)
    v[0, 0:3] = cam.o
    v[0, 3:6] = cam.d
    v[0, 6:9] = cam.up
    v[0, 9:12] = cam.right
    v[0, 12] = float(cam.x_cf)
    v[0, 13] = float(cam.y_cf)
    v[0, 14] = float(cam.x_off)
    v[0, 15] = float(cam.y_off)
    v[0, 16] = float(cam.lens_r) if cam.lens_r is not None else 0.0
    v[0, 17] = float(max_thres)
    return v


def supports(scene, params) -> bool:
    """gpu semantics, spheres + free triangles only, each <= 64, and no
    mesh (the JAX package's trace_kernel.supports, :704-712)."""
    return (
        params.mode == "gpu"
        and not params.debug_single_ray
        and scene.n_mesh_tris == 0
        and scene.n_spheres <= MAX_PRIMS
        and scene.n_free_tris <= MAX_PRIMS
    )


class SceneTables(nn.Module):
    """The packed scene and camera as buffers, moved with `.to(device)`."""

    def __init__(self, scene, cam, max_thres: float):
        super().__init__()
        sph, ft = pack_scene_tables(scene)
        self.register_buffer("sph", torch.from_numpy(sph))
        self.register_buffer("ft", torch.from_numpy(ft))
        self.register_buffer("cam_vec", torch.from_numpy(make_cam_vec(cam, max_thres)))
        self.n_sph = int(scene.n_spheres)
        self.n_ft = int(scene.n_free_tris)
        self.has_lens = cam.lens_r is not None


# --- the plain torch version ----------------------------------------------


BRANCHES = ("miss", "diffuse", "mirror", "dielectric", "roulette")  # codes 0-4 of `return_iters`


def trace_tiles_reference(xs, ys, samp, sph_table, ft_table, cam_vec, *,
                          n_sph: int, n_ft: int, has_lens: bool, assured: int,
                          max_bounces: int, samples_per_lane: int = 1,
                          return_iters: bool = False):
    """Plain torch mirror of the JAX `_kernel` (:408-662) on flat lanes:
    masked `torch.where` updates and a Python loop bounded by
    max_bounces * samples_per_lane that stops once no lane is active.
    Returns 9 f32 tensors shaped like xs: L rgb, miss_dir xyz, miss_w rgb
    (the miss records are last-write-wins: meaningful at spl == 1).

    return_iters (measurement, like `mesh_kernel.walk_work`): also return
    (iters, branch, roots): iters, int32 shaped like xs, the loop
    iterations each lane was active in (one bounce of one of its samples
    each); branch, int8 (iterations, N), the way each active lane took in
    each iteration (BRANCHES: a miss, the diffuse, mirror or dielectric
    lobe, or the Russian roulette's end), -1 where the lane was inactive;
    roots, int32 shaped like xs, the sphere tests of each lane whose near
    root the CUDA kernel takes (the ray's line meets the sphere, disc > 0,
    ahead of the origin's projection, dirv < 0)."""
    shape = xs.shape
    xs, ys, samp = xs.reshape(-1), ys.reshape(-1), samp.reshape(-1)
    spl = samples_per_lane
    cam = [float(v) for v in cam_vec.reshape(-1).tolist()]
    max_thres = np.float32(cam[17])
    inv_thres = float(np.float32(1.0) / max_thres)
    bd = raygen.base_dir(xs, ys, cam)

    def start_sample(samp_id):
        state = rng.init_state(xs, ys, samp_id)
        return raygen.start(state, bd, cam, has_lens)

    samp0 = rng.as_u32(samp)
    state, o, d = start_sample(samp0)
    zero = torch.zeros_like(o[0])
    ci = [torch.ones_like(zero) for _ in range(3)]
    inten = torch.ones_like(zero)
    L, md, mw = [zero] * 3, [zero] * 3, [zero] * 3
    active = torch.ones_like(zero, dtype=torch.bool)
    depth = torch.zeros_like(zero)
    sk = torch.zeros_like(samp0)
    where = torch.where
    iters, branches, roots = torch.zeros_like(xs), [], torch.zeros_like(xs)
    sph_rows = sph_table[:n_sph].tolist() if return_iters else []

    for _ in range(max_bounces * spl):
        if not bool(active.any()):
            break
        if return_iters:
            iters += active.to(iters.dtype)
            for row in sph_rows:
                dirv, disc = sphere_disc(*o, *d, row)
                roots += (active & (disc > 0.0) & (dirv < 0.0)).to(roots.dtype)
        h = closest_sph_ft(sph_table, ft_table, *o, *d, n_sph=n_sph, n_ft=n_ft)
        hit = h["kind"] > 0.5
        state, (u0, u1, u2, u3, u7) = rng.next_f32_n(state, 5)

        t_safe = where(hit, h["t_best"], zero)
        p = [o[k] + d[k] * t_safe for k in range(3)]
        n = [h["nxv"], h["nyv"], h["nzv"]]
        if n_sph:
            is_sph = h["kind"] == 1.0
            sn = raygen.norm3(p[0] - h["scx"], p[1] - h["scy"], p[2] - h["scz"])
            n = [where(is_sph, sn[k], n[k]) for k in range(3)]
        pos = [p[k] + n[k] * EPS for k in range(3)]
        ndx, ndy, ndz, weight = uniform_bsdf(
            *d, *n, h["mkind"], h["diffp"], h["n_out"], h["n_in"], u0, u1, u2, u3)
        nd = (ndx, ndy, ndz)

        add_miss = active & ~hit
        md = [where(add_miss, d[k], md[k]) for k in range(3)]
        mw = [where(add_miss, ci[k] * inten, mw[k]) for k in range(3)]
        rgb = (h["rgb_r"], h["rgb_g"], h["rgb_b"])
        em = (h["em_r"], h["em_g"], h["em_b"])
        add_em = active & hit & (h["has_em"] > 0.5)
        L = [L[k] + where(add_em, em[k] * (ci[k] * inten), zero) for k in range(3)]
        ci = [where(add_em, ci[k] * rgb[k], ci[k]) for k in range(3)]
        hm = active & hit
        ci = [where(hm, ci[k] * rgb[k], ci[k]) for k in range(3)]

        rr_kill = (depth >= float(assured)) & (u7 > float(max_thres))
        term = hm & rr_kill
        L = [L[k] + where(term, ci[k] * inv_thres * inten, zero) for k in range(3)]
        ci = [where(term, ci[k] * inv_thres, ci[k]) for k in range(3)]

        survive = hm & ~rr_kill
        if return_iters:
            lobe = where(h["mkind"] == 3.0, 3, where(
                (h["mkind"] == 1.0) | ((h["mkind"] == 2.0) & (u0 < h["diffp"])), 1, 2))
            code = where(hm, where(term, 4, lobe), 0)
            branches.append(where(active, code, -1).to(torch.int8))
        inten = where(survive, inten * weight, inten)
        o = [where(survive, pos[k], o[k]) for k in range(3)]
        d = [where(survive, nd[k], d[k]) for k in range(3)]
        depth = depth + survive.to(depth.dtype)

        if spl > 1:
            alive = survive & (depth < float(max_bounces))
            regen = ~alive & (sk + 1 < spl)
            sk = sk + regen.to(sk.dtype)
            st2, o2, d2 = start_sample(samp0 + sk)
            state = where(regen, st2, state)
            o = [where(regen, o2[k], o[k]) for k in range(3)]
            d = [where(regen, d2[k], d[k]) for k in range(3)]
            ci = [where(regen, 1.0, ci[k]) for k in range(3)]
            inten = where(regen, 1.0, inten)
            depth = where(regen, 0.0, depth)
            active = alive | regen
        else:
            active = survive

    out = tuple(v.reshape(shape) for v in (*L, *md, *mw))
    if not return_iters:
        return out
    branch = torch.stack(branches) if branches else torch.empty((0, xs.numel()), dtype=torch.int8)
    return out, (iters.reshape(shape), branch, roots.reshape(shape))


# --- the dispatcher --------------------------------------------------------

def _launch(xs, ys, samp, sph_table, ft_table, cam_vec, *, n_sph, n_ft, has_lens,
            assured, max_bounces, samples_per_lane, entry="trace_tiles"):
    global LAUNCHES
    from ..kernels import build

    dev = xs.device
    for name, t in (("ys", ys), ("samp", samp)):
        if t.shape != xs.shape or t.dtype != torch.int32 or t.device != dev:
            raise ValueError(f"{name} must be int32 on {dev} shaped {tuple(xs.shape)}")
    if xs.dtype != torch.int32:
        raise ValueError("xs must be int32")
    for name, t, cols, rows in (("sph_table", sph_table, SPH_COLS, n_sph),
                                ("ft_table", ft_table, FT_COLS, n_ft)):
        if (t.dtype != torch.float32 or t.device != dev or t.dim() != 2
                or t.shape[1] != cols or t.shape[0] < rows):
            raise ValueError(f"{name} must be f32 on {dev}, (>= {rows}, {cols})")
    if cam_vec.dtype != torch.float32 or cam_vec.device != dev or cam_vec.numel() != CAM_LEN:
        raise ValueError(f"cam_vec must be {CAM_LEN} f32 on {dev}")
    if samples_per_lane < 1 or max_bounces < 1:
        raise ValueError("samples_per_lane and max_bounces must be >= 1")

    lib = build.build("trace_kernel").lib
    fn = getattr(lib, f"{entry}_launch")
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + [ctypes.c_void_p] * 3 + \
        [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2

    xs_c, ys_c, samp_c = xs.contiguous(), ys.contiguous(), samp.contiguous()
    sph_c, ft_c, cam_c = sph_table.contiguous(), ft_table.contiguous(), cam_vec.contiguous()
    n = xs_c.numel()
    out = torch.empty((N_OUT, n), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(xs_c.data_ptr(), ys_c.data_ptr(), samp_c.data_ptr(), n,
                sph_c.data_ptr(), ft_c.data_ptr(), cam_c.data_ptr(),
                n_sph, n_ft, int(has_lens), assured, max_bounces,
                samples_per_lane, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"{entry} kernel launch failed: CUDA error {rc}")
    if entry == "trace_tiles":
        LAUNCHES += 1
    return tuple(out[k].view(xs.shape) for k in range(N_OUT))


def trace_tiles(xs, ys, samp, sph_table, ft_table, cam_vec, *, n_sph: int, n_ft: int,
                has_lens: bool, assured: int, max_bounces: int,
                samples_per_lane: int = 1):
    """xs, ys, samp: int32 lane tensors of any shape ((N,) or the JAX
    package's (R, 128)); sph_table / ft_table / cam_vec from
    `SceneTables` (or pack_scene_tables / make_cam_vec). Lane i covers
    sample ids samp[i] .. samp[i] + samples_per_lane - 1. Returns
    (L rgb, miss_dir xyz, miss_w rgb): 9 f32 tensors shaped like xs.

    CPU tensors run `trace_tiles_reference`; CUDA tensors launch the
    CUDA kernel or raise."""
    if n_sph > MAX_PRIMS or n_ft > MAX_PRIMS:
        raise NotImplementedError(f"trace_tiles takes <= {MAX_PRIMS} spheres and free triangles")
    kw = dict(n_sph=n_sph, n_ft=n_ft, has_lens=has_lens, assured=assured,
              max_bounces=max_bounces, samples_per_lane=samples_per_lane)
    if xs.device.type == "cuda":
        return _launch(xs, ys, samp, sph_table, ft_table, cam_vec, **kw)
    if xs.device.type == "cpu":
        return trace_tiles_reference(xs, ys, samp, sph_table, ft_table, cam_vec, **kw)
    raise ValueError(f"trace_tiles runs on cpu or cuda tensors, not {xs.device}")


def _trace_tiles_per_thread(xs, ys, samp, sph_table, ft_table, cam_vec, *, n_sph: int,
                            n_ft: int, has_lens: bool, assured: int, max_bounces: int,
                            samples_per_lane: int = 1):
    """`trace_tiles` by the entry `trace_tiles_per_thread` of
    csrc/trace_kernel.cu (a thread per lane, the first design): the
    yardstick chip_smoke.py times the kernel against. CUDA tensors only."""
    if xs.device.type != "cuda":
        raise ValueError(f"the per-thread trace_tiles runs on cuda tensors, not {xs.device}")
    if n_sph > MAX_PRIMS or n_ft > MAX_PRIMS:
        raise NotImplementedError(f"trace_tiles takes <= {MAX_PRIMS} spheres and free triangles")
    return _launch(xs, ys, samp, sph_table, ft_table, cam_vec, n_sph=n_sph, n_ft=n_ft,
                   has_lens=has_lens, assured=assured, max_bounces=max_bounces,
                   samples_per_lane=samples_per_lane, entry="trace_tiles_per_thread")
