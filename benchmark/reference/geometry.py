"""Ray-primitive tests and the mesh's cluster walk.

Spheres: the near root (the GPU backend) or the least positive root (the
CPU backend). Triangles: Moller-Trumbore with |det| >= EPS and t >= EPS.
The mesh: triangles in clusters of at most 64 by an exact median split of
their centroids along the widest axis, clusters grouped 16 to a
supercluster and 8 superclusters to a supergroup, ordered front to back
from the camera; a ray tests a triangle only where its slab tests reach
the triangle's supergroup, supercluster and cluster below its best t, and
an exact-t tie goes to the earlier triangle in that order. `walk_work`
counts the tests an exact walk must make, the work that the mesh kernels'
rooflines divide.
"""
from __future__ import annotations

import math

import numpy as np
import torch

EPS = float(np.float32(1e-4))
INF = float(np.float32(3.4e38))  # the miss sentinel
GROUP, SGROUP, LEAF = 16, 8, 64


def sentinel(dtype) -> float:
    """The miss sentinel INF in `dtype` (its largest finite value below)."""
    return min(INF, float(torch.finfo(dtype).max))


def inf_like(x):
    return torch.full_like(x, sentinel(x.dtype))
_NOHIT_LO, _NOHIT_HI = 3.0e38, -3.0e38


def sphere_near(o, d, row):
    """Near-root distance to the sphere row (cx, cy, cz, r) of Python
    floats, hit when disc > 0 and near > 0; INF on a miss; also (dirv,
    disc) for the work count."""
    oc = [o[k] - row[k] for k in range(3)]
    dirv = d[0] * oc[0] + d[1] * oc[1] + d[2] * oc[2]
    consts = oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2] - row[3] * row[3]
    disc = dirv * dirv - consts
    pos = disc > 0.0
    near = -dirv - torch.sqrt(torch.where(pos, disc, torch.ones_like(disc)))
    return torch.where(pos & (near > 0.0), near, inf_like(near)), dirv, disc


def sphere_roots(o, d, c, r, mode: str):
    """The integrator's sphere test over (S, N): c a 3-tuple of (S, 1)
    tensors, r (S, 1). gpu: the near root with near < far; cpu: the least
    positive root. INF on a miss."""
    oc = [o[k] - c[k] for k in range(3)]
    dirv = d[0] * oc[0] + d[1] * oc[1] + d[2] * oc[2]
    consts = oc[0] * oc[0] + oc[1] * oc[1] + oc[2] * oc[2] - r * r
    disc = dirv * dirv - consts
    pos = disc > 0.0
    sq = torch.sqrt(torch.where(pos, disc, torch.ones_like(disc)))
    near, far = -dirv - sq, -dirv + sq
    inf = inf_like(near)
    if mode == "gpu":
        return torch.where(pos & (near > 0.0) & (near < far), near, inf)
    return torch.where(pos, torch.where(near > 0.0, near, torch.where(far > 0.0, far, inf)), inf)


def triangle_tuv(ox, oy, oz, dx, dy, dz, v0, e1, e2):
    """Moller-Trumbore; v0, e1, e2 3-tuples broadcastable with the rays.
    Returns (t, u, w), t INF on a miss."""
    e1x, e1y, e1z = e1
    e2x, e2y, e2z = e2
    pvx = dy * e2z - dz * e2y
    pvy = dz * e2x - dx * e2z
    pvz = dx * e2y - dy * e2x
    det = e1x * pvx + e1y * pvy + e1z * pvz
    ok = torch.abs(det) >= EPS
    one = torch.ones_like(det)
    inv_det = torch.where(ok, 1.0 / torch.where(ok, det, one), torch.zeros_like(det))
    hx, hy, hz = ox - v0[0], oy - v0[1], oz - v0[2]
    u = inv_det * (hx * pvx + hy * pvy + hz * pvz)
    qx = hy * e1z - hz * e1y
    qy = hz * e1x - hx * e1z
    qz = hx * e1y - hy * e1x
    w = inv_det * (dx * qx + dy * qy + dz * qz)
    t = inv_det * (e2x * qx + e2y * qy + e2z * qz)
    ok = ok & (u >= 0.0) & (u <= 1.0) & (w >= 0.0) & (u + w <= 1.0) & (t >= EPS)
    return torch.where(ok, t, inf_like(t)), u, w


# --- the cluster tables ------------------------------------------------------

def build_tables(v0: np.ndarray, v1: np.ndarray, v2: np.ndarray, cam_o) -> dict:
    """(M, 3) f32 vertices -> the walk's numpy tables: bounds (Cp, 6),
    sbounds, sgbounds; tri (Cp, W, 9) v0 | e1 | e2; gid (Cp, W) int64, -1
    padding; count (Cp,)."""
    lo3 = np.minimum(np.minimum(v0, v1), v2).astype(np.float32)
    hi3 = np.maximum(np.maximum(v0, v1), v2).astype(np.float32)
    cent = 0.5 * (lo3 + hi3)
    leaves, stack = [], [np.arange(lo3.shape[0], dtype=np.int32)]
    while stack:  # right pushed first: the left half comes next
        ids = stack.pop()
        if ids.size <= LEAF:
            leaves.append(ids)
            continue
        c = cent[ids]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        mid = ids.size // 2
        part = np.argpartition(c[:, axis], mid)
        stack.append(ids[part[mid:]])
        stack.append(ids[part[:mid]])
    C, W = len(leaves), LEAF
    Cp = -(-max(C, 1) // (GROUP * SGROUP)) * (GROUP * SGROUP)
    lo = np.full((Cp, 3), _NOHIT_LO, np.float32)
    hi = np.full((Cp, 3), _NOHIT_HI, np.float32)
    gid = np.full((Cp, W), -1, np.int64)
    count = np.zeros((Cp,), np.int64)
    for i, ids in enumerate(leaves):
        gid[i, :ids.size] = ids
        count[i] = ids.size
        if ids.size:
            lo[i], hi[i] = lo3[ids].min(0), hi3[ids].max(0)
    safe = np.maximum(gid, 0)
    tri = np.concatenate([v0[safe], (v1 - v0)[safe], (v2 - v0)[safe]], axis=-1).astype(np.float32)
    if C:  # front to back from the camera, at each level
        cam = np.asarray(cam_o, np.float32).reshape(1, 3)
        ok = lo[:, 0] <= hi[:, 0]
        dist = np.full((Cp,), np.inf, np.float32)
        dist[ok] = np.linalg.norm(np.clip(cam, lo[ok], hi[ok]) - cam, axis=1)
        S = Cp // GROUP
        dg = dist.reshape(S, GROUP)
        within = np.argsort(dg, axis=1, kind="stable")
        dsg = dg.min(axis=1).reshape(S // SGROUP, SGROUP)
        within_s = np.argsort(dsg, axis=1, kind="stable")
        sg_order = np.argsort(dsg.min(axis=1), kind="stable")
        sperm = (sg_order[:, None] * SGROUP + within_s[sg_order]).reshape(-1)
        perm = (sperm[:, None] * GROUP + within[sperm]).reshape(-1)
        lo, hi, tri, gid, count = lo[perm], hi[perm], tri[perm], gid[perm], count[perm]
    S = Cp // GROUP
    slo, shi = lo.reshape(S, GROUP, 3).min(axis=1), hi.reshape(S, GROUP, 3).max(axis=1)
    sglo = slo.reshape(S // SGROUP, SGROUP, 3).min(axis=1)
    sghi = shi.reshape(S // SGROUP, SGROUP, 3).max(axis=1)
    box = lambda a, b: np.concatenate([a, b], axis=1)
    return dict(bounds=box(lo, hi), sbounds=box(slo, shi), sgbounds=box(sglo, sghi),
                tri=tri, gid=gid, count=count)


# --- the walk ------------------------------------------------------------------

def _chunks(dev):
    return (1 << 20, 1 << 14) if dev.type == "cpu" else (1 << 24, 1 << 18)


def _inv_dir(d):
    out = []
    for dk in d:
        eps = torch.full_like(dk, EPS)
        out.append(1.0 / torch.where(torch.abs(dk) < EPS, torch.where(dk < 0.0, -eps, eps), dk))
    return out


def _reach(o, f, bound, lane, box):
    t0 = [(box[:, k] - o[k][lane]) * f[k][lane] for k in range(3)]
    t1 = [(box[:, 3 + k] - o[k][lane]) * f[k][lane] for k in range(3)]
    mn = [torch.minimum(a, b) for a, b in zip(t0, t1)]
    mx = [torch.maximum(a, b) for a, b in zip(t0, t1)]
    entry = torch.maximum(torch.maximum(mn[0], mn[1]), mn[2])
    exit_ = torch.minimum(torch.minimum(mx[0], mx[1]), mx[2])
    return (entry <= exit_) & (exit_ >= 0.0) & (entry < bound[lane])


def _descend(o, f, bound, lane, node, fanout, boxes):
    out_l, out_n = [lane[:0]], [node[:0]]
    step = max(1, _chunks(node.device)[0] // fanout)
    kid = torch.arange(fanout, device=node.device)
    for s in range(0, lane.numel(), step):
        cl = lane[s:s + step].repeat_interleave(fanout)
        cn = (node[s:s + step, None] * fanout + kid).reshape(-1)
        keep = _reach(o, f, bound, cl, boxes[cn])
        out_l.append(cl[keep])
        out_n.append(cn[keep])
    return torch.cat(out_l), torch.cat(out_n)


def _reached_clusters(o, d, bound, live, tables):
    """(lane, cluster) pairs whose three levels of slab tests pass below
    `bound`, and the slab tests made at each level."""
    f = _inv_dir(d)
    n_sg = tables["sgbounds"].shape[0]
    lane = live.repeat_interleave(n_sg)
    node = torch.arange(n_sg, device=live.device).repeat(live.numel())
    keep = _reach(o, f, bound, lane, tables["sgbounds"][node])
    lane, node = lane[keep], node[keep]
    slab = [live.numel() * n_sg, SGROUP * lane.numel()]
    lane, node = _descend(o, f, bound, lane, node, SGROUP, tables["sbounds"])
    slab.append(int((tables["count"] > 0).view(-1, GROUP).sum(dim=1)[node].sum()))
    lane, node = _descend(o, f, bound, lane, node, GROUP, tables["bounds"])
    full = tables["count"][node] > 0
    return lane[full], node[full], slab


def mesh_hit(o, d, t_seed, tables, t_min: float):
    """Nearest mesh hit with t_min <= t < t_seed: (t, gid (-1 where none),
    u, v) per lane; dead lanes carry a seed of -inf."""
    n, dev = t_seed.numel(), t_seed.device
    lane, node, _ = _reached_clusters(o, d, t_seed, torch.arange(n, device=dev), tables)
    tri, count, gids = tables["tri"], tables["count"], tables["gid"]
    W = tri.shape[1]
    w_idx = torch.arange(W, device=dev)
    cand = [[] for _ in range(6)]
    for s in range(0, lane.numel(), _chunks(dev)[1]):
        pl, pn = lane[s:s + _chunks(dev)[1]], node[s:s + _chunks(dev)[1]]
        rows = tri[pn]
        ray = [c[pl, None] for c in (*o, *d)]
        t, u, v = triangle_tuv(*ray, (rows[..., 0], rows[..., 1], rows[..., 2]),
                               (rows[..., 3], rows[..., 4], rows[..., 5]),
                               (rows[..., 6], rows[..., 7], rows[..., 8]))
        ok = (w_idx[None, :] < count[pn, None]) & (t >= t_min)
        t = torch.where(ok, t, inf_like(t))
        tmin, arg = t.min(dim=1)
        hit = tmin < t_seed[pl]
        a = arg[hit, None]
        for k, val in enumerate((pl[hit], tmin[hit], pn[hit] * W + arg[hit], gids[pn[hit], arg[hit]],
                                 u[hit].gather(1, a)[:, 0], v[hit].gather(1, a)[:, 0])):
            cand[k].append(val)
    t_out, gid_out = t_seed.clone(), torch.full((n,), -1, dtype=torch.int64, device=dev)
    u_out, v_out = torch.zeros_like(t_seed), torch.zeros_like(t_seed)
    if not cand[0] or sum(c.numel() for c in cand[0]) == 0:
        return t_out, gid_out, u_out, v_out
    lane, t, pos, gid, u, v = (torch.cat(c) for c in cand)
    tmin = inf_like(t_seed).scatter_reduce(0, lane, t, "amin")
    tie = t == tmin[lane]
    pmin = torch.full((n,), torch.iinfo(torch.int64).max, dtype=torch.int64, device=dev)
    pmin = pmin.scatter_reduce(0, lane[tie], pos[tie], "amin")
    win = tie & (pos == pmin[lane])
    wl = lane[win]
    t_out[wl], gid_out[wl], u_out[wl], v_out[wl] = t[win], gid[win], u[win], v[win]
    return t_out, gid_out, u_out, v_out


def walk_work(o, d, t_best, tables, t_min: float) -> dict:
    """The tests an exact walk of these rays must make, every box pruned by
    the ray's final nearest t (reached when entry <= t_best): a live ray
    (t_best >= t_min) tests every supergroup box, a reached supergroup its
    superclusters, a reached supercluster its non-empty clusters, a
    reached cluster its triangles. Returns {"slab": int, "tri": int}."""
    t_best = t_best.float()
    live = (t_best >= t_min).nonzero()[:, 0]
    bound = torch.nextafter(t_best, torch.full_like(t_best, math.inf))
    o, d = [c.float() for c in o], [c.float() for c in d]
    lane, node, slab = _reached_clusters(o, d, bound, live, tables)
    return {"slab": sum(slab), "tri": int(tables["count"][node].sum())}
