"""Cluster builder: dense primitive clusters for the slab-culled walk.

Port of `raytrace_tpu/accel/builder.py::build_clusters_bvh` (:75) as its
pure-numpy algorithm: recursive EXACT median partition of primitive
centroids along the widest axis (np.argpartition), leaves of at most
`leaf_target` primitives emitted in depth-first order, left half first.
Each primitive lands in exactly one cluster; cluster AABBs may overlap.
The depth-first order is spatially local, which the supercluster
grouping of ops/mesh_kernel.pack_mesh_tables relies on.

Given the same bounds, the result is identical to the JAX module's
numpy fallback (`native=False`). Its default C++ build partitions with
std::nth_element, which yields the same leaf SETS in the same order for
distinct centroid keys but may order the ids inside a leaf differently.
"""
from __future__ import annotations

import numpy as np


def build_clusters_bvh(aabb_lo: np.ndarray, aabb_hi: np.ndarray, leaf_target: int = 64):
    """aabb_lo / aabb_hi: (M, 3) per-primitive bounds. Returns
    (cluster_prims (C, W) int32, -1 padded; cluster_lo (C, 3) f32;
    cluster_hi (C, 3) f32), W = leaf_target rounded up to a multiple
    of 8."""
    lo = np.ascontiguousarray(aabb_lo, np.float32)
    hi = np.ascontiguousarray(aabb_hi, np.float32)
    width = ((leaf_target + 7) // 8) * 8
    cent = 0.5 * (lo + hi)
    leaves = []
    stack = [np.arange(lo.shape[0], dtype=np.int32)]
    while stack:  # explicit stack: right pushed first, so the left half is next
        ids = stack.pop()
        if ids.size <= leaf_target:
            leaves.append(ids)
            continue
        c = cent[ids]
        axis = int(np.argmax(c.max(0) - c.min(0)))
        mid = ids.size // 2
        part = np.argpartition(c[:, axis], mid)
        stack.append(ids[part[mid:]])
        stack.append(ids[part[:mid]])

    cp = np.full((len(leaves), width), -1, np.int32)
    cl = np.zeros((len(leaves), 3), np.float32)
    ch = np.zeros((len(leaves), 3), np.float32)
    for i, ids in enumerate(leaves):
        cp[i, : ids.size] = ids
        if ids.size:
            cl[i] = lo[ids].min(0)
            ch[i] = hi[ids].max(0)
    return cp, cl, ch
