"""Spatial triangle clustering for the clustered find kernel.

The device kernel (ops/pallas_find.py) visits triangles cluster by cluster
and skips whole clusters whose AABB a ray block misses. For that to cull
well, consecutive triangles must be spatially coherent: we order triangles
by a median-split BVH DFS (same split rule as models/bvh.py: largest-extent
centroid axis, stable sort — the reference's builder semantics with its
random axis made deterministic, bvh.h:55-95) and chop the order into
consecutive groups of ``CLUSTER_SIZE``.

This is the reference's own flattening idea (hittablevector.h) adapted to
a wavefront: instead of a per-ray stack over single-primitive leaves
(compute.glsl:154-185), leaves are fixed-size clusters that a whole ray
block tests together.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# triangles per cluster: the granule of the kernel's cull
CLUSTER_SIZE = 64
_BIG = 3.0e38


def cluster_bounds_device(tri_v0, tri_v1, tri_v2):
    """Re-derive cluster AABBs on device from (possibly trained) vertices.

    The cluster partition is static — cluster ``c`` covers scene-order
    triangles ``[c*ck, (c+1)*ck)`` — so when inverse rendering updates
    ``tri_v*`` the bounds are a segment min/max over that fixed partition.
    Without this, the production cull kernel (ops/pallas_find.py) tests
    trained geometry against stale host-built AABBs and silently drops
    hits. Flat axes are padded +-1e-4 like the host path (model.h:199-204).
    """
    ck = CLUSTER_SIZE
    T = tri_v0.shape[0]
    if T == 0:
        return jnp.zeros((0, 3), jnp.float32), jnp.zeros((0, 3), jnp.float32)
    tmin = jnp.minimum(jnp.minimum(tri_v0, tri_v1), tri_v2)
    tmax = jnp.maximum(jnp.maximum(tri_v0, tri_v1), tri_v2)
    flat = tmin == tmax
    tmin = jnp.where(flat, tmin - 1e-4, tmin)
    tmax = jnp.where(flat, tmax + 1e-4, tmax)
    nc = -(-T // ck)
    pad = nc * ck - T
    if pad:
        tmin = jnp.pad(tmin, ((0, pad), (0, 0)), constant_values=_BIG)
        tmax = jnp.pad(tmax, ((0, pad), (0, 0)), constant_values=-_BIG)
    cmin = tmin.reshape(nc, ck, 3).min(axis=1)
    cmax = tmax.reshape(nc, ck, 3).max(axis=1)
    return cmin, cmax


def dfs_order(pmin: np.ndarray, pmax: np.ndarray) -> np.ndarray:
    """Median-split DFS order of primitives given their AABBs -> [P] int32."""
    P = pmin.shape[0]
    centroids = 0.5 * (pmin + pmax)
    out = np.empty((P,), np.int64)
    n_out = 0
    stack = [np.arange(P, dtype=np.int64)]
    while stack:
        prims = stack.pop()
        if prims.size <= 2:
            out[n_out : n_out + prims.size] = prims
            n_out += prims.size
            continue
        ext = centroids[prims].max(axis=0) - centroids[prims].min(axis=0)
        axis = int(np.argmax(ext))
        order = np.argsort(pmin[prims, axis], kind="stable")
        prims = prims[order]
        mid = prims.size // 2
        stack.append(prims[mid:])   # popped second
        stack.append(prims[:mid])   # popped first -> left-to-right DFS
    assert n_out == P
    return out.astype(np.int32)


def triangle_order(tri_v0, tri_v1, tri_v2):
    """Spatial permutation + cluster AABBs for the kernel tiles.

    Returns ``(order [T], cluster_min [NC,3], cluster_max [NC,3])`` where
    triangle ``order[i]`` of the input becomes triangle ``i`` of the scene
    and cluster ``c`` covers permuted triangles ``[c*ck, (c+1)*ck)``.
    Triangle AABBs are padded +-1e-4 on flat axes like the reference
    (model.h:199-204) so the slab test can't miss axis-aligned geometry.
    """
    ck = CLUSTER_SIZE
    v0 = np.asarray(tri_v0, np.float64)
    v1 = np.asarray(tri_v1, np.float64)
    v2 = np.asarray(tri_v2, np.float64)
    T = v0.shape[0]
    if T == 0:
        return (
            np.zeros((0,), np.int32),
            np.zeros((0, 3), np.float32),
            np.zeros((0, 3), np.float32),
        )
    tmin = np.minimum(np.minimum(v0, v1), v2)
    tmax = np.maximum(np.maximum(v0, v1), v2)
    flat = tmin == tmax
    tmin = np.where(flat, tmin - 1e-4, tmin)
    tmax = np.where(flat, tmax + 1e-4, tmax)

    order = dfs_order(tmin, tmax)
    n_clusters = -(-T // ck)
    cmin = np.full((n_clusters, 3), np.inf)
    cmax = np.full((n_clusters, 3), -np.inf)
    for c in range(n_clusters):
        sel = order[c * ck : (c + 1) * ck]
        cmin[c] = tmin[sel].min(axis=0)
        cmax[c] = tmax[sel].max(axis=0)
    return order, cmin.astype(np.float32), cmax.astype(np.float32)
