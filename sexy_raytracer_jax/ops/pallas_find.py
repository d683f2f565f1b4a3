"""Clustered hit search: a Pallas kernel on the Triton route.

The hot kernel of the renderer: for every ray of a wavefront, the closest
triangle hit. It replaces the reference's BVH traversal loop (reference
bvh.h:97-105 and its GPU prototype shaders/compute.glsl:154-185).

* **Culling in XLA, testing in the kernel.** Triangles are stored in
  spatially coherent clusters of ``CLUSTER_SIZE`` (models/clusters.py). An
  XLA prologue (``cluster_lists``) tests each ray block against every
  cluster's AABB and writes, per block, the list of active clusters. The
  kernel then visits only those clusters.
* **One ray per thread.** A program owns ``RAY_BLOCK`` rays, one per
  thread, and keeps each ray's running (t, id) in registers. It reads the
  active cluster ids of its own block from global memory and loops over
  their triangles; each triangle's 16 floats are scalar loads that every
  thread of the block shares (the whole flagship pack is ~195 KB and stays
  in L1/L2). No shared-memory staging, no cross-lane reduction.
* **Spheres in XLA.** Scenes hold a handful of spheres; their closest hit
  is one small ``[R, S]`` solve in XLA that seeds the kernel's running
  best and bounds the cull.

Triangle semantics match ``ops/intersect._tri_candidates`` term for term:
back-face cull + parallel reject as one test (``n.dir <= -eps``,
model.h:119-123), edge half-space tests at the hit point, ``t >= t_min``,
true closest hit kept via the running min.

Hit *finding* is non-differentiable by design (SURVEY §7): gradients flow
through ops/intersect.hit_data recomputation, so this kernel has no VJP.
Callers reach it through ``ops/intersect.find_hit``, which picks it per
platform (ops/backend.py); ``interpret=True`` is only ever passed from the
CPU branch.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from sexy_raytracer_jax.models.clusters import CLUSTER_SIZE
from sexy_raytracer_jax.utils.mathx import EPSILON

# rays per program, one per thread (RAY_BLOCK // 32 warps); 64 measured
# faster than 128 and 256 on every bounce and on the train step
RAY_BLOCK = 64
_BIG = 3.0e38

# above this many clusters the exact per-ray cull's [NC, R] slab
# intermediates dominate; switch to the per-block interval cull, which is
# O(NB x NC)
PER_RAY_CULL_MAX_CLUSTERS = 512


# ---------------------------------------------------------------------------
# kernel
# ---------------------------------------------------------------------------

def _search_kernel(lists_ref, rays_ref, tri_ref, init_i_ref, out_t_ref,
                   out_i_ref):
    """Grid (NB,), one program per ray block.

    lists_ref [NB, NC+1] int32: active count, then the active cluster ids
    rays_ref  [8, BR] f32: ox oy oz dx dy dz t_min best_t (seed)
    tri_ref   [NC*CLUSTER_SIZE, 16] f32: plane n(3), d, then 3 edges (q(3), c)
    init_i_ref [BR] int32: seed id (sphere hit or -1)
    out: best t [BR] f32 and primitive id [BR] int32
    """
    b = pl.program_id(0)
    ox, oy, oz = rays_ref[0, :], rays_ref[1, :], rays_ref[2, :]
    dx, dy, dz = rays_ref[3, :], rays_ref[4, :], rays_ref[5, :]
    t_min = rays_ref[6, :]

    def triangle(j, carry, base):
        bt, bi = carry
        i = base + j
        nx, ny, nz, d = (tri_ref[i, 0], tri_ref[i, 1], tri_ref[i, 2],
                         tri_ref[i, 3])
        ndir = dx * nx + dy * ny + dz * nz
        a_n = ox * nx + oy * ny + oz * nz + d
        plane_ok = ndir <= -EPSILON
        t = -a_n / jnp.where(plane_ok, ndir, -1.0)
        px = ox + t * dx
        py = oy + t * dy
        pz = oz + t * dz
        e0 = (tri_ref[i, 4] * px + tri_ref[i, 5] * py + tri_ref[i, 6] * pz
              - tri_ref[i, 7])
        e1 = (tri_ref[i, 8] * px + tri_ref[i, 9] * py + tri_ref[i, 10] * pz
              - tri_ref[i, 11])
        e2 = (tri_ref[i, 12] * px + tri_ref[i, 13] * py + tri_ref[i, 14] * pz
              - tri_ref[i, 15])
        better = (plane_ok & (e0 >= 0.0) & (e1 >= 0.0) & (e2 >= 0.0)
                  & (t >= t_min) & (t < bt))
        return jnp.where(better, t, bt), jnp.where(better, i, bi)

    def cluster(k, carry):
        base = lists_ref[b, 1 + k] * CLUSTER_SIZE
        return jax.lax.fori_loop(
            0, CLUSTER_SIZE, functools.partial(triangle, base=base), carry
        )

    best_t, best_i = jax.lax.fori_loop(
        0, lists_ref[b, 0], cluster, (rays_ref[7, :], init_i_ref[...])
    )
    out_t_ref[...] = best_t
    out_i_ref[...] = best_i


def _search(lists, rays_t, tri_pack, init_i, *, interpret):
    nb = lists.shape[0]
    rpad = rays_t.shape[1]
    full = lambda a: pl.BlockSpec(a.shape, lambda b: (0,) * a.ndim)
    return pl.pallas_call(
        _search_kernel,
        grid=(nb,),
        in_specs=[
            full(lists),
            pl.BlockSpec((8, RAY_BLOCK), lambda b: (0, b)),
            full(tri_pack),
            pl.BlockSpec((RAY_BLOCK,), lambda b: (b,)),
        ],
        out_specs=[
            pl.BlockSpec((RAY_BLOCK,), lambda b: (b,)),
            pl.BlockSpec((RAY_BLOCK,), lambda b: (b,)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((rpad,), jnp.float32),
            jax.ShapeDtypeStruct((rpad,), jnp.int32),
        ],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(
            num_warps=RAY_BLOCK // 32, num_stages=1
        ),
        interpret=interpret,
        name="closest_hit_search",
    )(lists, rays_t, tri_pack, init_i)


# ---------------------------------------------------------------------------
# packing
# ---------------------------------------------------------------------------

def _pack_triangles(scene):
    """[NC*CLUSTER_SIZE, 16] row-major plane/edge pack; pad rows never hit
    (n = 0)."""
    T = scene.tri_v0.shape[0]
    nc = -(-T // CLUSTER_SIZE)
    pack = jnp.concatenate(
        [
            scene.tri_n,
            scene.tri_d[:, None],
            scene.tri_q[:, 0], scene.tri_c[:, 0:1],
            scene.tri_q[:, 1], scene.tri_c[:, 1:2],
            scene.tri_q[:, 2], scene.tri_c[:, 2:3],
        ],
        axis=1,
    )
    pad = nc * CLUSTER_SIZE - T
    if pad:
        pack = jnp.pad(pack, ((0, pad), (0, 0)))
    return jax.lax.stop_gradient(pack)


def _rays_block_rows(org, dir, t_min, seed_t):
    """[8, Rpad] ray rows; pad lanes are dead (t_min = BIG)."""
    R = org.shape[0]
    nb = -(-R // RAY_BLOCK)
    rows = jnp.concatenate(
        [org.T, dir.T, t_min[None], seed_t[None]], axis=0
    ).astype(jnp.float32)
    pad = nb * RAY_BLOCK - R
    if pad:
        fill = jnp.zeros((8, pad), jnp.float32).at[6].set(_BIG).at[7].set(_BIG)
        rows = jnp.concatenate([rows, fill], axis=1)
    return rows


# ---------------------------------------------------------------------------
# cull prologue (XLA)
# ---------------------------------------------------------------------------

def cluster_lists(org, dir, t_min, cmin, cmax, t_max=None):
    """Per-block active clusters -> ``lists [NB, NC+1]`` int32.

    Row b = [count, active cluster ids, junk...]. A cluster is active if any ray in block b enters its AABB at t
    in [t_min, t_max) (slab test, aabb.h:11-27 semantics made
    zero-direction-safe — conservative, never a false miss). ``t_max`` is
    an optional per-ray upper bound on the closest hit (e.g. the ray's
    sphere hit). Rays with t_min >= 3e38 (dead lanes) activate nothing.

    Small scenes use the exact per-ray test; past
    ``PER_RAY_CULL_MAX_CLUSTERS`` the per-block interval cull
    (``cluster_lists_block``) takes over.
    """
    if cmin.shape[0] > PER_RAY_CULL_MAX_CLUSTERS:
        return cluster_lists_block(org, dir, t_min, cmin, cmax, t_max=t_max)
    R = org.shape[0]
    nb = -(-R // RAY_BLOCK)
    pad_r = nb * RAY_BLOCK - R
    if pad_r:
        org = jnp.pad(org, ((0, pad_r), (0, 0)))
        dir = jnp.pad(dir, ((0, pad_r), (0, 0)))
        t_min = jnp.pad(t_min, (0, pad_r), constant_values=_BIG)
        if t_max is not None:
            t_max = jnp.pad(t_max, (0, pad_r), constant_values=-_BIG)
    NC = cmin.shape[0]
    Rp = nb * RAY_BLOCK
    o_rows = org.T                                       # [3, Rp]
    d_rows = dir.T
    # [NC, Rp] layout keeps the ray axis contiguous
    t_near = jnp.broadcast_to(t_min[None, :], (NC, Rp))
    t_far = jnp.full((NC, Rp), _BIG)
    for a in range(3):
        o_a = o_rows[a:a + 1]                            # [1, Rp]
        d_a = d_rows[a:a + 1]
        zero = d_a == 0.0
        inv = 1.0 / jnp.where(zero, 1.0, d_a)
        lo_c = cmin[:, a][:, None]                       # [NC, 1]
        hi_c = cmax[:, a][:, None]
        near = (lo_c - o_a) * inv                        # [NC, Rp]
        far = (hi_c - o_a) * inv
        lo = jnp.minimum(near, far)
        hi = jnp.maximum(near, far)
        inside = (o_a >= lo_c) & (o_a <= hi_c)
        lo = jnp.where(zero, jnp.where(inside, -_BIG, _BIG), lo)
        hi = jnp.where(zero, jnp.where(inside, _BIG, -_BIG), hi)
        t_near = jnp.maximum(t_near, lo)
        t_far = jnp.minimum(t_far, hi)
    hit = t_far > t_near                                 # [NC, Rp]
    if t_max is not None:
        hit &= t_near < t_max[None, :]
    # two reductions of the slab result (any hit, min entry) keep XLA from
    # fusing the slab math into one per-block reduction, which measured
    # ~9x slower on the H100 (PERF.md)
    entry = jnp.where(hit, t_near, _BIG)
    hit = hit.reshape(NC, nb, RAY_BLOCK).any(axis=2).T   # [NB, NC]
    entry = entry.reshape(NC, nb, RAY_BLOCK).min(axis=2).T
    return _lists(hit, entry)


def _lists(hit, entry):
    """[NB, NC] -> [NB, NC+1] rows: count, then the active ids first
    (ordered by entry distance)."""
    count = jnp.sum(hit, axis=1, dtype=jnp.int32)
    order = jnp.argsort(jnp.where(hit, entry, _BIG), axis=1)
    return jnp.concatenate([count[:, None], order.astype(jnp.int32)], axis=1)


def cluster_lists_block(org, dir, t_min, cmin, cmax, t_max=None):
    """Per-block *interval* cull: O(NB x NC), no per-ray blowup.

    Each ray block is summarized by its origin AABB, per-component
    direction range, and t bounds; the slab test then runs in interval
    arithmetic — if ANY (origin, direction) in the block's bounds could
    enter the cluster AABB, the cluster is active. Strictly conservative
    (a superset of the exact per-ray cull's actives, tested), so hits are
    never lost; tile-coherent ray order keeps the bounds tight for
    primary rays. This is classic packet/frustum culling (the role BVH
    upper levels play in the reference, bvh.h:97-105).
    """
    R = org.shape[0]
    nb = -(-R // RAY_BLOCK)
    pad_r = nb * RAY_BLOCK - R

    alive = t_min < _BIG
    big3 = jnp.full_like(org, _BIG)
    o_lo = jnp.where(alive[:, None], org, big3)
    o_hi = jnp.where(alive[:, None], org, -big3)
    d_lo = jnp.where(alive[:, None], dir, big3)
    d_hi = jnp.where(alive[:, None], dir, -big3)
    tmin_b = jnp.where(alive, t_min, _BIG)
    tmax_r = (
        jnp.where(alive, t_max, -_BIG)
        if t_max is not None
        else jnp.where(alive, _BIG, -_BIG)
    )
    if pad_r:
        o_lo = jnp.pad(o_lo, ((0, pad_r), (0, 0)), constant_values=_BIG)
        o_hi = jnp.pad(o_hi, ((0, pad_r), (0, 0)), constant_values=-_BIG)
        d_lo = jnp.pad(d_lo, ((0, pad_r), (0, 0)), constant_values=_BIG)
        d_hi = jnp.pad(d_hi, ((0, pad_r), (0, 0)), constant_values=-_BIG)
        tmin_b = jnp.pad(tmin_b, (0, pad_r), constant_values=_BIG)
        tmax_r = jnp.pad(tmax_r, (0, pad_r), constant_values=-_BIG)

    def blk(x, red):
        return red(x.reshape(nb, RAY_BLOCK, -1), axis=1)

    o_lo = blk(o_lo, jnp.min)            # [NB, 3]
    o_hi = blk(o_hi, jnp.max)
    d_lo = blk(d_lo, jnp.min)
    d_hi = blk(d_hi, jnp.max)
    t0 = tmin_b.reshape(nb, RAY_BLOCK).min(axis=1)       # [NB]
    t1 = tmax_r.reshape(nb, RAY_BLOCK).max(axis=1)
    dead_block = t0 >= _BIG

    # interval slab test per (block, cluster, axis). For axis distances
    # a = cmin - o in [a_lo, a_hi], b = cmax - o in [b_lo, b_hi] and
    # direction d in [d_lo, d_hi], take the earliest possible entry and
    # the latest possible exit over the block's interval box.
    a_lo = cmin[None] - o_hi[:, None]    # [NB, NC, 3]
    b_hi = cmax[None] - o_lo[:, None]
    dl = d_lo[:, None]
    dh = d_hi[:, None]
    eps = 1e-30

    def div(num, den):
        return num / jnp.maximum(den, eps)

    # Entry minima must account for d -> 0+ blowing the quotient to -inf
    # when the numerator can be negative (origin range straddles the
    # slab): anything less negative would overtighten the cull and LOSE
    # hits. Positive-direction candidates enter at the cmin side.
    pos_ok = dh > 0.0
    ent_pos = jnp.where(
        pos_ok,
        jnp.where(
            a_lo >= 0.0,
            div(a_lo, dh),                       # min at the largest d
            jnp.where(dl > 0.0, div(a_lo, dl), -_BIG),  # d->0+ => -inf
        ),
        _BIG,
    )
    ext_pos = jnp.where(
        pos_ok,
        jnp.where(b_hi >= 0.0, div(b_hi, jnp.maximum(dl, eps)),
                  div(b_hi, dh)),
        -_BIG,
    )
    # negative-direction candidates (enter at the cmax side); with
    # m = -d in (0, -dl], entry = (-b)/m, exit = (-a)/m
    neg_ok = dl < 0.0
    ent_neg = jnp.where(
        neg_ok,
        jnp.where(
            -b_hi >= 0.0,
            div(-b_hi, -dl),
            jnp.where(dh < 0.0, div(-b_hi, -dh), -_BIG),
        ),
        _BIG,
    )
    ext_neg = jnp.where(
        neg_ok,
        jnp.where(a_lo <= 0.0, div(-a_lo, jnp.maximum(-dh, eps)),
                  div(-a_lo, -dl)),
        -_BIG,
    )
    # zero-direction possibility: slab overlaps origin range on this axis
    zero_ok = (dl <= 0.0) & (dh >= 0.0) & (a_lo <= 0.0) & (b_hi >= 0.0)
    ent = jnp.where(zero_ok, -_BIG, jnp.minimum(ent_pos, ent_neg))
    ext = jnp.where(zero_ok, _BIG, jnp.maximum(ext_pos, ext_neg))

    t_near = jnp.maximum(jnp.max(ent, axis=-1), t0[:, None])   # [NB, NC]
    t_far = jnp.min(ext, axis=-1)
    hit = (t_far > t_near) & (t_near < t1[:, None])
    return _lists(hit & ~dead_block[:, None], t_near)


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def find_hit_clustered(scene, org, dir, time, t_min, *, interpret):
    """Closest hit for a ray wavefront -> ``(prim [R] int32, t [R])``.

    ``prim``: global primitive id (triangles then spheres), -1 = miss, with
    ``t = inf``. ``t_min`` is per-ray [R]; rays with ``t_min >= 3e38`` are
    dead (miss everything, excluded from the cull lists, so fully dead
    blocks skip all triangle work).
    """
    from sexy_raytracer_jax.ops.intersect import _sph_candidates

    T = scene.tri_v0.shape[0]
    R = org.shape[0]
    sph_t, sph_i = _sph_candidates(scene, org, dir, time, t_min)
    seed_t = jnp.where(jnp.isfinite(sph_t), sph_t, _BIG)
    seed_i = jnp.where(sph_i >= 0, T + sph_i, -1).astype(jnp.int32)
    if T == 0:
        t, prim = seed_t, seed_i
    else:
        rays_t = _rays_block_rows(org, dir, t_min, seed_t)
        seed_i = jnp.pad(seed_i, (0, rays_t.shape[1] - R),
                         constant_values=-1)
        with jax.named_scope("cluster_lists"):
            lists = cluster_lists(
                org, dir, t_min, jax.lax.stop_gradient(scene.cluster_min),
                jax.lax.stop_gradient(scene.cluster_max), t_max=seed_t,
            )
        t, prim = _search(lists, rays_t, _pack_triangles(scene), seed_i,
                          interpret=interpret)
        t, prim = t[:R], prim[:R]
    hit = t < _BIG
    return jnp.where(hit, prim, -1), jnp.where(hit, t, jnp.inf)
