"""Hit finding and differentiable hit records.

Design: intersection is split into two phases.

1. ``find_hit`` — a *non-differentiable index search*: for each ray return
   the winning primitive id and nothing else. This is the hot kernel; on
   the GPU it is the clustered Pallas kernel of ops/pallas_find.py, and
   plain jnp searches live here. Gradients through the discrete
   closest-hit choice are intentionally zero (stop-gradient on topology,
   SURVEY §7).

2. ``hit_data`` — given the winning primitive id, *recompute* the hit record
   (t, point, normal, tangent basis, uv, material) per-ray in plain jnp.
   This is O(rays), fully differentiable, and is the only path gradients
   take — so the expensive search kernels need no custom VJPs at all.

Reference semantics reproduced here:
  * triangle hit = plane hit + three edge half-space tests with back-face
    culling (reference model.h:104-181); the edge tests are algebraically
    rewritten as precomputed dot products (see models/scene.py).
  * "barycentric" interpolation uses inverse-distance-to-vertex weights,
    not true barycentrics, and flips v (model.h:157-169) — a deliberate
    quirk replication, because it defines the reference's images.
  * sphere hit = half-b quadratic, nearest root in range (sphere.h:54-83),
    outward normal *unnormalized by radius* (unitVector(p-center),
    sphere.h:76) so negative-radius hollow glass is unsupported, like the
    reference.
  * the reference's "triangle ignores tMax" traversal quirk
    (model.h:128-129) is NOT reproduced: we always return the true closest
    hit. The quirk makes the visible surface depend on mt19937-driven BVH
    traversal order, which is unreproducible by construction; the oracle
    package documents it instead.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from sexy_raytracer_jax.ops.lookup import table_lookup
from sexy_raytracer_jax.utils.mathx import EPSILON, PI, safe_sqrt, unit_vector

T_MIN_DEFAULT = 0.001  # reference main.cpp:39

class HitRecord(NamedTuple):
    """SoA hit record (reference hittable.h:9-22, arrays over rays)."""

    p: jnp.ndarray           # [R,3] hit point
    normal: jnp.ndarray      # [R,3] shading normal (flipped to face the ray)
    tangent: jnp.ndarray     # [R,3]
    bitangent: jnp.ndarray   # [R,3]
    uv: jnp.ndarray          # [R,2]
    t: jnp.ndarray           # [R]
    front_face: jnp.ndarray  # [R] bool
    mat_id: jnp.ndarray      # [R] int32 (0 where miss; see hit mask)
    hit: jnp.ndarray         # [R] bool


# ---------------------------------------------------------------------------
# Phase 1: index search
# ---------------------------------------------------------------------------

def sphere_center(scene, s_idx, time):
    """Moving-sphere center at ray time (reference sphere.h:47-52)."""
    c0 = scene.sph_c0[s_idx]
    c1 = scene.sph_c1[s_idx]
    t0 = scene.sph_t0[s_idx]
    t1 = scene.sph_t1[s_idx]
    moving = jnp.any(c0 != c1, axis=-1)
    denom = jnp.where(t1 == t0, 1.0, t1 - t0)
    frac = (time - t0) / denom
    return jnp.where(moving[..., None], c0 + frac[..., None] * (c1 - c0), c0)


def _tri_candidates(scene, org, dir, t_min, tile):
    """Closest valid triangle per ray via a scan over triangle tiles.

    Returns ``(best_t [R], best_idx [R])`` with ``inf``/``-1`` on miss.
    Tiling bounds peak memory at ``O(R * tile)`` and lets XLA keep the
    elementwise work fused with the min-reduction.
    """
    T = scene.tri_v0.shape[0]
    R = org.shape[0]
    if T == 0:
        return jnp.full((R,), jnp.inf), jnp.full((R,), -1, jnp.int32)

    tile = min(tile, max(T, 1))
    n_tiles = -(-T // tile)
    Tpad = n_tiles * tile
    pad = Tpad - T

    def padded(x):
        width = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, width)

    n = padded(scene.tri_n).reshape(n_tiles, tile, 3)
    d = padded(scene.tri_d).reshape(n_tiles, tile)
    q = padded(scene.tri_q).reshape(n_tiles, tile, 3, 3)
    c = padded(scene.tri_c).reshape(n_tiles, tile, 3)
    idx = jnp.arange(Tpad, dtype=jnp.int32).reshape(n_tiles, tile)
    valid_tri = (idx < T)

    def body(carry, xs):
        best_t, best_i = carry
        n_t, d_t, q_t, c_t, idx_t, valid_t = xs
        # [R, tile] plane terms, component-explicit in the same evaluation
        # order as the Pallas kernel (ops/pallas_find.py) so the two paths
        # agree on near-edge cases.
        ox, oy, oz = org[:, 0:1], org[:, 1:2], org[:, 2:3]
        dx, dy, dz = dir[:, 0:1], dir[:, 1:2], dir[:, 2:3]
        ndir = dx * n_t[None, :, 0] + dy * n_t[None, :, 1] + dz * n_t[None, :, 2]
        a_n = (
            ox * n_t[None, :, 0] + oy * n_t[None, :, 1] + oz * n_t[None, :, 2]
            + d_t[None, :]
        )
        # parallel + back-face cull (model.h:119-123): accept ndir <= -eps
        plane_ok = ndir <= -EPSILON
        t = -a_n / jnp.where(plane_ok, ndir, -1.0)
        # edge half-space tests at the hit point: w_i = q_i.p - c_i >= 0.
        # Evaluating at p (not as q.o + t*(q.d)) is the numerically tighter
        # form (f64-referee verified).
        px = ox + t * dx
        py = oy + t * dy
        pz = oz + t * dz
        inside = None
        for k in range(3):
            e = (
                q_t[None, :, k, 0] * px
                + q_t[None, :, k, 1] * py
                + q_t[None, :, k, 2] * pz
                - c_t[None, :, k]
            ) >= 0.0
            inside = e if inside is None else (inside & e)
        ok = plane_ok & inside & (t >= t_min[:, None]) & valid_t[None, :]
        t = jnp.where(ok, t, jnp.inf)
        tile_best = jnp.min(t, axis=1)
        tile_arg = jnp.argmin(t, axis=1).astype(jnp.int32)
        tile_idx = idx_t[tile_arg]
        better = tile_best < best_t
        best_t = jnp.where(better, tile_best, best_t)
        best_i = jnp.where(better, tile_idx, best_i)
        return (best_t, best_i), None

    init = (jnp.full((R,), jnp.inf), jnp.full((R,), -1, jnp.int32))
    (best_t, best_i), _ = jax.lax.scan(
        body, init, (n, d, q, c, idx, valid_tri)
    )
    return best_t, best_i


def sphere_roots(scene, org, dir, time, t_min, t_max=jnp.inf):
    """Per-(ray, sphere) nearest valid root (reference sphere.h:54-72).

    Returns ``(root [R,S], valid [R,S])``.
    """
    S = scene.sph_c0.shape[0]
    s_idx = jnp.arange(S)
    center = sphere_center(scene, s_idx[None, :], time[:, None])  # [R,S,3]
    oc = org[:, None, :] - center
    a = jnp.sum(dir * dir, axis=-1)[:, None]                      # [R,1]
    half_b = jnp.sum(oc * dir[:, None, :], axis=-1)               # [R,S]
    r = scene.sph_radius[None, :]
    cterm = jnp.sum(oc * oc, axis=-1) - r * r
    disc = half_b * half_b - a * cterm
    has = disc >= 0.0
    sqrtd = jnp.sqrt(jnp.where(has, disc, 0.0))
    safe_a = jnp.where(a == 0.0, 1.0, a)
    root0 = (-half_b - sqrtd) / safe_a
    root1 = (-half_b + sqrtd) / safe_a
    tmin = t_min[:, None]
    ok0 = has & (root0 >= tmin) & (root0 <= t_max)
    ok1 = has & (root1 >= tmin) & (root1 <= t_max)
    root = jnp.where(ok0, root0, root1)
    valid = ok0 | ok1
    return root, valid


def _sph_candidates(scene, org, dir, time, t_min):
    S = scene.sph_c0.shape[0]
    R = org.shape[0]
    if S == 0:
        return jnp.full((R,), jnp.inf), jnp.full((R,), -1, jnp.int32)
    root, valid = sphere_roots(scene, org, dir, time, t_min)
    t = jnp.where(valid, root, jnp.inf)
    best = jnp.min(t, axis=1)
    arg = jnp.argmin(t, axis=1).astype(jnp.int32)
    return best, jnp.where(jnp.isfinite(best), arg, -1)


def find_hit_bruteforce(scene, org, dir, time, t_min=None, tri_tile=512):
    """All-primitives closest hit. Returns ``(prim_id [R] int32, t [R])``.

    ``prim_id`` is the global id (triangles first, then spheres); -1 = miss.
    """
    t_min = _per_ray(t_min, org.shape[0])
    tri_t, tri_i = _tri_candidates(scene, org, dir, t_min, tri_tile)
    sph_t, sph_i = _sph_candidates(scene, org, dir, time, t_min)

    T = scene.tri_v0.shape[0]
    use_sph = sph_t < tri_t
    t = jnp.where(use_sph, sph_t, tri_t)
    prim = jnp.where(use_sph, T + sph_i, tri_i)
    prim = jnp.where(jnp.isfinite(t), prim, -1)
    return jax.lax.stop_gradient(prim), jax.lax.stop_gradient(t)


METHODS = ("auto", "pallas", "bruteforce", "bvh")


def find_hit(scene, org, dir, time, t_min=None, method="auto"):
    """Dispatch hit finding -> ``(prim [R] int32, t [R])``.

    ``method``:
      * ``auto`` — the clustered Pallas kernel on the GPU, jnp brute force
        on the CPU (ops/backend.py decides when the call is lowered);
      * ``pallas`` — the clustered Pallas kernel everywhere (interpret mode
        on the CPU, for tests);
      * ``bruteforce`` — tiled jnp scan over every triangle;
      * ``bvh`` — stackless skip-link BVH traversal (correctness referee).
    """
    from sexy_raytracer_jax.ops import pallas_find
    from sexy_raytracer_jax.ops.backend import by_platform

    R = org.shape[0]
    t_min = _per_ray(t_min, R)
    if method == "bruteforce":
        return find_hit_bruteforce(scene, org, dir, time, t_min)
    if method == "bvh":
        from sexy_raytracer_jax.ops.bvh_traverse import find_hit_bvh

        return find_hit_bvh(scene, org, dir, time, t_min)

    def kernel(interpret):
        return lambda *a: pallas_find.find_hit_clustered(
            *a, interpret=interpret
        )

    if method == "pallas":
        cpu = kernel(True)
    elif method == "auto":
        cpu = find_hit_bruteforce
    else:
        raise ValueError(f"unknown find method {method!r}; one of {METHODS}")
    prim, t = by_platform(scene, org, dir, time, t_min,
                          gpu=kernel(False), cpu=cpu)
    return jax.lax.stop_gradient(prim), jax.lax.stop_gradient(t)


def _per_ray(t_min, R):
    if t_min is None:
        return jnp.full((R,), T_MIN_DEFAULT, jnp.float32)
    return jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (R,))


# ---------------------------------------------------------------------------
# Phase 2: differentiable hit record
# ---------------------------------------------------------------------------

def _triangle_record(scene, org, dir, tri_id):
    """Recompute the triangle hit data for known winners (model.h:156-181).

    All per-triangle data rides a single packed-row gather: one [T,16] row
    fetch instead of seven separate table lookups. The pack is concatenated from the primal scene
    arrays inside the trace, so gradients flow back to them.
    """
    i = jnp.clip(tri_id, 0, max(scene.tri_v0.shape[0] - 1, 0))
    pack = jnp.concatenate(
        [
            scene.tri_v0,
            scene.tri_v1,
            scene.tri_v2,
            scene.tri_uv0,
            scene.tri_uv1,
            scene.tri_uv2,
            # material id rides the float pack as raw bits: one gather total
            jax.lax.bitcast_convert_type(scene.tri_mat, jnp.float32)[:, None],
        ],
        axis=1,
    )  # [T, 16]
    g = table_lookup(pack, i)
    v0, v1, v2 = g[:, 0:3], g[:, 3:6], g[:, 6:9]
    uv0, uv1, uv2 = g[:, 9:11], g[:, 11:13], g[:, 13:15]
    mat = jax.lax.bitcast_convert_type(
        jax.lax.stop_gradient(g[:, 15]), jnp.int32
    )
    n = jnp.cross(v1 - v0, v2 - v0)

    ndir = jnp.sum(n * dir, axis=-1)
    d = -jnp.sum(n * v0, axis=-1)
    safe = jnp.where(ndir == 0.0, -1.0, ndir)
    t = -(jnp.sum(n * org, axis=-1) + d) / safe
    p = org + t[..., None] * dir

    # inverse-distance "barycentric" weights (model.h:157-166).
    # uv feeds only nearest-neighbor texture lookups, whose gradient w.r.t.
    # uv is identically zero — stop_gradient blocks NaN-generating backward
    # paths (sqrt at 0) without losing any real gradient.
    def invdist(v):
        dist = safe_sqrt(jnp.sum((p - v) ** 2, axis=-1))
        return 1.0 / jnp.maximum(dist, 1e-20)

    r0, r1, r2 = invdist(v0), invdist(v1), invdist(v2)
    denom = r0 + r1 + r2
    r0, r1, r2 = r0 / denom, r1 / denom, r2 / denom
    u = r0 * uv0[..., 0] + r1 * uv1[..., 0] + r2 * uv2[..., 0]
    v = 1.0 - (r0 * uv0[..., 1] + r1 * uv1[..., 1] + r2 * uv2[..., 1])
    uv = jax.lax.stop_gradient(jnp.stack([u, v], axis=-1))

    outward = unit_vector(n)
    # back-face culling guarantees front hits (model.h:122-123)
    front = jnp.sum(dir * outward, axis=-1) < 0.0
    normal = jnp.where(front[..., None], outward, -outward)

    # tangent basis from UV-space edge deltas (model.h:214-235)
    e0 = v1 - v0
    e1 = v2 - v0
    duv0 = uv1 - uv0
    duv1 = uv2 - uv0
    f = duv0[..., 0] * duv1[..., 1] - duv1[..., 0] * duv0[..., 1]
    f = jnp.where(f == 0.0, EPSILON, f)
    inv_f = 1.0 / f
    tangent = unit_vector(
        inv_f[..., None]
        * (duv1[..., 1:2] * e0 - duv0[..., 1:2] * e1)
    )
    bitangent = unit_vector(
        inv_f[..., None]
        * (-duv1[..., 0:1] * e0 + duv0[..., 0:1] * e1)
    )
    return p, normal, tangent, bitangent, uv, t, front, mat


def _sphere_record(scene, org, dir, time, sph_id, t_min):
    """Recompute the sphere hit data for known winners (sphere.h:54-106).

    Single packed-row gather (see _triangle_record)."""
    S = scene.sph_c0.shape[0]
    i = jnp.clip(sph_id, 0, max(S - 1, 0))
    pack = jnp.concatenate(
        [
            scene.sph_c0,
            scene.sph_c1,
            scene.sph_t0[:, None],
            scene.sph_t1[:, None],
            scene.sph_radius[:, None],
            jax.lax.bitcast_convert_type(scene.sph_mat, jnp.float32)[:, None],
        ],
        axis=1,
    )  # [S, 10]
    g = table_lookup(pack, i)
    c0, c1 = g[:, 0:3], g[:, 3:6]
    t0, t1, r = g[:, 6], g[:, 7], g[:, 8]
    mat = jax.lax.bitcast_convert_type(
        jax.lax.stop_gradient(g[:, 9]), jnp.int32
    )
    moving = jnp.any(c0 != c1, axis=-1)
    denom = jnp.where(t1 == t0, 1.0, t1 - t0)
    frac = (time - t0) / denom
    center = jnp.where(moving[..., None], c0 + frac[..., None] * (c1 - c0), c0)
    oc = org - center
    a = jnp.sum(dir * dir, axis=-1)
    half_b = jnp.sum(oc * dir, axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - r * r
    disc = half_b * half_b - a * c
    sqrtd = safe_sqrt(disc)  # finite gradient for non-winner garbage lanes
    safe_a = jnp.where(a == 0.0, 1.0, a)
    root0 = (-half_b - sqrtd) / safe_a
    root1 = (-half_b + sqrtd) / safe_a
    t = jnp.where(root0 >= t_min, root0, root1)
    p = org + t[..., None] * dir
    outward = unit_vector(p - center)  # no /radius (sphere.h:76)
    front = jnp.sum(dir * outward, axis=-1) < 0.0
    normal = jnp.where(front[..., None], outward, -outward)

    # spherical UV from the outward normal (sphere.h:32-38). stop_gradient:
    # uv only drives nearest-neighbor texture fetches (zero gradient), and
    # arccos/atan2 have infinite derivatives at the poles.
    outward_sg = jax.lax.stop_gradient(outward)
    theta = jnp.arccos(jnp.clip(-outward_sg[..., 1], -1.0, 1.0))
    phi = jnp.arctan2(-outward_sg[..., 2], outward_sg[..., 0]) + PI
    uv = jnp.stack([phi / (2.0 * PI), theta / PI], axis=-1)

    # tangent basis (sphere.h:96-106)
    near_pole = (1.0 - jnp.abs(outward[..., 1])) < EPSILON
    b = jnp.where(
        near_pole[..., None],
        jnp.array([0.0, 0.0, -1.0]),
        jnp.array([0.0, 1.0, 0.0]),
    )
    tangent = unit_vector(jnp.cross(b, outward))
    bitangent = unit_vector(jnp.cross(outward, tangent))
    return p, normal, tangent, bitangent, uv, t, front, mat


def hit_data(scene, org, dir, time, prim_id, t_min=None) -> HitRecord:
    """Differentiable hit record for rays whose winner is ``prim_id``.

    Where ``prim_id < 0`` the record contents are arbitrary but finite and
    ``hit`` is False.
    """
    R = org.shape[0]
    if t_min is None:
        t_min = jnp.full((R,), T_MIN_DEFAULT)
    elif jnp.ndim(t_min) == 0:
        t_min = jnp.full((R,), t_min)

    T = scene.tri_v0.shape[0]
    S = scene.sph_c0.shape[0]
    hit = prim_id >= 0
    is_tri = hit & (prim_id < T)
    is_sph = hit & (prim_id >= T)

    if T > 0:
        tri_id = jnp.where(is_tri, prim_id, 0)
        tri = _triangle_record(scene, org, dir, tri_id)
    else:
        tri = None
    if S > 0:
        sph_id = jnp.where(is_sph, prim_id - T, 0)
        sph = _sphere_record(scene, org, dir, time, sph_id, t_min)
    else:
        sph = None

    if tri is None and sph is None:
        zeros3 = jnp.zeros((R, 3))
        return HitRecord(
            p=zeros3,
            normal=zeros3,
            tangent=zeros3,
            bitangent=zeros3,
            uv=jnp.zeros((R, 2)),
            t=jnp.full((R,), jnp.inf),
            front_face=jnp.zeros((R,), bool),
            mat_id=jnp.zeros((R,), jnp.int32),
            hit=jnp.zeros((R,), bool),
        )

    if tri is None:
        fields = sph
    elif sph is None:
        fields = tri
    else:
        sel = is_tri

        def pick(a, b):
            mask = sel
            if a.ndim > 1:
                mask = sel.reshape(sel.shape + (1,) * (a.ndim - 1))
            return jnp.where(mask, a, b)

        fields = tuple(pick(a, b) for a, b in zip(tri, sph))

    p, normal, tangent, bitangent, uv, t, front, mat = fields
    mat = jnp.where(hit, mat, 0).astype(jnp.int32)
    return HitRecord(
        p=p,
        normal=normal,
        tangent=tangent,
        bitangent=bitangent,
        uv=uv,
        t=jnp.where(hit, t, jnp.inf),
        front_face=front & hit,
        mat_id=mat,
        hit=hit,
    )
