"""BVH traversal hit finding — stackless threaded (skip-link) form.

The reference prototyped stack-based traversal in its compute shader
(compute.glsl:154-185: ``uint stack[32]``, leaf test
``leftAndRight.r != -1``). Under ``vmap`` a per-lane stack makes every
push a dynamic scatter over the whole wavefront. Instead the tree is
threaded with preorder skip links
(models/bvh.py compute_skip): an interior hit descends to ``node+1`` (the
preorder left child), a miss or leaf jumps to ``skip[node]`` — no stack,
no scatter, pure gathers, one ``lax.while_loop`` over lockstep rays.

Traversal semantics follow bvhNode::hit (reference bvh.h:97-105): node
boxes are tested against [t_min, current-best-t] so subtrees are pruned as
the closest hit shrinks, descending left-first like the reference. Unlike
the reference, leaf primitive hits DO respect the current best (the
reference's triangle ignores tMax, model.h:128-129 — see ops/intersect.py
for why that quirk is not reproduced).

``method="bvh"`` selects it; the clustered kernel of ops/pallas_find.py is
the production search at every scene size.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from sexy_raytracer_jax.utils.mathx import EPSILON

_BIG = 3.0e38
# float32 products in full precision: TF32 must not decide a hit
dot = functools.partial(jnp.dot, precision=jax.lax.Precision.HIGHEST)


def _make_traverse(scene):
    """Build the single-ray traversal closure over scene arrays."""
    bvh_min = scene.bvh_min
    bvh_max = scene.bvh_max
    bvh_left = scene.bvh_left
    bvh_right = scene.bvh_right
    T = scene.tri_v0.shape[0]

    tri_n = scene.tri_n
    tri_d = scene.tri_d
    tri_q = scene.tri_q
    tri_c = scene.tri_c

    sph_c0 = scene.sph_c0
    sph_c1 = scene.sph_c1
    sph_t0 = scene.sph_t0
    sph_t1 = scene.sph_t1
    sph_r = scene.sph_radius
    S = sph_c0.shape[0]

    def tri_hit(i, org, dir, t_min):
        n = tri_n[i]
        ndir = dot(n, dir)
        plane_ok = ndir <= -EPSILON
        t = -(dot(n, org) + tri_d[i]) / jnp.where(plane_ok, ndir, 1.0)
        q = tri_q[i]  # [3,3]
        c = tri_c[i]  # [3]
        w = dot(q, org) + t * dot(q, dir) - c
        ok = plane_ok & jnp.all(w >= 0.0) & (t >= t_min)
        return jnp.where(ok, t, _BIG)

    def sph_hit(s, org, dir, time, t_max, t_min):
        c0 = sph_c0[s]
        c1 = sph_c1[s]
        moving = jnp.any(c0 != c1)
        denom = jnp.where(sph_t1[s] == sph_t0[s], 1.0, sph_t1[s] - sph_t0[s])
        frac = (time - sph_t0[s]) / denom
        center = jnp.where(moving, c0 + frac * (c1 - c0), c0)
        oc = org - center
        a = dot(dir, dir)
        half_b = dot(oc, dir)
        cterm = dot(oc, oc) - sph_r[s] * sph_r[s]
        disc = half_b * half_b - a * cterm
        has = disc >= 0.0
        sqrtd = jnp.sqrt(jnp.where(has, disc, 0.0))
        safe_a = jnp.where(a == 0.0, 1.0, a)
        r0 = (-half_b - sqrtd) / safe_a
        r1 = (-half_b + sqrtd) / safe_a
        ok0 = has & (r0 >= t_min) & (r0 <= t_max)
        ok1 = has & (r1 >= t_min) & (r1 <= t_max)
        root = jnp.where(ok0, r0, r1)
        return jnp.where(ok0 | ok1, root, _BIG)

    def aabb_hit(node, org, inv_dir, t_max, t_min):
        # slab test, aabb.h:13-24 (IEEE inf semantics on zero components)
        t0 = (bvh_min[node] - org) * inv_dir
        t1 = (bvh_max[node] - org) * inv_dir
        tmin = jnp.max(jnp.minimum(t0, t1))
        tmax = jnp.min(jnp.maximum(t0, t1))
        lo = jnp.maximum(tmin, t_min)
        hi = jnp.minimum(tmax, t_max)
        return hi > lo

    bvh_skip = scene.bvh_skip
    N = bvh_left.shape[0]

    def traverse(org, dir, time, t_min):
        inv_dir = 1.0 / dir  # inf on zero components, like the reference
        state = (jnp.int32(0), jnp.float32(_BIG), jnp.int32(-1))

        def cond(state):
            node, _, _ = state
            return node < N

        def body(state):
            node, best_t, best_i = state
            box_ok = aabb_hit(node, org, inv_dir, best_t, t_min)
            left = bvh_left[node]
            right = bvh_right[node]
            is_leaf = left == -1

            # leaf: primitive test (prim id encodes kind)
            prim = right
            if T > 0 and S > 0:
                is_tri = prim < T
                t_prim = jnp.where(
                    is_tri,
                    tri_hit(jnp.minimum(prim, T - 1), org, dir, t_min),
                    sph_hit(jnp.maximum(prim - T, 0), org, dir, time, best_t, t_min),
                )
            elif T > 0:
                t_prim = tri_hit(prim, org, dir, t_min)
            else:
                t_prim = sph_hit(prim - T, org, dir, time, best_t, t_min)
            take = is_leaf & box_ok & (t_prim < best_t)
            best_t = jnp.where(take, t_prim, best_t)
            best_i = jnp.where(take, prim, best_i)

            # threaded step: descend (preorder left child = node+1) on an
            # interior box hit, otherwise escape past the subtree
            node = jnp.where(box_ok & ~is_leaf, node + 1, bvh_skip[node])
            return (node, best_t, best_i)

        _, best_t, best_i = jax.lax.while_loop(cond, body, state)
        return jnp.where(best_t < _BIG, best_t, jnp.inf), best_i

    return traverse


def find_hit_bvh(scene, org, dir, time, t_min=None):
    """BVH-traversal hit finding; same contract as find_hit_bruteforce."""
    from sexy_raytracer_jax.ops.intersect import T_MIN_DEFAULT

    if scene.bvh_min.shape[0] == 0:
        raise ValueError("scene has no BVH; build with build_bvh=True")
    R = org.shape[0]
    if t_min is None:
        t_min = jnp.full((R,), T_MIN_DEFAULT, jnp.float32)
    elif jnp.ndim(t_min) == 0:
        t_min = jnp.full((R,), t_min, jnp.float32)

    traverse = _make_traverse(scene)
    t, prim = jax.vmap(traverse)(
        jax.lax.stop_gradient(org),
        jax.lax.stop_gradient(dir),
        jax.lax.stop_gradient(time),
        jax.lax.stop_gradient(t_min),
    )
    prim = jnp.where(jnp.isfinite(t), prim, -1)
    return jax.lax.stop_gradient(prim), jax.lax.stop_gradient(t)
