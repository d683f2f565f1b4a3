"""Wavefront path-tracing integrator.

The reference's depth-4 recursion (reference main.cpp:33-52) rewritten as a
fixed number of bounce steps over a wavefront — exactly equivalent because
depth-out returns black (main.cpp:36-37), so a fixed-length loop with an
``alive`` mask computes the same sum:

    radiance = sum_k emitted_k * prod_{j<k} att_j   (+ background on miss)

SoA carry: (origin, dir, throughput, radiance, alive). Ray ``time`` is fixed
along a path (every scatter constructs the next ray with ``rIn.time``,
material.h:93,124,209).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.ad_checkpoint import checkpoint_name

from sexy_raytracer_jax.ops.intersect import T_MIN_DEFAULT, find_hit, hit_data
from sexy_raytracer_jax.ops.shade import shade
from sexy_raytracer_jax.utils import rng

_BIG = 3.0e38


@functools.partial(
    jax.checkpoint,
    policy=jax.checkpoint_policies.save_only_these_names("prim_ids"),
    static_argnums=(6,),
)
def _bounce(scene, carry, keys, time, bounce_idx, background, method):
    """One bounce of the wavefront -> ``(carry, t_min)``.

    Rematerialized for the backward pass: saving every shading intermediate
    made the AD forward several times slower than the pure forward. Only
    the winning primitive ids are saved — they are tiny AND keeping them
    means the backward recompute skips hit finding entirely (hit_data recomputes the differentiable
    record from ids, ops/intersect.py).
    """
    org, dir, thr, rad, alive = carry
    background = jnp.asarray(background, jnp.float32)

    # dead lanes get t_min = +huge: they miss everything and the clustered
    # kernel excludes them from its block cull lists, so fully-dead ray
    # blocks skip all triangle work (ops/pallas_find.py)
    t_min = jnp.where(alive, T_MIN_DEFAULT, _BIG)
    with jax.named_scope("find_hit"):
        prim, _t = find_hit(scene, org, dir, time, t_min=t_min,
                            method=method)
        prim = checkpoint_name(prim, "prim_ids")
    with jax.named_scope("hit_data"):
        rec = hit_data(scene, org, dir, time, prim)

    with jax.named_scope("bounce_rng"):
        bkeys = jax.vmap(
            lambda k: jax.random.fold_in(k, 100 + bounce_idx)
        )(keys)
        u = rng.per_ray_uniform_block(bkeys, 6)
    rand = {
        "unit_vector": rng.unit_vector_from_uniforms(u[..., 0], u[..., 1]),
        "unit_ball": rng.in_unit_sphere_from_uniforms(
            u[..., 2], u[..., 3], u[..., 4]
        ),
        "uniform": u[..., 5],
    }
    with jax.named_scope("shade"):
        samp = shade(scene, rec, dir, rand)

    miss = alive & ~rec.hit
    rad = rad + jnp.where(miss[..., None], thr * background, 0.0)
    rad = rad + jnp.where((alive & rec.hit)[..., None], thr * samp.emitted, 0.0)

    alive_next = alive & rec.hit & samp.scattered
    thr = jnp.where(alive_next[..., None], thr * samp.attenuation, thr)
    org = jnp.where(alive_next[..., None], rec.p, org)
    dir = jnp.where(alive_next[..., None], samp.direction, dir)
    return (org, dir, thr, rad, alive_next), t_min


def _initial_carry(org, dir):
    R = org.shape[0]
    return (
        org,
        dir,
        jnp.ones((R, 3), jnp.float32),
        jnp.zeros((R, 3), jnp.float32),
        jnp.ones((R,), bool),
    )


def trace_rays(
    scene,
    org,
    dir,
    time,
    keys,
    background,
    max_bounce: int,
    method: str = "auto",
):
    """Path-trace a wavefront of rays; returns radiance ``[R,3]``.

    ``keys``: [R] per-ray PRNG keys; per-bounce randomness is derived by
    folding in the bounce index, keeping every sample counter-based.

    The bounce loop is unrolled in Python (it is small and static), which
    lets XLA fuse across bounces; the per-bounce ``jax.checkpoint`` still
    bounds backward memory.
    """
    carry = _initial_carry(org, dir)
    for b in range(max_bounce):
        carry, _ = _bounce(scene, carry, keys, time, jnp.int32(b),
                           background, method)
    return carry[3]


def bounce_wavefronts(scene, org, dir, time, keys, background,
                      max_bounce: int, method: str = "auto"):
    """The rays each bounce of :func:`trace_rays` searches.

    Returns ``max_bounce`` tuples ``(org, dir, t_min)``, dead lanes marked
    by ``t_min = 3e38`` — the exact inputs of every ``find_hit`` call, for
    comparing hit-search kernels on real wavefronts.
    """
    carry = _initial_carry(org, dir)
    fronts = []
    for b in range(max_bounce):
        o, d = carry[0], carry[1]
        carry, t_min = _bounce(scene, carry, keys, time, jnp.int32(b),
                               background, method)
        fronts.append((o, d, t_min))
    return fronts
