"""Counter-based random sampling for the path tracer.

The reference consumes one global ``std::mt19937`` sequentially
(reference globals.h:30-43) — unreproducible on a parallel machine. We use
JAX's threefry counter-based RNG keyed by (pixel-batch, sample, bounce), which
is deterministic, order-independent, and shard-friendly: every ray derives its
randomness from its own coordinates, so resharding the ray batch across chips
does not change the image.

Distributions match the reference's *distributions* (not sequences):

  * ``random_unit_vector`` — uniform on S^2 (reference vec3.h:72 draws a
    rejection-sampled point in the unit ball and normalizes it, which is
    exactly uniform on the sphere).
  * ``random_in_unit_sphere`` — uniform in the unit ball (reference
    vec3.h:62, used for metal fuzz).
  * ``random_in_unit_disk`` — uniform in the unit disk (reference vec3.h:88,
    thin-lens aperture sampling).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from sexy_raytracer_jax.utils.mathx import PI


def uniform(key, shape, lo=0.0, hi=1.0):
    return jax.random.uniform(key, shape, minval=lo, maxval=hi, dtype=jnp.float32)


# ---------------------------------------------------------------------------
# Per-ray draws: each ray owns a PRNG key derived from its (pixel, sample)
# uid, so every sample is independent of batch layout/sharding.
#
# For speed, all shaped distributions are derived from raw
# uniform words (one batched threefry invocation per block of draws) using
# closed-form transforms — no erfinv/rejection:
#   unit sphere direction: z = 1-2u, phi = 2 pi v (area-preserving)
#   ball radius: u^(1/3);  disk radius: sqrt(u)
# ---------------------------------------------------------------------------

def ray_keys(base_key, ray_uid):
    """Derive one key per ray from its integer uid (counter-based)."""
    return jax.vmap(lambda u: jax.random.fold_in(base_key, u))(ray_uid)


def ray_keys_2d(base_key, pid, sid):
    """One key per (pixel, sample) pair via a two-level fold-in.

    A flat ``pid * spp + sid`` uid overflows int32 at the flagship config
    (1280*720*5000 = 4.6e9 > 2^31: ~7% of samples would alias another
    sample's key exactly). Folding the two coordinates in separately keeps
    every (pid, sid) pair distinct for any pid, sid < 2^32 — and sample
    indices beyond spp (sharded overshoot) stay collision-free too.
    """
    return jax.vmap(
        lambda p, s: jax.random.fold_in(jax.random.fold_in(base_key, p), s)
    )(pid, sid)


def split_per_ray(keys, n):
    """Split each per-ray key into ``n`` subkeys: returns list of [R] keys."""
    return [jax.vmap(lambda k, i=i: jax.random.fold_in(k, i))(keys) for i in range(n)]


def per_ray_uniform_block(keys, n):
    """[R] keys -> [R, n] iid U[0,1) floats (24-bit resolution)."""
    bits = jax.vmap(lambda k: jax.random.bits(k, (n,)))(keys)
    return (bits >> 8).astype(jnp.float32) * jnp.float32(1.0 / (1 << 24))


def unit_vector_from_uniforms(u, v):
    """U[0,1)^2 -> uniform direction on S^2."""
    z = 1.0 - 2.0 * u
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    phi = (2.0 * PI) * v
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def in_unit_sphere_from_uniforms(u, v, w):
    """U[0,1)^3 -> uniform point in the unit ball."""
    d = unit_vector_from_uniforms(u, v)
    return d * (w ** (1.0 / 3.0))[..., None]


def in_unit_disk_from_uniforms(u, v):
    """U[0,1)^2 -> uniform point in the unit disk."""
    r = jnp.sqrt(u)
    theta = (2.0 * PI) * v
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)


# Slower key-per-draw variants (kept for tests / reference use)

def per_ray_uniform(keys, lo=0.0, hi=1.0):
    u = per_ray_uniform_block(keys, 1)[..., 0]
    return lo + (hi - lo) * u


def per_ray_unit_vector(keys):
    u = per_ray_uniform_block(keys, 2)
    return unit_vector_from_uniforms(u[..., 0], u[..., 1])


def per_ray_in_unit_sphere(keys):
    u = per_ray_uniform_block(keys, 3)
    return in_unit_sphere_from_uniforms(u[..., 0], u[..., 1], u[..., 2])


def per_ray_in_unit_disk(keys):
    u = per_ray_uniform_block(keys, 2)
    return in_unit_disk_from_uniforms(u[..., 0], u[..., 1])


def random_unit_vector(key, shape):
    """Uniform directions on the unit sphere, shape ``shape + (3,)``."""
    g = jax.random.normal(key, shape + (3,), dtype=jnp.float32)
    norm = jnp.sqrt(jnp.sum(g * g, axis=-1, keepdims=True))
    norm = jnp.maximum(norm, 1e-12)
    return g / norm


def random_in_unit_sphere(key, shape):
    """Uniform points inside the unit ball, shape ``shape + (3,)``."""
    k_dir, k_r = jax.random.split(key)
    d = random_unit_vector(k_dir, shape)
    # radius ~ u^(1/3) gives uniform density in the ball
    r = jax.random.uniform(k_r, shape, dtype=jnp.float32) ** (1.0 / 3.0)
    return d * r[..., None]


def random_in_unit_disk(key, shape):
    """Uniform points inside the unit disk, shape ``shape + (2,)``."""
    k_theta, k_r = jax.random.split(key)
    theta = jax.random.uniform(
        k_theta, shape, minval=0.0, maxval=2.0 * PI, dtype=jnp.float32
    )
    r = jnp.sqrt(jax.random.uniform(k_r, shape, dtype=jnp.float32))
    return jnp.stack([r * jnp.cos(theta), r * jnp.sin(theta)], axis=-1)
