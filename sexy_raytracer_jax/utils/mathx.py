"""Vector math helpers on SoA ``[..., 3]`` arrays.

Counterpart of the reference's Eigen-based helpers
(reference vec3.h:29-110, globals.h:13-27). Everything operates on batched
``jnp`` arrays; the trailing axis is the vector component axis.
"""

from __future__ import annotations

import jax.numpy as jnp

INFINITY = jnp.inf
# reference globals.h:14 — epsilon = FLT_EPSILON
EPSILON = float(jnp.finfo(jnp.float32).eps)
PI = 3.1415926535897932385


def deg2rad(degrees):
    # reference globals.h:26
    return degrees * PI / 180.0


def dot(a, b):
    return jnp.sum(a * b, axis=-1)


def length_squared(v):
    # reference vec3.h:29
    return jnp.sum(v * v, axis=-1)


def length(v):
    # reference vec3.h:33
    return jnp.sqrt(length_squared(v))


def distance(u, v):
    # reference vec3.h:37
    return length(u - v)


def safe_sqrt(x, eps=1e-24):
    """sqrt with a finite gradient everywhere.

    ``sqrt(max(x, eps))``: for x <= eps the max has zero gradient, so the
    (huge but finite) sqrt' at eps is multiplied by 0 instead of producing
    the classic ``0 * inf = NaN`` through unselected ``where`` branches.
    """
    return jnp.sqrt(jnp.maximum(x, eps))


def unit_vector(v):
    """Normalize, returning ``v`` unchanged for zero-length inputs.

    Matches the reference's zero-guard (vec3.h:54-60) and keeps both the
    primal and the gradient NaN-free under ``jit`` (both branches of
    ``where`` are evaluated, so the division and sqrt are guarded).
    """
    len2 = length_squared(v)[..., None]
    len_ = safe_sqrt(len2)
    return jnp.where(len2 == 0.0, v, v / len_)


def near_zero(v):
    # reference vec3.h:49
    s = 1e-8
    return jnp.all(jnp.abs(v) < s, axis=-1)


def reflect(v, n):
    # reference vec3.h:76
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(uv, n, eta_i_over_eta_t):
    # reference vec3.h:80-86 (safe_sqrt: finite gradient at total internal
    # reflection boundary)
    cos_theta = jnp.minimum(dot(n, -uv), 1.0)
    r_out_perp = eta_i_over_eta_t[..., None] * (uv + cos_theta[..., None] * n)
    r_out_parallel = (
        -safe_sqrt(jnp.abs(1.0 - length_squared(r_out_perp)))[..., None] * n
    )
    return r_out_perp + r_out_parallel


def lerp(a, b, t):
    # reference vec3.h:97
    return (1.0 - t) * a + t * b


def normal_int_to_float(n):
    """Map a 0-255-scale normal-map texel to [-1, 1] (reference vec3.h:103)."""
    return (n - 128.0) / 128.0


def cross(a, b):
    return jnp.cross(a, b)
