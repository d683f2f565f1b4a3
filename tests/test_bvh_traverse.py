"""BVH traversal vs brute-force hit finding: identical winners."""

import numpy as np
import jax.numpy as jnp
import pytest

from sexy_raytracer_jax.models import SceneBuilder
from sexy_raytracer_jax.ops.bvh_traverse import find_hit_bvh
from sexy_raytracer_jax.ops.intersect import find_hit_bruteforce


def _scene(rng, n_tris=200, n_sph=40):
    b = SceneBuilder()
    mat = b.add_pbr_material()
    for _ in range(n_tris):
        b.add_mesh(rng.normal(size=(3, 3)) * 3, None, [[0, 1, 2]], mat)
    for _ in range(n_sph):
        c = rng.normal(size=3) * 4
        b.add_sphere(c, 0.2 + rng.random(), mat,
                     center1=c + rng.normal(size=3) * 0.3)
    return b.build(build_bvh=True)


def test_bvh_matches_bruteforce(rng_np):
    scene = _scene(rng_np)
    R = 1024
    org = jnp.asarray(rng_np.normal(size=(R, 3)) * 4, jnp.float32)
    dir = jnp.asarray(rng_np.normal(size=(R, 3)), jnp.float32)
    time = jnp.asarray(rng_np.random(R), jnp.float32)
    p1, t1 = find_hit_bruteforce(scene, org, dir, time)
    p2, t2 = find_hit_bvh(scene, org, dir, time)
    p1, p2, t1, t2 = map(np.asarray, (p1, p2, t1, t2))
    # identical math evaluated in a different order: allow a tiny tie budget
    assert (p1 != p2).sum() <= 2
    fin = np.isfinite(t1) & np.isfinite(t2) & (p1 == p2)
    np.testing.assert_allclose(t1[fin], t2[fin], rtol=1e-4, atol=1e-4)


def test_bvh_requires_tree():
    b = SceneBuilder()
    b.add_sphere((0, 0, 0), 1.0, b.add_pbr_material())
    scene = b.build(build_bvh=False)
    with pytest.raises(ValueError):
        find_hit_bvh(scene, jnp.zeros((1, 3)), jnp.ones((1, 3)), jnp.zeros((1,)))
