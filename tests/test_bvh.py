"""BVH build/flatten structural tests."""

import numpy as np

from sexy_raytracer_jax.models import SceneBuilder
from sexy_raytracer_jax.models.bvh import (
    build_bvh_numpy,
    primitive_bounds,
    validate_bvh,
)


def _scene(rng, n_tris=50, n_sph=20):
    b = SceneBuilder()
    mat = b.add_pbr_material()
    for _ in range(n_tris):
        v = rng.normal(size=(3, 3)) * 4.0
        b.add_mesh(v, None, [[0, 1, 2]], mat)
    for _ in range(n_sph):
        b.add_sphere(rng.normal(size=3) * 5.0, 0.2 + rng.random(), mat)
    return b.build(build_bvh=False, device=False)


def test_build_structure(rng_np):
    scene = _scene(rng_np)
    pmin, pmax = primitive_bounds(scene)
    bvh = build_bvh_numpy(pmin, pmax)
    assert bvh.left[0] != -1 or pmin.shape[0] == 1  # root is interior
    validate_bvh(bvh, pmin, pmax)


def test_single_primitive():
    b = SceneBuilder()
    b.add_sphere((0, 0, 0), 1.0, b.add_pbr_material())
    scene = b.build(build_bvh=False, device=False)
    pmin, pmax = primitive_bounds(scene)
    bvh = build_bvh_numpy(pmin, pmax)
    assert bvh.left.shape[0] == 1
    assert bvh.left[0] == -1 and bvh.right[0] == 0
    validate_bvh(bvh, pmin, pmax)


def test_flat_triangle_padding():
    """Axis-flat triangles get padded boxes (model.h:199-204)."""
    b = SceneBuilder()
    mat = b.add_pbr_material()
    b.add_mesh([[0, 0, 0], [1, 0, 0], [0, 1, 0]], None, [[0, 1, 2]], mat)
    scene = b.build(build_bvh=False, device=False)
    pmin, pmax = primitive_bounds(scene)
    assert pmax[0, 2] - pmin[0, 2] > 1e-5  # z was flat


def test_moving_sphere_bounds():
    """Sphere box = union over [time0, time1] (sphere.h:85-94)."""
    b = SceneBuilder()
    b.add_sphere((0, 0, 0), 1.0, b.add_pbr_material(), center1=(4, 0, 0))
    scene = b.build(build_bvh=False, device=False)
    pmin, pmax = primitive_bounds(scene, 0.0, 1.0)
    np.testing.assert_allclose(pmin[0], [-1, -1, -1])
    np.testing.assert_allclose(pmax[0], [5, 1, 1])
