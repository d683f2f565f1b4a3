"""Flattened hittableIndexed-style export tests."""

import numpy as np

from sexy_raytracer_jax.models import SceneBuilder
from sexy_raytracer_jax.models.flatten import (
    PRIM_SPHERE,
    PRIM_TRIANGLE,
    to_indexed,
    validate_indexed,
)


def _scene(rng):
    b = SceneBuilder()
    mat = b.add_pbr_material()
    mat2 = b.add_metal_material((0.7, 0.6, 0.5), 0.1)
    for _ in range(20):
        b.add_mesh(rng.normal(size=(3, 3)) * 2, rng.random((3, 2)),
                   [[0, 1, 2]], mat)
    for _ in range(5):
        b.add_sphere(rng.normal(size=3) * 3, 0.5, mat2)
    return b.build(build_bvh=True, device=False)


def test_roundtrip_invariants(rng_np):
    scene = _scene(rng_np)
    indexed = to_indexed(scene)
    assert indexed.num_records == scene.num_bvh_nodes
    validate_indexed(indexed, scene)

    rec = indexed.records
    rec_i = rec.view(np.int32)
    # root is node 0 and is interior for a multi-primitive scene
    assert rec_i[0, 9, 0] >= 0
    # leaf records carry real geometry, UVs, and material ids (unlike the
    # reference's stubs model.h:261-271 / sphere.h:21-27)
    leaves = rec_i[:, 9, 0] == -1
    tri_leaves = leaves & (rec_i[:, 6, 1] == PRIM_TRIANGLE)
    sph_leaves = leaves & (rec_i[:, 6, 1] == PRIM_SPHERE)
    assert tri_leaves.sum() == scene.num_triangles
    assert sph_leaves.sum() == scene.num_spheres
    # a triangle leaf's positions match the scene arrays
    node = np.where(tri_leaves)[0][0]
    prim = rec_i[node, 6, 2]
    np.testing.assert_allclose(rec[node, 0, :3], scene.tri_v0[prim])
    np.testing.assert_allclose(rec[node, 3, :2], scene.tri_uv0[prim])
    assert rec_i[node, 6, 0] == scene.tri_mat[prim]
    # a sphere leaf carries center/radius
    node = np.where(sph_leaves)[0][0]
    prim = rec_i[node, 6, 2] - scene.num_triangles
    np.testing.assert_allclose(rec[node, 0, :3], scene.sph_c0[prim])
    assert rec[node, 2, 2] == scene.sph_radius[prim]
