"""Kernel-vs-oracle tests for intersection (SURVEY §4 test strategy).

Device hit finding + hit records are validated against the scalar numpy
oracle that transcribes the reference math (oracle/reference.py), over
fuzzed random rays and primitives.
"""

import numpy as np
import pytest

from sexy_raytracer_jax.models import SceneBuilder
from sexy_raytracer_jax.oracle import reference as oracle
from sexy_raytracer_jax.ops.intersect import find_hit_bruteforce, hit_data

import jax.numpy as jnp


def random_scene(rng, n_tris=20, n_sph=10, moving=False):
    b = SceneBuilder()
    mat = b.add_pbr_material(base_color=(0.5, 0.5, 0.5, 1.0))
    for _ in range(n_tris):
        v = rng.normal(size=(3, 3)) * 2.0
        uv = rng.random((3, 2))
        b.add_mesh(v, uv, [[0, 1, 2]], mat)
    for _ in range(n_sph):
        c = rng.normal(size=3) * 3.0
        c1 = c + rng.normal(size=3) * 0.5 if moving else None
        b.add_sphere(c, 0.3 + rng.random(), mat, center1=c1)
    return b.build(build_bvh=False)


def random_rays(rng, n):
    org = rng.normal(size=(n, 3)) * 5.0
    dir = rng.normal(size=(n, 3))
    time = rng.random(n)
    return org, dir, time


def oracle_closest(scene, o, d, time, t_min=0.001):
    """True closest hit over all primitives (no traversal-order quirk)."""
    best_t, best_prim, best_rec = np.inf, -1, None
    T = scene.tri_v0.shape[0]
    for i in range(T):
        rec = oracle.triangle_hit(scene, i, o, d, t_min, np.inf)
        if rec is not None and rec.t < best_t:
            best_t, best_prim, best_rec = rec.t, i, rec
    for s in range(scene.sph_c0.shape[0]):
        rec = oracle.sphere_hit(scene, s, o, d, time, t_min, np.inf)
        if rec is not None and rec.t < best_t:
            best_t, best_prim, best_rec = rec.t, T + s, rec
    return best_prim, best_t, best_rec


@pytest.mark.parametrize("moving", [False, True])
def test_find_hit_matches_oracle(rng_np, moving):
    scene = random_scene(rng_np, moving=moving)
    org, dir, time = random_rays(rng_np, 256)
    prim, t = find_hit_bruteforce(
        scene, jnp.asarray(org, jnp.float32), jnp.asarray(dir, jnp.float32),
        jnp.asarray(time, jnp.float32)
    )
    prim = np.asarray(prim)
    t = np.asarray(t)
    scene_np = oracle._as_numpy(scene)
    mismatches = 0
    for r in range(org.shape[0]):
        o_prim, o_t, _ = oracle_closest(
            scene_np, org[r].astype(np.float32), dir[r].astype(np.float32), time[r]
        )
        if o_prim != prim[r]:
            # f32 vs f64 can flip near-ties; accept if t's agree closely
            if np.isfinite(o_t) and np.isfinite(t[r]):
                assert abs(o_t - t[r]) / max(abs(o_t), 1e-6) < 1e-2
                mismatches += 1
            else:
                # grazing hits can differ in f32; allow a tiny budget
                mismatches += 1
        elif o_prim >= 0:
            # kernel uses a precomputed f32 plane/edge pack; the oracle
            # recomputes in f64 — grazing hits can disagree at ~1e-3
            assert abs(o_t - t[r]) / max(abs(o_t), 1e-6) < 1e-2
    assert mismatches <= 3


def test_hit_record_matches_oracle():
    rng_np = np.random.default_rng(42)
    scene = random_scene(rng_np, n_tris=30, n_sph=15)
    org, dir, time = random_rays(rng_np, 256)
    org = org * 0.6  # denser ray origins -> more hits
    prim, t = find_hit_bruteforce(
        scene, jnp.asarray(org, jnp.float32), jnp.asarray(dir, jnp.float32),
        jnp.asarray(time, jnp.float32)
    )
    rec = hit_data(
        scene, jnp.asarray(org, jnp.float32), jnp.asarray(dir, jnp.float32),
        jnp.asarray(time, jnp.float32), prim
    )
    prim_np = np.asarray(prim)
    scene_np = oracle._as_numpy(scene)
    T = scene.tri_v0.shape[0]
    checked = 0
    for r in range(org.shape[0]):
        if prim_np[r] < 0:
            assert not bool(rec.hit[r])
            continue
        o = org[r].astype(np.float32)
        d = dir[r].astype(np.float32)
        if prim_np[r] < T:
            orec = oracle.triangle_hit(scene_np, int(prim_np[r]), o, d, 0.001, np.inf)
        else:
            orec = oracle.sphere_hit(
                scene_np, int(prim_np[r]) - T, o, d, time[r], 0.001, np.inf
            )
        assert orec is not None
        np.testing.assert_allclose(rec.t[r], orec.t, rtol=2e-3)
        np.testing.assert_allclose(rec.p[r], orec.p, rtol=1e-2, atol=2e-3)
        np.testing.assert_allclose(rec.normal[r], orec.normal, rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(rec.uv[r], orec.uv, rtol=5e-3, atol=5e-3)
        np.testing.assert_allclose(rec.tangent[r], orec.tangent, rtol=1e-2, atol=1e-3)
        np.testing.assert_allclose(
            rec.bitangent[r], orec.bitangent, rtol=1e-2, atol=1e-3
        )
        assert bool(rec.front_face[r]) == orec.front_face
        assert int(rec.mat_id[r]) == orec.mat_id
        checked += 1
    assert checked > 50  # sanity: the fuzz actually hits things


def test_backface_culling(rng_np):
    """Triangles are invisible from behind (model.h:122-123)."""
    b = SceneBuilder()
    mat = b.add_pbr_material()
    b.add_mesh(
        [[-1, -1, 0], [1, -1, 0], [0, 1, 0]], None, [[0, 1, 2]], mat
    )
    scene = b.build(build_bvh=False)
    # normal = cross(v1-v0, v2-v0) = +z; ray going -z sees it...
    org = jnp.asarray([[0.0, 0.0, 5.0], [0.0, 0.0, -5.0]], jnp.float32)
    dir = jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, 1.0]], jnp.float32)
    time = jnp.zeros((2,))
    prim, t = find_hit_bruteforce(scene, org, dir, time)
    assert int(prim[0]) == 0      # front side hits
    assert int(prim[1]) == -1     # back side culled


def test_moving_sphere_center():
    b = SceneBuilder()
    mat = b.add_pbr_material()
    b.add_sphere((0, 0, 0), 1.0, mat, center1=(10, 0, 0), time0=0.0, time1=1.0)
    scene = b.build(build_bvh=False)
    org = jnp.asarray([[5.0, 0.0, 5.0]] * 2, jnp.float32)
    dir = jnp.asarray([[0.0, 0.0, -1.0]] * 2, jnp.float32)
    time = jnp.asarray([0.5, 0.0])
    prim, t = find_hit_bruteforce(scene, org, dir, time)
    assert int(prim[0]) == 0   # at t=0.5 center is at x=5 -> hit
    assert int(prim[1]) == -1  # at t=0 center at x=0 -> miss
