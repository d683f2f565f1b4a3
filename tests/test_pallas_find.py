"""Clustered Pallas find kernel vs the jnp brute-force path, and the gather
gradient vs numpy.

The kernel runs in interpret mode on the CPU (the same kernel body that is
compiled for the GPU through Triton) and is fuzzed against
find_hit_bruteforce, which is itself oracle-fuzzed in test_intersect.py.
The scene is the seeded flagship stand-in: the flagship's triangle count,
clusters and furniture without its assets.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sexy_raytracer_jax.models import presets
from sexy_raytracer_jax.models.clusters import CLUSTER_SIZE
from sexy_raytracer_jax.models.scene import SceneBuilder
from sexy_raytracer_jax.ops import pallas_find
from sexy_raytracer_jax.ops.intersect import find_hit, find_hit_bruteforce
from sexy_raytracer_jax.ops.lookup import table_lookup
from sexy_raytracer_jax.render.camera import Camera


def _random_rays(rng_np, n, spread=3.0):
    org = jnp.asarray(rng_np.normal(0, spread, size=(n, 3)), jnp.float32)
    d = rng_np.normal(size=(n, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dirs = jnp.asarray(d, jnp.float32)
    times = jnp.asarray(rng_np.uniform(0, 1, size=n), jnp.float32)
    return org, dirs, times


def _assert_match(scene, org, dirs, times, t_min=None, method="pallas"):
    p1, t1 = find_hit(scene, org, dirs, times, t_min=t_min, method=method)
    p0, t0 = find_hit_bruteforce(scene, org, dirs, times, t_min=t_min)
    p1, t1, p0, t0 = map(np.asarray, (p1, t1, p0, t0))
    # identical formulas; interpret-mode-on-CPU FMA contraction can differ
    # by ulps, so permit winner flips only on near-exact t ties
    dis = p1 != p0
    frac = dis.mean()
    assert frac < 0.01, f"{dis.sum()}/{dis.size} winner mismatches"
    if dis.any():
        tt1 = np.where(np.isfinite(t1[dis]), t1[dis], 1e30)
        tt0 = np.where(np.isfinite(t0[dis]), t0[dis], 1e30)
        near_tie = np.abs(tt1 - tt0) <= 1e-3 * np.minimum(tt1, tt0) + 1e-5
        assert near_tie.all(), "winner mismatch beyond tie tolerance"
    agree = (p1 == p0) & (p0 >= 0)
    np.testing.assert_allclose(t1[agree], t0[agree], rtol=2e-4, atol=1e-4)
    return p0


@pytest.fixture(scope="module")
def standin():
    return presets.flagship_standin(height=120)


# the mesh stands at the origin, 0..4.4 high
_MESH_CENTER = np.array([0.0, 2.2, 0.0])


def _rays_at_mesh(rng_np, n):
    """Origins on a sphere of radius 5 around the mesh, aimed near it."""
    u = rng_np.normal(size=(n, 3))
    org = _MESH_CENTER + 5.0 * u / np.linalg.norm(u, axis=1, keepdims=True)
    aim = _MESH_CENTER + rng_np.normal(0, [0.6, 1.5, 0.4], size=(n, 3))
    d = aim - org
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    times = rng_np.uniform(0, 1, size=n)
    return (jnp.asarray(org, jnp.float32), jnp.asarray(d, jnp.float32),
            jnp.asarray(times, jnp.float32))


def test_kernel_matches_bruteforce_camera_rays(standin, rng_np):
    scene, cfg = standin
    camera = Camera.from_config(cfg.camera, cfg.aspect)
    n = 2048
    pid = jnp.asarray(rng_np.integers(0, cfg.width * cfg.height, n), jnp.int32)
    u = ((pid % cfg.width) + 0.5) / (cfg.width - 1)
    v = ((cfg.height - pid // cfg.width) + 0.5) / (cfg.height - 1)
    lens = jnp.asarray(rng_np.uniform(size=(n, 3)), jnp.float32)
    org, dirs, times = camera.get_rays(u, v, lens)
    p0 = _assert_match(scene, org, dirs, times)
    assert ((p0 >= 0) & (p0 < scene.num_triangles)).sum() > 50


def test_kernel_matches_bruteforce_random_rays(standin, rng_np):
    scene, _ = standin
    org, dirs, times = _rays_at_mesh(rng_np, 1024)
    p0 = _assert_match(scene, org, dirs, times)
    assert ((p0 >= 0) & (p0 < scene.num_triangles)).sum() > 50


def test_cull_keeps_every_hit_cluster(standin, rng_np):
    """Every cluster that holds a ray's brute-force hit is on the active
    list of that ray's block: the cull never drops a hit."""
    scene, _ = standin
    org, dirs, times = _rays_at_mesh(rng_np, 1024)
    t_min = jnp.full((1024,), 1e-3, jnp.float32)
    p0, _ = find_hit_bruteforce(scene, org, dirs, times, t_min=t_min)
    p0 = np.asarray(p0)
    lists = np.asarray(pallas_find.cluster_lists(
        org, dirs, t_min, scene.cluster_min, scene.cluster_max))
    tri = (p0 >= 0) & (p0 < scene.num_triangles)
    assert tri.sum() > 50
    for r in np.flatnonzero(tri):
        row = lists[r // pallas_find.RAY_BLOCK]
        assert p0[r] // CLUSTER_SIZE in row[1:1 + row[0]], r


def test_dead_lanes_miss_everything(standin, rng_np):
    scene, _ = standin
    org, dirs, times = _rays_at_mesh(rng_np, 512)
    t_min = jnp.where(jnp.arange(512) % 2 == 0, 1e-3, 3.0e38)
    p, t = find_hit(scene, org, dirs, times, t_min=t_min, method="pallas")
    p = np.asarray(p)
    assert np.all(p[1::2] == -1)
    # alive lanes agree with brute force at the same t_min
    p0, _ = find_hit_bruteforce(scene, org, dirs, times, t_min=t_min)
    np.testing.assert_array_equal(p[::2], np.asarray(p0)[::2])


def test_sphere_only_scene(rng_np):
    b = SceneBuilder()
    m = b.add_pbr_material(base_color=(0.5, 0.5, 0.5, 1.0))
    b.add_sphere((0, 0, -2), 1.0, m)
    b.add_sphere((0, -101, 0), 100.0, m)
    b.add_sphere((3, 0, -2), 1.0, m, center1=(3, 1, -2))  # moving
    scene = b.build()
    org, dirs, times = _random_rays(rng_np, 512)
    _assert_match(scene, org, dirs, times)


def test_per_ray_t_min(standin, rng_np):
    scene, _ = standin
    org, dirs, times = _rays_at_mesh(rng_np, 512)
    t_min = jnp.asarray(rng_np.uniform(0.0, 2.0, 512), jnp.float32)
    _assert_match(scene, org, dirs, times, t_min=t_min)


def test_kernel_matches_bruteforce_triangle_soup(rng_np):
    """Many clusters, few rays per cluster: every cull decision matters."""
    T = 9000
    c = rng_np.uniform(-8, 8, (T, 3))
    v0 = c + rng_np.normal(0, 0.15, (T, 3))
    v1 = c + rng_np.normal(0, 0.15, (T, 3))
    v2 = c + rng_np.normal(0, 0.15, (T, 3))
    b = SceneBuilder()
    m = b.add_pbr_material(base_color=(0.5, 0.5, 0.5, 1.0))
    idx = np.stack([np.arange(T), np.arange(T) + T, np.arange(T) + 2 * T], 1)
    b.add_mesh(np.concatenate([v0, v1, v2]), None, idx, m)
    b.add_sphere((0, 0, -14), 2.0, m)
    scene = b.build(build_bvh=False)

    org, dirs, times = _random_rays(rng_np, 256, spread=8.0)
    p_ref, t_ref = find_hit_bruteforce(scene, org, dirs, times)
    p_k, t_k = find_hit(scene, org, dirs, times, method="pallas")
    np.testing.assert_array_equal(np.asarray(p_ref), np.asarray(p_k))
    hit = np.asarray(p_ref) >= 0
    assert hit.sum() > 10
    np.testing.assert_allclose(
        np.asarray(t_ref)[hit], np.asarray(t_k)[hit], rtol=1e-5, atol=1e-4
    )


@pytest.mark.parametrize("n", [1, 65, 127])
def test_partial_ray_block(standin, rng_np, n):
    """Ray counts that do not fill the last block: pad lanes are dead and
    the live ones match brute force."""
    scene, _ = standin
    org, dirs, times = _rays_at_mesh(rng_np, n)
    p1, t1 = find_hit(scene, org, dirs, times, method="pallas")
    p0, t0 = find_hit_bruteforce(scene, org, dirs, times)
    assert p1.shape == (n,) and t1.shape == (n,)
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p0))
    hit = np.asarray(p0) >= 0
    np.testing.assert_allclose(np.asarray(t1)[hit], np.asarray(t0)[hit],
                               rtol=1e-5, atol=1e-4)


# ---------------------------------------------------------------------------
# per-block interval cull (the large-scene cluster cull)
# ---------------------------------------------------------------------------

def test_block_cull_superset_of_exact(standin, rng_np):
    """cluster_lists_block must be conservative: its active set per block
    is a superset of the exact per-ray cull's — otherwise hits are lost."""
    scene, _ = standin
    cmin = scene.cluster_min
    cmax = scene.cluster_max
    for trial in range(3):
        org, dirs, times = _rays_at_mesh(rng_np, 1024)
        t_min = jnp.full((1024,), 1e-3)
        if trial == 2:  # axis-aligned rays: zero direction components
            d = np.zeros((1024, 3), np.float32)
            d[np.arange(1024), rng_np.integers(0, 3, 1024)] = rng_np.choice(
                [-1.0, 1.0], 1024
            )
            dirs = jnp.asarray(d)
        exact = pallas_find.cluster_lists(org, dirs, t_min, cmin, cmax)
        block = pallas_find.cluster_lists_block(org, dirs, t_min, cmin, cmax)
        exact, block = np.asarray(exact), np.asarray(block)
        for b in range(exact.shape[0]):
            e = set(exact[b, 1 : 1 + exact[b, 0]].tolist())
            s = set(block[b, 1 : 1 + block[b, 0]].tolist())
            assert e <= s, (trial, b, sorted(e - s))


def test_block_cull_dead_lanes(standin, rng_np):
    scene, _ = standin
    org, dirs, times = _random_rays(rng_np, 512)
    t_min = jnp.full((512,), 3.0e38)  # all dead
    lists = pallas_find.cluster_lists_block(
        org, dirs, t_min, scene.cluster_min, scene.cluster_max
    )
    assert (np.asarray(lists)[:, 0] == 0).all()


# ---------------------------------------------------------------------------
# the gather's gradient: a scatter-add, whatever implements it
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", [
    # (rows R, table N, channels C, index rule)
    (5000, 10000, 8, "dup"),
    (1000, 786432, 8, "dup"),          # the flagship atlas's rows
    (4096, 4096, 3, "dup"),
    (100, 2048, 1, "dup"),
    (8192, 3042, 16, "dup"),           # the triangle pack
    (131072, 5, 30, "random"),         # a material table
    (2048, 4096, 4, "unique"),
    (512, 4096, 3, "upper"),
    (4096, 4, 10, "same"),             # the sphere pack, one row
], ids=lambda c: "x".join(map(str, c)))
def test_gather_gradient_matches_add_at(rng_np, case):
    R, N, C, rule = case
    if rule == "unique":
        idx = np.arange(R, dtype=np.int32) * 2
    elif rule == "upper":
        idx = (N // 2 + np.arange(0, N // 2, (N // 2) // R)).astype(np.int32)
    elif rule == "same":
        idx = np.full((R,), N - 1, np.int32)
    else:
        idx = rng_np.integers(0, N, size=R).astype(np.int32)
        if rule == "dup":
            # heavy duplication: real renders concentrate on few rows
            idx[: R // 3] = idx[0]
    g = rng_np.normal(size=(idx.size, C)).astype(np.float32)
    table = jnp.zeros((N, C), jnp.float32)

    def f(t):
        return jnp.sum(table_lookup(t, jnp.asarray(idx)) * g)

    out = np.asarray(jax.grad(f)(table), np.float64)
    exp = np.zeros((N, C), np.float64)
    np.add.at(exp, idx, g.astype(np.float64))
    np.testing.assert_allclose(out, exp, rtol=1e-5,
                               atol=1e-5 * np.abs(exp).max())
