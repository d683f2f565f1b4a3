"""Which implementation runs where, where compiled programs are cached, and
the seeded flagship stand-in's shapes."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sexy_raytracer_jax.models import SceneBuilder, presets
from sexy_raytracer_jax.ops.intersect import find_hit

_TRITON = "xla.gpu.triton"


@pytest.fixture(scope="module")
def small():
    b = SceneBuilder()
    m = b.add_pbr_material()
    b.add_mesh([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], None, [[0, 1, 2]], m)
    b.add_sphere((0, 0, -3), 1.0, b.add_light_material(color=(4, 4, 4)))
    scene = b.build(build_bvh=False)
    n = 256
    org = jnp.tile(jnp.asarray([[0.0, 0.0, 3.0]]), (n, 1))
    d = jnp.stack([jnp.linspace(-0.3, 0.3, n), jnp.zeros(n), -jnp.ones(n)], 1)
    d = d / jnp.linalg.norm(d, axis=1, keepdims=True)
    return scene, org, d, jnp.zeros((n,)), jnp.full((n,), 1e-3)


def _lowered(fn, args, platform):
    return jax.jit(fn).trace(*args).lower(
        lowering_platforms=(platform,)).as_text()


def test_gpu_runs_the_triton_kernel(small):
    scene, org, d, tm, t_min = small
    text = _lowered(
        lambda o, d, tm: find_hit(scene, o, d, tm, t_min, method="auto"),
        (org, d, tm), "cuda")
    assert text.count(_TRITON) == 1
    assert "closest_hit_search" in text


def test_cpu_runs_jnp_and_interprets_pallas(small):
    scene, org, d, tm, t_min = small
    auto = _lowered(lambda o, d, tm: find_hit(scene, o, d, tm, t_min),
                    (org, d, tm), "cpu")
    pallas = _lowered(
        lambda o, d, tm: find_hit(scene, o, d, tm, t_min, method="pallas"),
        (org, d, tm), "cpu")
    assert _TRITON not in auto and _TRITON not in pallas
    p_auto, _ = find_hit(scene, org, d, tm, t_min)
    p_pal, _ = find_hit(scene, org, d, tm, t_min, method="pallas")
    np.testing.assert_array_equal(np.asarray(p_auto), np.asarray(p_pal))
    assert (np.asarray(p_auto) == 0).any()


def test_other_platforms_raise(small):
    scene, org, d, tm, t_min = small
    with pytest.raises(Exception, match="platform"):
        _lowered(lambda o, d, tm: find_hit(scene, o, d, tm, t_min),
                 (org, d, tm), "rocm")


def test_gpu_never_interprets(small):
    """method="pallas" interprets only on the CPU: on CUDA it is the
    compiled kernel, as under "auto"."""
    scene, org, d, tm, t_min = small
    text = _lowered(
        lambda o, d, tm: find_hit(scene, o, d, tm, t_min, method="pallas"),
        (org, d, tm), "cuda")
    assert text.count(_TRITON) == 1


def test_unknown_method_raises(small):
    scene, org, d, tm, t_min = small
    with pytest.raises(ValueError, match="unknown find method"):
        find_hit(scene, org, d, tm, t_min, method="pallas_mxu")


def test_compile_cache_follows_env_or_checkout(tmp_path):
    import os

    import sexy_raytracer_jax as srt

    assert srt.compilation_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}) == str(tmp_path)
    root = os.path.dirname(os.path.dirname(os.path.abspath(srt.__file__)))
    assert srt.compilation_cache_dir({}) == os.path.join(root, ".jax_cache")
    assert srt.compilation_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": ""}) == os.path.join(root, ".jax_cache")


def test_compile_cache_is_configured():
    import sexy_raytracer_jax as srt

    assert jax.config.jax_compilation_cache_dir == srt.compilation_cache_dir()


def test_standin_has_the_flagship_shapes():
    scene, cfg = presets.flagship_standin(height=720)
    assert (cfg.width, cfg.height, cfg.max_bounce) == (1280, 720, 4)
    assert scene.num_triangles == 3042
    assert scene.num_spheres == 4
    assert scene.shade_atlas.shape == (2, 512, 512, 8)
    tri_mat = np.asarray(scene.tri_mat)
    counts = sorted(np.bincount(tri_mat)[np.unique(tri_mat)].tolist())
    assert counts == [66, 2976]
    uv = np.asarray(scene.tri_uv0)
    assert uv.min() >= 0.0 and uv.max() <= 1.0 and uv.std() > 0.1
    # closed, outward-facing surfaces: no degenerate triangles
    n = np.cross(np.asarray(scene.tri_v1 - scene.tri_v0),
                 np.asarray(scene.tri_v2 - scene.tri_v0))
    assert np.linalg.norm(n, axis=1).min() > 0.0


def test_standin_is_seeded():
    a, _ = presets.flagship_standin(seed=0, height=90)
    b, _ = presets.flagship_standin(seed=0, height=90)
    c, _ = presets.flagship_standin(seed=1, height=90)
    for f in ("tri_v0", "tri_uv1", "shade_atlas", "sph_c0"):
        np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                      np.asarray(getattr(b, f)))
    assert not np.array_equal(np.asarray(a.shade_atlas),
                              np.asarray(c.shade_atlas))
    assert not np.array_equal(np.asarray(a.tri_v0), np.asarray(c.tri_v0))
