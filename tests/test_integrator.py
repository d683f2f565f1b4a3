"""The integrator with the clustered kernel (interpret mode on the CPU)
must equal the integrator with the jnp search in radiance AND gradients."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from sexy_raytracer_jax.diff.params import extract_params, merge_params
from sexy_raytracer_jax.models import SceneBuilder
from sexy_raytracer_jax.render.camera import Camera
from sexy_raytracer_jax.render.integrator import bounce_wavefronts, trace_rays
from sexy_raytracer_jax.utils import rng as rnglib
from sexy_raytracer_jax.utils.config import CameraConfig


@pytest.fixture(scope="module")
def wavefront():
    b = SceneBuilder()
    checker = b.add_checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.add_sphere((0, -1000, 0), 1000.0, b.add_pbr_material(albedo_tex=checker))
    b.add_sphere((-2, 1, 0), 1.0, b.add_light_material(color=(10, 9, 7)))
    b.add_sphere((2, 1, 0), 1.0, b.add_metal_material((0.7, 0.6, 0.5), 0.0))
    b.add_sphere((0, 1, 2), 1.0, b.add_dielectric_material(1.5))
    tex = b.add_image_texture(
        (np.arange(16 * 16 * 3).reshape(16, 16, 3) * 7 % 256).astype(np.uint8)
    )
    mat = b.add_pbr_material(albedo_tex=tex)
    b.add_mesh([[-1, 0, -2], [1, 0, -2], [0, 2, -2]],
               [[0, 0], [1, 0], [0.5, 1]], [[0, 1, 2]], mat)
    scene = b.build(build_bvh=False)

    cam = Camera.from_config(
        CameraConfig(eye=(0, 2, 6), look_at=(0, 1, 0), vfov_degrees=45.0,
                     aperture=0.1, focus_dist=6.0),
        32 / 24,
    )
    R = 2048
    pid = jnp.arange(R, dtype=jnp.int32) % (32 * 24)
    keys = rnglib.ray_keys_2d(jax.random.key(1), pid,
                              jnp.zeros((R,), jnp.int32))
    ucam = rnglib.per_ray_uniform_block(keys, 5)
    u = ((pid % 32).astype(jnp.float32) + ucam[..., 0]) / 31
    v = ((24 - pid // 32).astype(jnp.float32) + ucam[..., 1]) / 23
    org, dirs, times = cam.get_rays(u, v, ucam[..., 2:5])
    bg = jnp.asarray((0.5, 0.7, 0.9), jnp.float32)
    return scene, org, dirs, times, keys, bg


@pytest.mark.parametrize("bounces", [1, 3])
def test_kernel_radiance_matches_jnp_search(wavefront, bounces):
    scene, org, dirs, times, keys, bg = wavefront
    r1 = trace_rays(scene, org, dirs, times, keys, bg, bounces,
                    method="bruteforce")
    r2 = trace_rays(scene, org, dirs, times, keys, bg, bounces,
                    method="pallas")
    np.testing.assert_allclose(np.asarray(r1), np.asarray(r2),
                               atol=2e-5, rtol=1e-5)
    assert float(jnp.max(r1)) > 1.0   # the light is in view


def test_kernel_gradients_match_jnp_search(wavefront):
    scene, org, dirs, times, keys, bg = wavefront
    params = extract_params(scene)
    tgt = jnp.full((org.shape[0], 3), 0.3)

    def loss(p, method):
        s = merge_params(scene, p)
        rad = trace_rays(s, org, dirs, times, keys, bg, 3, method=method)
        res = jnp.clip(jnp.sqrt(jnp.clip(rad, 1e-8, None)), 0.0, 0.999)
        return jnp.mean((res - tgt) ** 2)

    g1 = jax.grad(loss)(params, "bruteforce")
    g2 = jax.grad(loss)(params, "pallas")
    for k in g1:
        a, b = np.asarray(g1[k]), np.asarray(g2[k])
        assert np.isfinite(b).all(), k
        scale = max(np.abs(a).max(), 1e-10)
        assert np.abs(a - b).max() / scale < 5e-4, (
            f"{k}: rel diff {np.abs(a - b).max() / scale}"
        )


def test_zero_bounces_is_black(wavefront):
    """max_bounce=0 traces nothing (depth-out returns black)."""
    scene, org, dirs, times, keys, bg = wavefront
    r = trace_rays(scene, org, dirs, times, keys, bg, 0, method="pallas")
    assert r.shape == org.shape
    assert float(jnp.abs(r).max()) == 0.0


def test_bounce_wavefronts_are_the_searched_rays(wavefront):
    """bounce_wavefronts returns each bounce's (org, dir, t_min): primary
    rays first, and the live lanes shrink bounce by bounce."""
    scene, org, dirs, times, keys, bg = wavefront
    fronts = bounce_wavefronts(scene, org, dirs, times, keys, bg, 3,
                               method="bruteforce")
    assert len(fronts) == 3
    np.testing.assert_array_equal(np.asarray(fronts[0][0]), np.asarray(org))
    np.testing.assert_array_equal(np.asarray(fronts[0][1]), np.asarray(dirs))
    live = [int(jnp.sum(t < 1e38)) for _, _, t in fronts]
    assert live[0] == org.shape[0]
    assert live[0] >= live[1] >= live[2] > 0
