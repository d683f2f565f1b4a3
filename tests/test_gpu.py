"""The compiled kernels on the card (skip without an NVIDIA GPU).

Run on the card: ``JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/``.
The same checks, at full width, are phase 2 of ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from sexy_raytracer_jax.models import presets
from sexy_raytracer_jax.ops.intersect import find_hit, find_hit_bruteforce
from sexy_raytracer_jax.render.camera import Camera
from sexy_raytracer_jax.render.renderer import camera_rays, tile_pixel_order

pytestmark = pytest.mark.gpu


@pytest.fixture
def rays(gpu):
    scene, cfg = presets.flagship_standin(height=360)
    scene = jax.device_put(scene, gpu)
    camera = Camera.from_config(cfg.camera, cfg.aspect)
    ids = jnp.asarray(tile_pixel_order(cfg.width, cfg.height)[:65536])
    org, d, tm, _, _ = camera_rays(camera, ids, jnp.int32(0),
                                   jax.random.key(0), width=cfg.width,
                                   height=cfg.height, spb=1)
    return scene, org, d, tm, jnp.full((org.shape[0],), 1e-3, jnp.float32)


def test_compiled_find_matches_bruteforce(rays):
    scene, org, d, tm, t_min = rays
    p_k, t_k = jax.jit(lambda *a: find_hit(*a, method="auto"))(
        scene, org, d, tm, t_min)
    p_b, t_b = jax.jit(find_hit_bruteforce)(scene, org, d, tm, t_min)
    p_k, t_k, p_b, t_b = map(np.asarray, (p_k, t_k, p_b, t_b))
    dis = p_k != p_b
    assert dis.mean() < 1e-4
    np.testing.assert_allclose(t_k[dis], t_b[dis], rtol=1e-5)
    assert (p_b >= 0).sum() > 1000


def test_compiled_find_on_a_large_mesh(gpu):
    scene, cfg = presets.terrain_heightfield(tris=150_000, height=360)
    scene = jax.device_put(scene, gpu)
    camera = Camera.from_config(cfg.camera, cfg.aspect)
    order = tile_pixel_order(cfg.width, cfg.height)
    ids = jnp.asarray(order[order.size // 2 - 32768:order.size // 2 + 32768])
    org, d, tm, _, _ = camera_rays(camera, ids, jnp.int32(0),
                                   jax.random.key(0), width=cfg.width,
                                   height=cfg.height, spb=1)
    t_min = jnp.full((org.shape[0],), 1e-3, jnp.float32)
    p_k, _ = jax.jit(lambda *a: find_hit(*a, method="auto"))(
        scene, org, d, tm, t_min)
    p_b, _ = jax.jit(find_hit_bruteforce)(scene, org, d, tm, t_min)
    assert (np.asarray(p_k) != np.asarray(p_b)).mean() < 1e-4
    assert (np.asarray(p_b) >= 0).sum() > 1000
