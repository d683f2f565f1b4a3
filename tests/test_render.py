"""End-to-end render tests: determinism, chunk invariance, oracle statistics."""

import dataclasses

import numpy as np

from sexy_raytracer_jax.models import SceneBuilder
from sexy_raytracer_jax.oracle import Oracle
from sexy_raytracer_jax.render.renderer import render_accumulate
from sexy_raytracer_jax.utils.config import CameraConfig, RenderConfig
from sexy_raytracer_jax.utils import color as colorlib


def small_scene():
    b = SceneBuilder()
    checker = b.add_checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.add_sphere((0, -1000, 0), 1000.0, b.add_pbr_material(albedo_tex=checker))
    b.add_sphere((-2, 1, 0), 1.0, b.add_light_material(color=(10.0, 9.0, 7.0)))
    b.add_sphere((2, 1, 0), 1.0, b.add_metal_material((0.7, 0.6, 0.5), 0.0))
    b.add_sphere((0, 1, 0), 1.0, b.add_dielectric_material(1.5))
    mat = b.add_pbr_material(base_color=(0.9, 0.3, 0.3, 1.0))
    b.add_mesh([[-1, 0, -2], [1, 0, -2], [0, 2, -2]], None, [[0, 1, 2]], mat)
    return b.build(build_bvh=False)


def small_config(**kw):
    base = dict(
        width=64,
        height=36,
        samples_per_pixel=8,
        max_bounce=4,
        rays_per_chunk=2048,
        samples_per_batch=4,
        camera=CameraConfig(
            eye=(0, 2, 6), look_at=(0, 1, 0), vfov_degrees=45.0, aperture=0.0,
            focus_dist=6.0,
        ),
    )
    base.update(kw)
    return RenderConfig(**base)


def test_deterministic():
    scene = small_scene()
    cfg = small_config()
    a = render_accumulate(scene, cfg)
    b = render_accumulate(scene, cfg)
    np.testing.assert_array_equal(a, b)


def test_chunking_invariance():
    """Counter-based RNG keyed by (pixel, sample) uid: the image must not
    depend on how rays are batched."""
    scene = small_scene()
    a = render_accumulate(scene, small_config(rays_per_chunk=2048))
    b = render_accumulate(
        scene, small_config(rays_per_chunk=512, samples_per_batch=2)
    )
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_seed_changes_image():
    scene = small_scene()
    a = render_accumulate(scene, small_config(seed=0))
    b = render_accumulate(scene, small_config(seed=1))
    assert np.abs(a - b).max() > 1e-3


def test_matches_oracle_statistics():
    """MC mean of the device renderer vs the scalar oracle at matched
    camera/pixels: distributions agree, sequences don't (SURVEY §4)."""
    scene = small_scene()
    cfg = small_config(width=8, height=6, samples_per_pixel=64,
                       samples_per_batch=16, rays_per_chunk=1024)
    img = render_accumulate(scene, cfg) / cfg.samples_per_pixel

    orc = Oracle(scene, rng=np.random.default_rng(7).random)
    W, H = cfg.width, cfg.height
    from sexy_raytracer_jax.render.camera import Camera

    cam_rng = np.random.default_rng(13)
    spp = 48
    # oracle camera: reuse the device camera's precomputed basis
    cam = Camera.from_config(cfg.camera, cfg.aspect)
    origin = np.asarray(cam.origin)
    lleft = np.asarray(cam.lower_left)
    horizontal = np.asarray(cam.horizontal)
    vertical = np.asarray(cam.vertical)

    diffs = []
    for y in range(H):
        for x in range(W):
            acc = np.zeros(3)
            for _ in range(spp):
                u = (x + cam_rng.random()) / (W - 1)
                v = ((H - y) + cam_rng.random()) / (H - 1)
                d = lleft + u * horizontal + v * vertical - origin
                acc += orc.ray_color(origin, d, cam_rng.random(),
                                     np.asarray(cfg.background), cfg.max_bounce)
            diffs.append(img[y, x] - acc / spp)
    diffs = np.asarray(diffs)
    # mean pixel difference should be small relative to scene radiance scale
    assert np.abs(diffs.mean(axis=0)).max() < 0.15, diffs.mean(axis=0)


def test_resolve_gamma():
    accum = np.full((2, 2, 3), 4.0)
    out = colorlib.resolve(accum, 16)  # 4/16 = 0.25 -> sqrt = 0.5
    np.testing.assert_allclose(out, 0.5, atol=1e-6)
    img = colorlib.to_uint8(out)
    assert img.dtype == np.uint8
    assert (img == 128).all()
