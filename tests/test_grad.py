"""Gradient correctness: finite-difference checks (BASELINE requirement)."""

import functools

import numpy as np
import jax
import jax.numpy as jnp

from sexy_raytracer_jax.diff.inverse import _loss_fn
from sexy_raytracer_jax.diff.params import extract_params
from sexy_raytracer_jax.models import SceneBuilder
from sexy_raytracer_jax.render.camera import Camera
from sexy_raytracer_jax.utils.config import CameraConfig, RenderConfig


def _scene():
    b = SceneBuilder()
    checker = b.add_checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.add_sphere((0, -1000, 0), 1000.0, b.add_pbr_material(albedo_tex=checker))
    b.add_sphere((-2, 1, 0), 1.0, b.add_light_material(color=(8.0, 7.0, 6.0)))
    b.add_sphere((1.5, 1, 0), 1.0, b.add_metal_material((0.7, 0.6, 0.5), 0.1))
    img = np.full((8, 8, 3), 180, np.uint8)
    b.add_sphere(
        (0, 1, 1.5),
        1.0,
        b.add_pbr_material(
            albedo_tex=b.add_image_texture(img),
            base_color=(0.9, 0.8, 0.7, 1.0),
            metallic=0.3,
            roughness=0.5,
        ),
    )
    mat = b.add_pbr_material(base_color=(0.8, 0.4, 0.3, 1.0), roughness=0.6)
    b.add_mesh([[-2, 0, -2], [2, 0, -2], [0, 3, -2]],
               [[0, 0], [1, 0], [0.5, 1]], [[0, 1, 2]], mat)
    return b.build(build_bvh=False)


def _setup():
    scene = _scene()
    cfg = RenderConfig(
        width=24, height=16, samples_per_pixel=4, max_bounce=3,
        camera=CameraConfig(eye=(0, 2, 6), look_at=(0, 1, 0),
                            vfov_degrees=45.0, aperture=0.0, focus_dist=6.0),
    )
    cam = Camera.from_config(cfg.camera, cfg.aspect)
    # center rows: rays that actually hit geometry
    pix = jnp.arange(24 * 6, 24 * 10, dtype=jnp.int32)
    tgt = jnp.full((pix.shape[0], 3), 0.5)
    kwargs = dict(width=cfg.width, height=cfg.height, spb=4,
                  spp_total=cfg.samples_per_pixel, max_bounce=cfg.max_bounce,
                  method="bruteforce")
    f = functools.partial(_loss_fn, **kwargs)
    args = (scene, cam, pix, tgt, jnp.int32(0), jax.random.key(3),
            jnp.asarray(cfg.background))
    return scene, f, args


def test_grads_finite_and_nonzero():
    scene, f, args = _setup()
    params = extract_params(
        scene,
        ("shade_atlas", "mat_base_color", "mat_metallic", "mat_roughness",
         "sph_c0", "sph_c1", "tri_v0"),
    )
    loss, grads = jax.value_and_grad(f)(params, *args)
    assert np.isfinite(float(loss))
    for name, g in grads.items():
        g = np.asarray(g)
        assert np.isfinite(g).all(), f"{name} grad has NaN/inf"
    # the materials/atlas/geometry all affect the image here
    for name in ("shade_atlas", "mat_base_color", "sph_c0", "tri_v0"):
        assert np.abs(np.asarray(grads[name])).max() > 0, f"{name} grad all-zero"


def test_finite_difference_match():
    """Directional finite differences vs autodiff for several param groups.

    The render is deterministic given the fixed key, so FD is exact up to
    f32 truncation; tolerances are loose accordingly.
    """
    scene, f, args = _setup()
    rng = np.random.default_rng(0)
    for name in ("mat_base_color", "mat_roughness", "shade_atlas"):
        params = extract_params(scene, (name,))
        grads = jax.grad(f)(params, *args)[name]
        direction = rng.normal(size=params[name].shape).astype(np.float32)
        # central difference; atlas values are 0-255 scale and its loss
        # contribution is small, so it needs a large step to rise above
        # f32 loss quantization
        eps = 1e-3 if name != "shade_atlas" else 4.0
        p_plus = {name: params[name] + eps * direction}
        p_minus = {name: params[name] - eps * direction}
        fd = (float(f(p_plus, *args)) - float(f(p_minus, *args))) / (2 * eps)
        ad = float(jnp.sum(grads * direction))
        denom = max(abs(fd), abs(ad), 1e-6)
        tol = 0.08 if name != "shade_atlas" else 0.15
        assert abs(fd - ad) / denom < tol, (name, fd, ad)


def test_finite_difference_camera_params():
    """Camera parameters are differentiable end-to-end through
    Camera.from_params (pure jnp, VERDICT r2 weak #6): FD vs autodiff on
    the eye position and field of view.

    Uses a smooth scene (solid-PBR sphere, pixels interior to its
    projection): checker/image textures are discontinuous in the hit point
    — their true gradient is zero a.e. while FD picks up cell-boundary
    jumps, so they cannot FD-validate camera motion."""
    b = SceneBuilder()
    b.add_sphere((0, 0, 0), 1.0,
                 b.add_pbr_material(base_color=(0.7, 0.6, 0.5, 1.0),
                                    metallic=0.2, roughness=0.5))
    scene = b.build(build_bvh=False)
    pix = jnp.asarray([16 * 7 + 7, 16 * 7 + 8, 16 * 8 + 7, 16 * 8 + 8],
                      jnp.int32)
    tgt = jnp.full((4, 3), 0.5)
    kwargs = dict(width=16, height=16, spb=4, spp_total=4,
                  max_bounce=2, method="bruteforce")
    f = functools.partial(_loss_fn, **kwargs)
    params = extract_params(scene, ("mat_base_color",))
    bg = jnp.asarray((0.6, 0.7, 0.8))
    s0, key = jnp.int32(0), jax.random.key(1)

    def loss_of(eye, vfov):
        c = Camera.from_params(
            eye, jnp.zeros(3), jnp.asarray([0.0, 1.0, 0.0]),
            vfov, 1.0, 0.0, 4.0,
        )
        return f(params, scene, c, pix, tgt, s0, key, bg)

    eye0 = jnp.asarray([0.0, 0.0, 4.0])
    vfov0 = jnp.float32(40.0)
    g_eye, g_vfov = jax.grad(loss_of, argnums=(0, 1))(eye0, vfov0)
    assert np.isfinite(np.asarray(g_eye)).all() and np.isfinite(float(g_vfov))
    assert np.abs(np.asarray(g_eye)).max() > 0

    d = np.asarray([0.3, 0.2, 0.9], np.float32)  # mostly depth: no flips
    eps = 1e-3
    fd = (float(loss_of(eye0 + eps * d, vfov0))
          - float(loss_of(eye0 - eps * d, vfov0))) / (2 * eps)
    ad = float(jnp.sum(g_eye * d))
    denom = max(abs(fd), abs(ad), 1e-6)
    assert abs(fd - ad) / denom < 0.1, (fd, ad)

    fdv = (float(loss_of(eye0, vfov0 + 1e-2))
           - float(loss_of(eye0, vfov0 - 1e-2))) / 2e-2
    adv = float(g_vfov)
    denom = max(abs(fdv), abs(adv), 1e-6)
    assert abs(fdv - adv) / denom < 0.1, (fdv, adv)


def test_pallas_cull_tracks_trained_geometry():
    """VERDICT r2 weak #3: trained triangle vertices must not vanish from
    the clustered cull kernel. merge_params re-derives the cluster AABBs on
    device; a stale ``_replace`` (the old behavior) demonstrably loses the
    hits, which is the wrong-forward/wrong-gradient failure this guards."""
    from sexy_raytracer_jax.diff.params import merge_params
    from sexy_raytracer_jax.models.scene import prepare_triangles
    from sexy_raytracer_jax.ops.intersect import find_hit, find_hit_bruteforce

    b = SceneBuilder()
    mat = b.add_pbr_material(base_color=(0.8, 0.4, 0.3, 1.0), roughness=0.6)
    b.add_mesh([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
               None, [[0, 1, 2], [0, 2, 3]], mat)
    scene = b.build(build_bvh=True)

    shift = jnp.asarray([6.0, 0.0, 0.0], jnp.float32)  # far outside old AABBs
    params = {"tri_v0": scene.tri_v0 + shift,
              "tri_v1": scene.tri_v1 + shift,
              "tri_v2": scene.tri_v2 + shift}
    moved = merge_params(scene, params)

    # rays aimed straight at the moved quad
    n = 64
    org = jnp.tile(jnp.asarray([[6.0, 0.0, 5.0]], jnp.float32), (n, 1))
    jit = (jnp.arange(n, dtype=jnp.float32)[:, None] / n - 0.5) * 0.2
    dirs = jnp.concatenate(
        [jit, jnp.zeros((n, 1)), -jnp.ones((n, 1))], axis=1
    )
    times = jnp.zeros((n,), jnp.float32)

    p_bf, t_bf = find_hit_bruteforce(moved, org, dirs, times)
    assert (np.asarray(p_bf) >= 0).all(), "setup: rays must hit the quad"

    p_k, t_k = find_hit(moved, org, dirs, times, method="pallas")
    np.testing.assert_array_equal(np.asarray(p_k), np.asarray(p_bf))
    agree = np.asarray(p_k) >= 0
    np.testing.assert_allclose(
        np.asarray(t_k)[agree], np.asarray(t_bf)[agree], rtol=1e-5
    )

    # red half of red-then-green: the stale bounds really do drop the hits
    tri_n, tri_d, tri_q, tri_c = prepare_triangles(
        moved.tri_v0, moved.tri_v1, moved.tri_v2
    )
    stale = scene._replace(**params, tri_n=tri_n, tri_d=tri_d,
                           tri_q=tri_q, tri_c=tri_c)
    p_stale, _ = find_hit(stale, org, dirs, times, method="pallas")
    assert (np.asarray(p_stale) == -1).all(), (
        "stale cluster AABBs should cull the moved geometry — if this now "
        "hits, the guard test itself is no longer exercising the cull path"
    )

    # BVH path is refit too (same trap for method='bvh')
    p_bvh, _ = find_hit(moved, org, dirs, times, method="bvh")
    np.testing.assert_array_equal(np.asarray(p_bvh), np.asarray(p_bf))


def test_refit_bvh_matches_host_build():
    """Device refit on an untouched scene reproduces host-built bounds, and
    moving sphere centers through merge_params keeps method='bvh' exact."""
    from sexy_raytracer_jax.diff.params import merge_params
    from sexy_raytracer_jax.models.bvh import refit_bvh_device
    from sexy_raytracer_jax.ops.intersect import find_hit, find_hit_bruteforce

    b = SceneBuilder()
    m = b.add_pbr_material(base_color=(0.5, 0.5, 0.5, 1.0))
    b.add_sphere((0, 0, -2), 1.0, m)
    b.add_sphere((0, -101, 0), 100.0, m)
    b.add_sphere((3, 0, -2), 1.0, m, center1=(3, 1, -2))
    b.add_mesh([[-2, 0, -2], [2, 0, -2], [0, 3, -2]],
               None, [[0, 1, 2]], m)
    scene = b.build(build_bvh=True)

    bmin, bmax = refit_bvh_device(scene)
    np.testing.assert_allclose(np.asarray(bmin), np.asarray(scene.bvh_min),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(bmax), np.asarray(scene.bvh_max),
                               atol=1e-6)

    moved = merge_params(scene, {
        "sph_c0": scene.sph_c0 + jnp.asarray([4.0, 0.0, 0.0]),
        "sph_c1": scene.sph_c1 + jnp.asarray([4.0, 0.0, 0.0]),
    })
    rng = np.random.default_rng(7)
    org = jnp.asarray(rng.normal(0, 3, (256, 3)), jnp.float32)
    d = rng.normal(size=(256, 3))
    dirs = jnp.asarray(d / np.linalg.norm(d, axis=1, keepdims=True),
                       jnp.float32)
    times = jnp.asarray(rng.uniform(0, 1, 256), jnp.float32)
    p_bvh, _ = find_hit(moved, org, dirs, times, method="bvh")
    p_bf, _ = find_hit_bruteforce(moved, org, dirs, times)
    np.testing.assert_array_equal(np.asarray(p_bvh), np.asarray(p_bf))


def test_finite_difference_sphere_position_interior():
    """Sphere-position gradients flow through the quadratic root (smooth
    part). Visibility/silhouette changes are stop-gradiented by design
    (SURVEY §7), so the FD check uses pixels strictly interior to the
    sphere's projection where no visibility flips occur."""
    b = SceneBuilder()
    b.add_sphere((0, 0, 0), 1.0,
                 b.add_pbr_material(base_color=(0.7, 0.6, 0.5, 1.0),
                                    metallic=0.2, roughness=0.5))
    scene = b.build(build_bvh=False)
    cfg = RenderConfig(
        width=16, height=16, samples_per_pixel=4, max_bounce=2,
        background=(0.6, 0.7, 0.8),
        camera=CameraConfig(eye=(0, 0, 4), look_at=(0, 0, 0),
                            vfov_degrees=40.0, aperture=0.0, focus_dist=4.0),
    )
    cam = Camera.from_config(cfg.camera, cfg.aspect)
    # the sphere projects to ~radius 5px at this fov; take the center 2x2
    pix = jnp.asarray([16 * 7 + 7, 16 * 7 + 8, 16 * 8 + 7, 16 * 8 + 8],
                      jnp.int32)
    tgt = jnp.full((4, 3), 0.5)
    kwargs = dict(width=16, height=16, spb=4, spp_total=4,
                  max_bounce=2, method="bruteforce")
    f = functools.partial(_loss_fn, **kwargs)
    args = (scene, cam, pix, tgt, jnp.int32(0), jax.random.key(1),
            jnp.asarray(cfg.background))
    name = "sph_c0"
    params = extract_params(scene, (name, "sph_c1"))
    grads = jax.grad(f)(params, *args)
    direction = np.asarray([[0.05, 0.02, 0.1]], np.float32)  # mostly depth
    eps = 1e-3
    dd = {name: params[name] + eps * direction, "sph_c1": params["sph_c1"] + eps * direction}
    dm = {name: params[name] - eps * direction, "sph_c1": params["sph_c1"] - eps * direction}
    fd = (float(f(dd, *args)) - float(f(dm, *args))) / (2 * eps)
    ad = float(jnp.sum(grads[name] * direction) + jnp.sum(grads["sph_c1"] * direction))
    denom = max(abs(fd), abs(ad), 1e-6)
    assert abs(fd - ad) / denom < 0.1, (fd, ad)
