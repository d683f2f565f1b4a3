"""End-to-end inverse-rendering convergence (BASELINE config 5, CI-sized).

The flagship-scale experiment (tools/run_inverse_experiment.py, artifacts
in artifacts/inverse/) perturbs the Master Chief scene's shade_atlas and
sphere centers and recovers them against a self-rendered target. This is
the same experiment shrunk to CPU-CI size: a small textured scene, a
self-rendered target, perturbed texture pack + sphere position, and hard
assertions that the optimization converges.

Metric note: the per-step training loss is a stochastic estimator whose
floor is set by Monte-Carlo sample noise (~4.5e-3 at spb=32 on this
scene), so the convergence assertion uses the *exact* objective — the
deterministically re-rendered image vs the target (same seed => same
sample sequence => zero-noise estimator of the same MSE) — which must
drop >=10x. Design findings baked in here and in diff/inverse.py:
per-group lr scaling (0-255 texel packs vs unit-scale geometry), cosine
decay + parameter EMA against Adam's random walk under MC noise, and
grad masks to freeze non-identifiable parameters (a perfect-mirror
sphere's position has almost no smooth gradient — silhouette motion is
stop-graded topology by design, SURVEY §7).
"""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest

from sexy_raytracer_jax.diff.inverse import inverse_render
from sexy_raytracer_jax.models import SceneBuilder
from sexy_raytracer_jax.render.renderer import render_accumulate
from sexy_raytracer_jax.utils.config import CameraConfig, RenderConfig


def _scene():
    """Small analogue of the flagship: textured PBR sphere + metal sphere +
    light + checker ground (all the trainable parameter classes)."""
    b = SceneBuilder()
    checker = b.add_checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.add_sphere((0, -1000, 0), 1000.0, b.add_pbr_material(albedo_tex=checker))
    b.add_sphere((-2.5, 2.5, 2.0), 1.0,
                 b.add_light_material(color=(15.0, 14.0, 12.0)))
    b.add_sphere((1.6, 1, 0), 1.0, b.add_metal_material((0.7, 0.6, 0.5), 0.0))
    # textured PBR sphere: a smooth gradient image (recoverable texels)
    yy, xx = np.mgrid[0:16, 0:16]
    img = np.stack(
        [120 + 6 * xx, 90 + 5 * yy, 200 - 5 * xx], axis=-1
    ).astype(np.float32)
    b.add_sphere(
        (-1.2, 1, 0.5), 1.0,
        b.add_pbr_material(albedo_tex=b.add_image_texture(img),
                           roughness=0.4),
    )
    return b.build(build_bvh=False)


def test_inverse_rendering_converges():
    scene = _scene()
    cfg = RenderConfig(
        width=48, height=32, samples_per_pixel=128, max_bounce=3,
        camera=CameraConfig(eye=(0, 2, 6), look_at=(0, 1, 0),
                            vfov_degrees=45.0, aperture=0.0, focus_dist=6.0),
    )
    # self-rendered target from the TRUE parameters
    target = np.asarray(render_accumulate(scene, cfg, method="bruteforce"))
    target = np.clip(np.sqrt(np.clip(
        target / cfg.samples_per_pixel, 1e-8, None)), 0, 0.999)

    # perturb: texture pack strongly recolored, textured sphere displaced
    true_atlas = np.asarray(scene.shade_atlas)
    true_c0 = np.asarray(scene.sph_c0)
    pert_atlas = np.clip(true_atlas * 0.5 + 60.0, 0.0, 255.0)
    shift = np.zeros_like(true_c0)
    shift[3] = (-0.3, 0.2, 0.25)    # textured PBR sphere
    perturbed = scene._replace(
        shade_atlas=jnp.asarray(pert_atlas),
        sph_c0=jnp.asarray(true_c0 + shift),
        sph_c1=jnp.asarray(true_c0 + shift),
    )

    # ground/light/metal spheres are frozen: ground+light are not part of
    # the recovery task, and the mirror sphere is non-identifiable (see
    # module docstring)
    mask = np.zeros((4, 1), np.float32)
    mask[3] = 1.0
    opt, losses = inverse_render(
        perturbed, target,
        dataclasses.replace(cfg, samples_per_pixel=32),
        n_steps=300, pixels_per_step=768, spb=32,
        learning_rate=8e-3, method="bruteforce", seed=5, progress=False,
        trainable=("shade_atlas", "sph_c0", "sph_c1"),
        grad_masks={"sph_c0": mask, "sph_c1": mask},
    )

    # stochastic training loss decreases (it converges INTO its MC floor)
    init_loss = np.mean(losses[:5])
    final_loss = np.mean(losses[-30:])
    assert final_loss < init_loss, (init_loss, final_loss)

    # the displaced sphere comes back; frozen spheres never move
    errs = np.linalg.norm(np.asarray(opt.sph_c0) - true_c0, axis=1)
    assert errs[3] < 0.15, errs
    assert errs[0] == 0 and errs[1] == 0 and errs[2] == 0, errs

    # exact objective: deterministic re-render MSE drops >=10x (measured
    # ~98x; asserted with margin)
    def mse_vs_target(s):
        img = np.asarray(render_accumulate(s, cfg, method="bruteforce"))
        img = np.clip(np.sqrt(np.clip(
            img / cfg.samples_per_pixel, 1e-8, None)), 0, 0.999)
        return float(((img - target) ** 2).mean())

    mse_pert = mse_vs_target(perturbed)
    mse_opt = mse_vs_target(opt)
    assert mse_opt < 0.1 * mse_pert, (mse_pert, mse_opt)
    assert mse_opt < 5e-4, mse_opt
