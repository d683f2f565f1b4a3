"""Boundary (silhouette) gradients for sphere positions.

WHY. The framework treats hit topology as non-differentiable (stop-grad on
the closest-hit choice, SURVEY §7): gradients flow only through the
*interior* shading of whatever surface is hit. For textured surfaces that
is enough (tests/test_inverse.py recovers a textured sphere's position),
but the flagship's spheres are featureless — a solid-sentinel iron sphere
and a perfect mirror (reference main.cpp:126-144). Their interior shading
is translation-invariant, so position has no restoring gradient, and the
optimizer discovers the loss-reducing cheat of burying a displaced sphere
in the ground (measured, tools/run_inverse_experiment.py r3 scope note).

The missing piece is the boundary term of differentiable rendering: for a
region Ω(c) whose silhouette moves with the parameter c,

    d/dc ∫ (I - T)^2 = interior term + ∮_∂Ω [(L_in - T)^2 - (L_out - T)^2]
                                             (v(s) . n̂(s)) ds

where L_in/L_out are the radiances just inside/outside the edge and
v . n̂ is the image-space normal velocity of the edge point. This module
estimates that contour integral by *edge sampling* specialised to spheres
(their silhouette is an analytic cone: directions at angle asin(r/dist)
around the center direction — no edge-detection pass needed), the sphere
flavour of Li et al.'s edge sampling for general meshes.

The estimator is returned as a SURROGATE LOSS: value numerically 0, but
its jax.grad w.r.t. sph_c0/sph_radius equals the contour estimate —
radiances, residuals and arc weights are stop-graded; only the analytic
edge position ψ_k(c) carries gradient. It composes additively with the
interior train-step loss.

Approximations (documented, validated by tests/test_silhouette.py):
  * pinhole edge geometry (the thin-lens aperture blurs the true edge
    over ~lens_radius/focus_dist radians; the estimator sees the sharp
    edge, a blur-width-level bias);
  * the edge is sampled at the sphere's center-time position (moving
    spheres: time-averaged silhouettes are not modelled);
  * L_in/L_out come from eps_px-offset rays — grazing-angle shading
    right at the edge differs from the one-pixel-in value.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from sexy_raytracer_jax.render.integrator import trace_rays
from sexy_raytracer_jax.utils import rng as rnglib
from sexy_raytracer_jax.utils.mathx import unit_vector

_SG = jax.lax.stop_gradient


def _edge_geometry(camera, center, radius, phis):
    """Analytic silhouette directions + viewport coords for one sphere.

    Returns (s, t) viewport coords [K] (differentiable in center/radius)
    plus the stop-graded unit directions d_hat/a1/a2 and cone angle.
    """
    eye = camera.origin
    d = center - eye
    dist = jnp.sqrt(jnp.sum(d * d))
    d_hat = d / dist
    sin_t = jnp.clip(radius / dist, 1e-6, 1.0 - 1e-6)
    cos_t = jnp.sqrt(1.0 - sin_t * sin_t)

    # orthonormal frame around d_hat (any fixed helper axis not parallel)
    helper = jnp.where(
        jnp.abs(_SG(d_hat)[1]) < 0.9,
        jnp.asarray([0.0, 1.0, 0.0]),
        jnp.asarray([1.0, 0.0, 0.0]),
    )
    a1 = unit_vector(jnp.cross(d_hat, helper))
    a2 = jnp.cross(d_hat, a1)

    # silhouette directions: cone of half-angle theta around d_hat
    v = (
        cos_t * d_hat[None, :]
        + sin_t * (jnp.cos(phis)[:, None] * a1[None, :]
                   + jnp.sin(phis)[:, None] * a2[None, :])
    )  # [K, 3]

    # viewport coords of a direction from the eye (pinhole inversion of
    # camera.get_rays: dir(s,t) = (s-.5)h + (t-.5)v - fd*w)
    u_ax = camera.u_axis
    v_ax = camera.v_axis
    w_ax = jnp.cross(u_ax, v_ax)          # = unit(eye - look_at)
    h_len = jnp.sqrt(jnp.sum(camera.horizontal * camera.horizontal))
    v_len = jnp.sqrt(jnp.sum(camera.vertical * camera.vertical))
    # focus distance along -w: |projection of (lower_left-origin) on w|
    fd = -jnp.sum((camera.lower_left - camera.origin +
                   camera.horizontal / 2 + camera.vertical / 2) * w_ax)
    dot = functools.partial(jnp.dot, precision=jax.lax.Precision.HIGHEST)
    depth = -dot(v, w_ax)                  # [K], >0 for visible
    s = 0.5 + dot(v, u_ax) * fd / (depth * h_len)
    t = 0.5 + dot(v, v_ax) * fd / (depth * v_len)
    return s, t, _SG(v), _SG(d_hat), _SG(a1), _SG(a2), _SG(sin_t), _SG(cos_t)


def sphere_silhouette_loss(
    scene,
    camera,
    target_resolved,
    sphere_ids,
    key,
    *,
    width: int,
    height: int,
    max_bounce: int,
    background,
    n_edge: int = 256,
    eps_px: float = 0.75,
    method: str = "auto",
):
    """Surrogate loss: value ~0; grad w.r.t. sph_c0/sph_radius = the
    silhouette contour term of the full-image resolved-space MSE
    ``mean((I - target)^2)``.

    ``target_resolved``: [H, W, 3] float 0..1 (gamma-2 resolved).
    ``sphere_ids``: python list of sphere indices to differentiate.
    """
    target_resolved = jnp.asarray(target_resolved, jnp.float32)
    background = jnp.asarray(background, jnp.float32)
    total = jnp.float32(0.0)
    # angle subtended by one pixel at the image center (for the in/out
    # ray offset): viewport width / focus dist / W
    h_len = jnp.sqrt(jnp.sum(camera.horizontal * camera.horizontal))
    w_ax = jnp.cross(camera.u_axis, camera.v_axis)
    fd = -jnp.sum((camera.lower_left - camera.origin +
                   camera.horizontal / 2 + camera.vertical / 2) * w_ax)
    px_angle = h_len / fd / width

    for n, i in enumerate(sphere_ids):
        center = scene.sph_c0[i]
        radius = scene.sph_radius[i]
        kk = jax.random.fold_in(key, n)
        xi = jax.random.uniform(kk)
        phis = (2.0 * jnp.pi) * (
            (jnp.arange(n_edge, dtype=jnp.float32) + xi) / n_edge
        )
        s, t, v_sg, d_hat, a1, a2, sin_t, cos_t = _edge_geometry(
            camera, center, radius, phis
        )

        # edge pixel positions (float) and integer lookup pixels
        x_px = s * (width - 1)
        y_px = height - t * (height - 1)
        xi_i = jnp.clip(_SG(x_px).astype(jnp.int32), 0, width - 1)
        yi_i = jnp.clip(_SG(y_px).astype(jnp.int32), 0, height - 1)
        on_screen = (
            (_SG(x_px) >= 0) & (_SG(x_px) <= width - 1)
            & (_SG(y_px) >= 0) & (_SG(y_px) <= height - 1)
        )
        tgt = target_resolved[yi_i, xi_i]               # [K, 3]

        # in/out rays: rotate the silhouette direction by ~eps_px pixels
        # toward / away from the center direction
        delta = eps_px * px_angle
        sin_in = jnp.sin(jnp.arcsin(sin_t) - delta)
        sin_out = jnp.sin(jnp.arcsin(sin_t) + delta)
        cos_in = jnp.sqrt(1.0 - sin_in * sin_in)
        cos_out = jnp.sqrt(jnp.maximum(1.0 - sin_out * sin_out, 0.0))
        ring = (jnp.cos(phis)[:, None] * a1[None, :]
                + jnp.sin(phis)[:, None] * a2[None, :])
        v_in = cos_in * d_hat[None, :] + sin_in * ring
        v_out = cos_out * d_hat[None, :] + sin_out * ring

        org = jnp.broadcast_to(camera.origin, (2 * n_edge, 3))
        dirs = jnp.concatenate([v_in, v_out], axis=0)
        times = jnp.full((2 * n_edge,), 0.5, jnp.float32)
        keys = rnglib.ray_keys_2d(
            kk, jnp.arange(2 * n_edge, dtype=jnp.int32),
            jnp.zeros((2 * n_edge,), jnp.int32),
        )
        rad = trace_rays(
            _SG(scene), _SG(org), _SG(dirs), times, keys, background,
            max_bounce, method,
        )                                               # [2K, 3] linear
        rad_res = jnp.clip(
            jnp.sqrt(jnp.clip(rad, 1e-8, None)), 0.0, 0.999
        )
        L_in = _SG(rad_res[:n_edge])
        L_out = _SG(rad_res[n_edge:])

        # image-space outward normal + differentiable normal displacement
        cx = jnp.mean(_SG(x_px))
        cy = jnp.mean(_SG(y_px))
        nx = _SG(x_px) - cx
        ny = _SG(y_px) - cy
        nlen = jnp.sqrt(nx * nx + ny * ny) + 1e-8
        nx, ny = nx / nlen, ny / nlen
        psi = x_px * nx + y_px * ny                     # [K] differentiable

        # arc weight: perimeter in pixels / K; loss-jump density per px^2
        perim = 2.0 * jnp.pi * jnp.mean(nlen)
        jump = jnp.sum((L_in - tgt) ** 2 - (L_out - tgt) ** 2, axis=1)
        wk = _SG(
            jnp.where(on_screen, jump, 0.0)
            * perim / n_edge / (width * height * 3.0)
        )
        total = total + jnp.sum(wk * (psi - _SG(psi)))
    return total
