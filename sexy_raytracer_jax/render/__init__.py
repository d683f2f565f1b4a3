from sexy_raytracer_jax.render.camera import Camera  # noqa: F401
from sexy_raytracer_jax.render.integrator import trace_rays  # noqa: F401
from sexy_raytracer_jax.render.renderer import render, render_image  # noqa: F401
