from sexy_raytracer_jax.utils import mathx, rng, color, config, png  # noqa: F401
