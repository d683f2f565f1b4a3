from sexy_raytracer_jax.oracle.reference import Oracle  # noqa: F401
