from sexy_raytracer_jax.ops.intersect import HitRecord, find_hit, hit_data  # noqa: F401
