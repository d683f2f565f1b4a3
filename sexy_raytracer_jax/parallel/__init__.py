from sexy_raytracer_jax.parallel.mesh import (  # noqa: F401
    make_mesh,
    replicate_scene,
    shard_rays,
)
from sexy_raytracer_jax.parallel.render import render_sharded  # noqa: F401
