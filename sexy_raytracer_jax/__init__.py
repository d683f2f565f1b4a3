"""sexy-raytracer-jax: a differentiable wavefront path tracer in JAX.

A from-scratch re-design of the capability set of swishersnaaake/sexy-raytracer
(a single-threaded header-only C++ CPU ray tracer) as a JAX/XLA/Pallas
framework for an NVIDIA GPU:

  * flat SoA scenes (the reference's ``hittableIndexed`` concept done right),
  * wavefront path tracing as a fixed-depth bounce loop,
  * a clustered Pallas hit-search kernel (intersection = non-differentiable
    index search; hit data recomputed differentiably in jnp),
  * ``jax.sharding`` data-parallel rendering over device meshes,
  * end-to-end pixel gradients for inverse rendering.

Reference parity notes cite files as ``<file>:<line>`` into the reference
repository.
"""

__version__ = "0.1.0"

import os as _os


def compilation_cache_dir(environ=_os.environ) -> str:
    """Where compiled programs persist: ``$JAX_COMPILATION_CACHE_DIR`` when
    it is set, else ``.jax_cache/`` at the root of this checkout."""
    return environ.get("JAX_COMPILATION_CACHE_DIR") or _os.path.join(
        _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
        ".jax_cache",
    )


# A render or train step takes tens of seconds to compile; every entry point
# reuses the persistent cache. JAX itself reads the variable when it is set.
if not _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    import jax as _jax

    _jax.config.update("jax_compilation_cache_dir", compilation_cache_dir())

from sexy_raytracer_jax.utils.config import RenderConfig  # noqa: F401,E402
from sexy_raytracer_jax.render.camera import Camera  # noqa: F401,E402
