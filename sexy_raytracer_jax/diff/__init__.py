from sexy_raytracer_jax.diff.params import (  # noqa: F401
    DEFAULT_TRAINABLE,
    extract_params,
    merge_params,
)
from sexy_raytracer_jax.diff.inverse import (  # noqa: F401
    make_train_step,
    inverse_render,
)
