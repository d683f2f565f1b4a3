from sexy_raytracer_jax.models.scene import (  # noqa: F401
    MAT_PBR,
    MAT_METAL,
    MAT_DIELECTRIC,
    MAT_LIGHT,
    TEX_NONE,
    TEX_SOLID,
    TEX_CHECKER,
    TEX_IMAGE,
    SceneData,
    SceneBuilder,
)
