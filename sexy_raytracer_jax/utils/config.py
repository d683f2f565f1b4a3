"""Run-time configuration.

The reference configures everything at compile time — resolution/spp/bounces
as consts (reference main.cpp:175-180), scene choice via ``#if`` blocks
(main.cpp:60-80), camera hardcoded (main.cpp:163-172). Here the same knobs are
a real config object, and the five BASELINE acceptance configs are named
presets (see ``sexy_raytracer_jax.models.presets``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Camera parameters (reference camera.h:10-38, defaults main.cpp:163-172)."""

    eye: Tuple[float, float, float] = (0.0, 3.0, 5.0)
    look_at: Tuple[float, float, float] = (0.0, 2.5, 0.0)
    up: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    vfov_degrees: float = 70.0
    aperture: float = 0.1
    focus_dist: float = 10.0
    time0: float = 0.0
    time1: float = 1.0


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """One render job (reference main.cpp:156-242 flagship defaults)."""

    width: int = 1280
    height: int = 720
    samples_per_pixel: int = 5000
    max_bounce: int = 4
    background: Tuple[float, float, float] = (0.53, 0.81, 0.92)  # main.cpp:170
    camera: CameraConfig = dataclasses.field(default_factory=CameraConfig)
    seed: int = 0
    # Paths traced per device dispatch (chunk_pixels * samples_per_batch);
    # large dispatches amortize the per-dispatch host cost. Not yet
    # measured on the GPU.
    rays_per_chunk: int = 1 << 19
    # Samples accumulated per compiled step (chunked over spp).
    samples_per_batch: int = 8

    @property
    def aspect(self) -> float:
        return self.width / self.height
