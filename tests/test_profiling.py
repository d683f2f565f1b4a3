"""In-framework profiling utilities (SURVEY §5 tracing/profiling)."""

import json

import jax.numpy as jnp

from sexy_raytracer_jax.utils.profiling import Meter, sync


def test_meter_accumulates_and_reports():
    m = Meter("t")
    with m.step(paths=100, bounces=4) as s:
        s.value = jnp.ones((8,))
    with m.step(paths=50, bounces=4) as s:
        s.value = None  # sync is optional
    r = json.loads(m.report())
    assert r["steps"] == 2
    assert m.paths == 150 and m.rays == 600
    assert r["mrays_per_s"] > 0


def test_sync_forces_pytrees():
    sync(None)
    sync({"a": jnp.arange(4), "b": jnp.ones((2, 2))})


def test_renderer_prints_meter(capsys):
    import numpy as np

    from sexy_raytracer_jax.models import SceneBuilder
    from sexy_raytracer_jax.render.renderer import render_accumulate
    from sexy_raytracer_jax.utils.config import CameraConfig, RenderConfig

    b = SceneBuilder()
    b.add_sphere((0, 0, -2), 1.0, b.add_pbr_material())
    scene = b.build(build_bvh=False)
    cfg = RenderConfig(width=8, height=8, samples_per_pixel=2, max_bounce=2,
                       camera=CameraConfig(eye=(0, 0, 2), look_at=(0, 0, 0)))
    render_accumulate(scene, cfg, method="bruteforce", progress=True)
    out = capsys.readouterr().out
    assert '"meter": "render_accumulate"' in out
    assert '"mrays_per_s"' in out
