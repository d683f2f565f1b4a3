"""Render checkpoint/resume: interrupted + resumed == uninterrupted."""

import numpy as np

from tests.test_render import small_config, small_scene
from sexy_raytracer_jax.render.renderer import render_accumulate


def test_resume_matches_uninterrupted(tmp_path):
    scene = small_scene()
    cfg = small_config(rays_per_chunk=1024, samples_per_batch=4)
    full = render_accumulate(scene, cfg)

    ckpt = str(tmp_path / "render.npz")
    # simulate an interrupted run: render only the first chunk-units by
    # writing a partial checkpoint (run fully, then truncate progress)
    render_accumulate(scene, cfg, checkpoint=ckpt)
    saved = dict(np.load(ckpt))
    # rewind to ~half of the units; zero the not-yet-rendered pixels
    units = int(saved["units_done"])
    chunk = int(saved["chunk"])
    spb = int(saved["spb"])
    spp = int(saved["spp"])
    batches_per_chunk = -(-spp // spb)
    half_units = (units // 2 // batches_per_chunk) * batches_per_chunk
    pixels_done = (half_units // batches_per_chunk) * chunk
    accum = saved["accum"]
    accum[pixels_done:] = 0.0
    np.savez(ckpt, **{**saved, "accum": accum, "units_done": half_units})

    resumed = render_accumulate(scene, cfg, checkpoint=ckpt)
    np.testing.assert_array_equal(resumed, full)
