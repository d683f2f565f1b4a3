"""Regression net over the checked-in flagship 720p render.

artifacts/flagship/render_720p_1000spp.png is the framework's own
flagship-equivalent deliverable (VERDICT r2 #5) — rendered at
1280x720/1000spp by an earlier version of this framework and verified
against the reference golden (artifacts/flagship/report.json: every region
passes). This test locks a fresh low-spp render against THAT artifact, so
any semantic drift in the render path fails CI without needing an
accelerator or the reference image.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

ARTIFACT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "artifacts", "flagship", "render_720p_1000spp.png",
)

# 720p regions (tests/test_golden.py 240p map x3); linear-mean tolerances
# cover the fresh render's 48-spp Monte-Carlo noise
REGIONS = {
    "sky": ((0, 150), (0, 300), 0.01),
    "ground_right": ((600, 708), (900, 1272), 0.015),
    "metal_sphere": ((435, 540), (870, 1080), 0.03),
    "chief_torso": ((198, 330), (579, 699), 0.035),
    "chief_legs": ((429, 600), (579, 699), 0.035),
}


def test_flagship_artifact_region_statistics(data_dir):
    if not os.path.exists(ARTIFACT):
        pytest.skip("flagship artifact not rendered yet")
    from sexy_raytracer_jax.models import presets
    from sexy_raytracer_jax.render.camera import Camera
    from sexy_raytracer_jax.render.renderer import render_pixels
    from sexy_raytracer_jax.utils.png import read_png

    art = read_png(ARTIFACT, 3).astype(np.float64) / 255.0
    scene, cfg = presets.masterchief(data_dir=data_dir, height=720)
    W, H = cfg.width, cfg.height
    cam = Camera.from_config(cfg.camera, cfg.aspect)
    bg = jnp.asarray(cfg.background, jnp.float32)

    failures = []
    for name, (rows, cols, tol) in REGIONS.items():
        rr = np.arange(rows[0], rows[1], 6)
        cc = np.arange(cols[0], cols[1], 6)
        pid = jnp.asarray(
            (rr[:, None] * W + cc[None, :]).ravel().astype(np.int32)
        )
        spp, spb = 48, 4
        fn = jax.jit(lambda s, start: render_pixels(
            s, cam, pid, start, jax.random.key(0), bg,
            width=W, height=H, spb=spb, spp_total=spp,
            max_bounce=cfg.max_bounce, method="bruteforce",
        ))
        acc = 0
        for i in range(spp // spb):
            acc = acc + fn(scene, jnp.int32(i * spb))
        ours = np.clip(np.asarray(acc) / spp, 0, 0.998).mean(axis=0)
        ref = (art[rows[0]:rows[1]:6, cols[0]:cols[1]:6] ** 2).mean(axis=(0, 1))
        err = np.abs(ours - ref)
        if (err > tol).any():
            failures.append(
                f"{name}: ours={ours.round(4)} artifact={ref.round(4)} tol={tol}"
            )
    assert not failures, "\n".join(failures)
