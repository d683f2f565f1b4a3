#!/usr/bin/env python
"""Headline benchmark: Mrays/s per card, forward + backward, 720p flagship.

Runs the differentiable render step (forward trace + pixel-MSE + backward
through shading/hit-data, hit finding via the clustered kernel) on the
seeded flagship stand-in (``presets.flagship_standin``: the flagship's
3,042-triangle, two-texture-pair shapes with the reference's camera,
ground, HDR light, iron and mirror spheres) at 1280x720, and reports traced
rays per second.

Ray accounting: rays = paths * max_bounce (4, reference main.cpp:180) —
the fixed-depth wavefront traces every bounce slot.

Before any number is taken, the kernels are checked against their jnp
references on the card (``chip_smoke.phase_parity``). Extra fields:
``fwd_only`` Mrays/s per card for the forward render path, ``step_ms``, and
``frame_wallclock_s`` — a full 1280x720 frame at ``frame_spp``, measured.

Prints the platform, device kind, count, card name and power limit, then
ONE JSON line: {"metric", "value", "unit", ...}. Needs a GPU.
"""

import json
import subprocess
import sys
import time


def main():
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    dev = jax.devices()[0]
    n_dev = len(jax.devices())
    if dev.platform != "gpu":
        print("bench: no GPU found; the benchmark runs only on the card",
              file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(f"platform {dev.platform}, kind {dev.device_kind!r}, count {n_dev}"
          f"; nvidia-smi name, power.limit: {card}", flush=True)

    import chip_smoke
    from sexy_raytracer_jax.diff.inverse import make_train_step, sample_tile_ids
    from sexy_raytracer_jax.diff.params import extract_params
    from sexy_raytracer_jax.models import presets
    from sexy_raytracer_jax.parallel.mesh import make_mesh, replicate_scene, shard_rays
    from sexy_raytracer_jax.render.camera import Camera
    from sexy_raytracer_jax.render.renderer import render_pixels, tile_pixel_order

    scene, cfg = presets.flagship_standin()
    camera = Camera.from_config(cfg.camera, cfg.aspect)

    # the kernels must return the jnp references' answers on this card
    # before any number is recorded (raises on a mismatch)
    chip_smoke.phase_parity(scene, cfg, camera)

    mesh = make_mesh()  # all local devices on the ray axis

    spb = 4
    pixels = 32768  # 131072 paths per step per device group
    optimizer = optax.adam(1e-3)
    params = extract_params(scene)
    step = make_train_step(mesh, cfg, optimizer, spb=spb, method="auto",
                           donate_state=True)
    # init copies the params, so donating the state cannot delete the
    # scene's own buffers
    state = step.init(params)

    scene_r = replicate_scene(scene, mesh)
    # random screen tiles — the realistic inverse-rendering batch shape
    # (spatially coherent blocks; see diff/inverse.py sample_tile_ids)
    rng = np.random.default_rng(0)
    ids = sample_tile_ids(rng, cfg.width, cfg.height, pixels)
    pix = shard_rays(jnp.asarray(ids), mesh)
    tgt = shard_rays(jnp.full((pixels, 3), 0.5, jnp.float32), mesh)

    # warm-up / compile
    state, loss = step(state, scene_r, camera, pix, tgt, jax.random.key(0))
    _ = float(loss)

    n_steps = 8
    t0 = time.time()
    for i in range(n_steps):
        state, loss = step(state, scene_r, camera, pix, tgt, jax.random.key(i + 1))
    _ = float(loss)  # forces completion of the whole stream
    dt = time.time() - t0

    paths = pixels * spb * n_steps
    rays = paths * cfg.max_bounce
    mrays_per_chip = rays / dt / 1e6 / n_dev
    step_s = dt / n_steps

    # forward-only: the pure render path (no loss/backward), same batch
    import functools

    fwd = jax.jit(functools.partial(
        render_pixels,
        width=cfg.width, height=cfg.height, spb=spb,
        spp_total=cfg.samples_per_pixel, max_bounce=cfg.max_bounce,
        method="auto",
    ))
    order = tile_pixel_order(cfg.width, cfg.height)
    fpix = jnp.asarray(order[:pixels])
    bg = jnp.asarray(cfg.background, jnp.float32)
    key = jax.random.key(0)
    fwd(scene, camera, fpix, jnp.int32(0), key, bg).block_until_ready()
    t0 = time.time()
    for i in range(n_steps):
        out = fwd(scene, camera, fpix, jnp.int32(i * spb), key, bg)
    np.asarray(out)  # forces the stream
    fwd_dt = time.time() - t0
    fwd_mrays_chip = rays / fwd_dt / 1e6 / n_dev

    # full-frame wall-clock at 720p, measured end to end through the driver
    # after a warm-up frame (spp_total is a static jit argument, so the
    # warm-up runs at the same spp)
    from dataclasses import replace

    from sexy_raytracer_jax.render.renderer import render_accumulate

    frame_spp = 32
    fcfg = replace(cfg, samples_per_pixel=frame_spp)
    render_accumulate(scene, fcfg, method="auto")
    t0 = time.time()
    render_accumulate(scene, fcfg, method="auto")
    frame_s = time.time() - t0

    print(
        json.dumps(
            {
                "metric": "mrays_per_s_per_card_fwd_bwd_720p_flagship_standin",
                "value": round(mrays_per_chip, 3),
                "unit": "Mrays/s/card",
                "fwd_only": round(fwd_mrays_chip, 3),
                "step_ms": round(step_s * 1e3, 2),
                "frame_wallclock_s": round(frame_s, 2),
                "frame_spp": frame_spp,
                "device": {"platform": dev.platform,
                           "kind": dev.device_kind, "count": n_dev},
                "card": card,
            }
        )
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
