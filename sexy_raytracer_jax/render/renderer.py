"""Render driver: pixel grid -> chunked wavefronts -> accumulated image.

The reference's triple pixel/sample loop (reference main.cpp:200-227) becomes
a flat pixel-id grid processed in fixed-size ray chunks, each chunk a single
compiled dispatch that traces ``samples_per_batch`` samples for every pixel
and accumulates on device. (pixel, sample) pairs key the counter-based RNG
via a two-level fold-in, so the image is independent of chunking and
sharding at any resolution/spp (no flat-uid int32 overflow).

Pixel-to-viewport mapping replicates main.cpp:209-211:
    u = (x + rand) / (W-1),  v = ((H - y) + rand) / (H-1)
(with the reference's vertical flip, so row 0 is the top of the image).
"""

from __future__ import annotations

import functools
import os
import time

import jax
import jax.numpy as jnp
import numpy as np

from sexy_raytracer_jax.render.camera import Camera
from sexy_raytracer_jax.render.integrator import trace_rays
from sexy_raytracer_jax.utils import color as colorlib
from sexy_raytracer_jax.utils import rng
from sexy_raytracer_jax.utils.config import RenderConfig


def camera_rays(camera: Camera, pixel_ids, sample_start, base_key, *,
                width: int, height: int, spb: int):
    """Primary rays for ``spb`` samples of each pixel id.

    Returns ``(org, dir, time, keys, sid)`` over ``C * spb`` paths, pixel
    major. (pixel, sample) pairs key the counter-based RNG via a two-level
    fold-in: a flat pid*spp+sid uid overflows int32 at 720p/5000spp and
    aliased ~7% of sample keys (rng.ray_keys_2d).
    """
    C = pixel_ids.shape[0]
    pid = jnp.repeat(pixel_ids, spb)
    sid = sample_start + jnp.tile(jnp.arange(spb, dtype=jnp.int32), C)
    keys = rng.ray_keys_2d(base_key, pid, sid)
    ucam = rng.per_ray_uniform_block(keys, 5)

    x = (pid % width).astype(jnp.float32)
    y = (pid // width).astype(jnp.float32)
    u = (x + ucam[..., 0]) / (width - 1)
    v = ((height - y) + ucam[..., 1]) / (height - 1)

    org, direction, time = camera.get_rays(u, v, ucam[..., 2:5])
    return org, direction, time, keys, sid


def render_pixels(
    scene,
    camera: Camera,
    pixel_ids,
    sample_start,
    base_key,
    background,
    *,
    width: int,
    height: int,
    spb: int,
    spp_total: int,
    max_bounce: int,
    method: str,
):
    """Pure chunk body: trace ``spb`` samples per pixel id -> radiance sums
    [C,3]. Differentiable w.r.t. scene/camera arrays; reused by the jitted
    single-device driver, the shard_map SPMD driver (parallel/render.py),
    and the inverse-rendering loss (diff/inverse.py)."""
    C = pixel_ids.shape[0]
    org, direction, time, keys, sid = camera_rays(
        camera, pixel_ids, sample_start, base_key,
        width=width, height=height, spb=spb,
    )
    radiance = trace_rays(
        scene, org, direction, time, keys, background, max_bounce, method,
    )
    # drop overshoot samples (sid >= spp_total): the SPMD driver's final
    # round traces a full spb per sample-shard even when spp is not
    # divisible by spb * n_sample_shards; masking here makes the sharded
    # image equal the single-device image for ANY spp
    radiance = jnp.where((sid < spp_total)[:, None], radiance, 0.0)
    return radiance.reshape(C, spb, 3).sum(axis=1)


render_chunk = functools.partial(
    jax.jit,
    static_argnames=("width", "height", "spb", "spp_total", "max_bounce",
                     "method"),
)(render_pixels)


def tile_pixel_order(width: int, height: int, tile_w: int = 32,
                     tile_h: int = 16) -> np.ndarray:
    """All pixel ids in tile-major order -> [W*H] int32.

    Consecutive pixels form 2D screen tiles, so the fixed-size ray blocks
    of the clustered find kernel (ops/pallas_find.py) see spatially
    coherent rays and cull well. Row-major order would hand each block a
    scanline strip that overlaps many more triangle clusters.
    """
    ids = []
    for y0 in range(0, height, tile_h):
        for x0 in range(0, width, tile_w):
            yy = np.arange(y0, min(y0 + tile_h, height))
            xx = np.arange(x0, min(x0 + tile_w, width))
            ids.append((yy[:, None] * width + xx[None, :]).ravel())
    return np.concatenate(ids).astype(np.int32)


def render(
    scene,
    config: RenderConfig,
    camera: Camera | None = None,
    method: str = "auto",
    progress: bool = False,
    checkpoint: str | None = None,
) -> np.ndarray:
    """Full render -> resolved (gamma-encoded) float image ``[H,W,3]``."""
    accum = render_accumulate(scene, config, camera, method, progress, checkpoint)
    return np.asarray(colorlib.resolve(accum, config.samples_per_pixel))


def render_accumulate(
    scene,
    config: RenderConfig,
    camera: Camera | None = None,
    method: str = "auto",
    progress: bool = False,
    checkpoint: str | None = None,
):
    """Raw accumulated radiance (sum over samples) ``[H,W,3]`` numpy array.

    ``checkpoint``: optional npz path for resumable renders. The per-pixel
    sample accumulator is the natural checkpoint (SURVEY §5 — the reference
    is all-or-nothing, main.cpp:237): after every (chunk, sample-batch)
    unit the accumulator and progress counter are saved; a rerun with the
    same config resumes additively. The counter-based RNG makes the result
    identical to an uninterrupted run.
    """
    W, H = config.width, config.height
    spp = config.samples_per_pixel
    spb = min(config.samples_per_batch, spp)
    if camera is None:
        camera = Camera.from_config(config.camera, config.aspect)
    base_key = jax.random.key(config.seed)
    background = jnp.asarray(config.background, jnp.float32)

    P = W * H
    chunk = max(1, min(config.rays_per_chunk // spb, P))
    accum = np.zeros((P, 3), np.float32)
    units_done = 0

    from sexy_raytracer_jax.utils.profiling import Meter

    meter = Meter("render_accumulate")
    order = tile_pixel_order(W, H)
    # units_done attributes completed chunks to pixel sets via this order;
    # resuming under a different traversal would silently corrupt the image
    # (ADVICE r2), so the checkpoint records the order's hash and a
    # mismatch restarts instead of resuming.
    import zlib

    order_hash = np.uint32(zlib.crc32(order.tobytes()))

    if checkpoint is not None and os.path.exists(checkpoint):
        saved = np.load(checkpoint)
        if (
            saved["shape"].tolist() == [H, W]
            and int(saved["spp"]) == spp
            and int(saved["seed"]) == config.seed
            and int(saved["chunk"]) == chunk
            and int(saved["spb"]) == spb
            and "order_hash" in saved
            and np.uint32(saved["order_hash"]) == order_hash
        ):
            accum = saved["accum"]
            units_done = int(saved["units_done"])
            if progress:
                print(f"resuming from {checkpoint} (unit {units_done})")
        elif progress:
            print(f"checkpoint {checkpoint} incompatible; restarting")
    unit = 0
    for start in range(0, P, chunk):
        ids = order[start : min(start + chunk, P)]
        n_valid = ids.shape[0]
        if n_valid < chunk:
            ids = np.pad(ids, (0, chunk - n_valid))
        ids_dev = None
        chunk_accum = None
        dirty = False
        for s0 in range(0, spp, spb):
            if unit < units_done:
                unit += 1
                continue
            if ids_dev is None:
                ids_dev = jnp.asarray(ids)
                chunk_accum = jnp.asarray(accum[ids])
                chunk_t0 = time.time()
                chunk_paths = 0
            n_s = min(spb, spp - s0)  # final batch may be partial
            out = render_chunk(
                scene,
                camera,
                ids_dev,
                jnp.int32(s0),
                base_key,
                background,
                width=W,
                height=H,
                spb=n_s,
                spp_total=spp,
                max_bounce=config.max_bounce,
                method=method,
            )
            chunk_accum = chunk_accum + out
            chunk_paths += n_valid * n_s
            unit += 1
            dirty = True
        if dirty:
            # the host download is the sync point; meter the whole chunk
            # here so the sample batches stay pipelined
            accum[ids[:n_valid]] = np.asarray(chunk_accum)[:n_valid]
            meter.seconds += time.time() - chunk_t0
            meter.paths += chunk_paths
            meter.rays += chunk_paths * config.max_bounce
            meter.steps += 1
            units_done = unit
            if checkpoint is not None:
                np.savez(
                    checkpoint,
                    accum=accum,
                    units_done=units_done,
                    shape=np.asarray([H, W]),
                    spp=spp,
                    seed=config.seed,
                    chunk=chunk,
                    spb=spb,
                    order_hash=order_hash,
                )
        if progress:
            done = min(start + chunk, P)
            print(f"\rpixels {done}/{P}", end="", flush=True)
    if progress:
        print()
        print(meter.report(), flush=True)
    return accum.reshape(H, W, 3)


def render_image(
    scene,
    config: RenderConfig,
    camera: Camera | None = None,
    method: str = "auto",
    progress: bool = False,
    checkpoint: str | None = None,
) -> np.ndarray:
    """Full render -> uint8 RGB image ``[H,W,3]`` (gamma-2, reference color.h)."""
    return colorlib.to_uint8(
        render(scene, config, camera, method, progress, checkpoint)
    )
