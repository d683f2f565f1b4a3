"""Inverse rendering: optimize scene parameters against a target image.

BASELINE config 5: recover PBR texture maps + sphere positions from the
reference's 5k-spp golden render via pixel gradients.

The loss renders a random pixel subset at low spp (stochastic over both
pixels and MC sample noise), gamma-resolves it exactly like the forward
pipeline (color.h:30-33), and takes an MSE against the target texels.
Gradients flow through hit_data + shade + camera (ops/*), with hit *finding*
stop-gradiented (topology is non-differentiable by design, SURVEY §7).

Multi-device: the train step runs under shard_map — pixels sharded over the
"rays" mesh axis, gradients psum'd across the whole mesh (the all-reduce is
overlapped with the backward pass by XLA) — and the optimizer update is
replicated. This is the gradient-all-reduce analogue of data-parallel
training.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import optax
from jax import shard_map
from jax.sharding import NamedSharding, PartitionSpec as P

from sexy_raytracer_jax.diff.params import extract_params, merge_params
from sexy_raytracer_jax.parallel.mesh import RAY_AXIS, SAMPLE_AXIS, make_mesh
from sexy_raytracer_jax.render.camera import Camera
from sexy_raytracer_jax.render.renderer import render_pixels
from sexy_raytracer_jax.utils.config import RenderConfig


def _loss_fn(
    params,
    scene,
    camera,
    pixel_ids,
    target_pixels,
    sample_start,
    base_key,
    background,
    *,
    width,
    height,
    spb,
    spp_total,
    max_bounce,
    method,
    loss_type="mse",
    huber_delta=0.1,
):
    full = merge_params(scene, params)
    rad = render_pixels(
        full,
        camera,
        pixel_ids,
        sample_start,
        base_key,
        background,
        width=width,
        height=height,
        spb=spb,
        spp_total=spp_total,
        max_bounce=max_bounce,
        method=method,
    )
    if loss_type == "tile_linear":
        # Tile-averaged UNBIASED linear loss for stochastic-target
        # (non-CRN) recovery: the residual is averaged over each
        # 128-pixel sample tile BEFORE squaring, so Monte-Carlo noise
        # averages down ~11x while smooth perturbation signal survives —
        # the per-pixel resolved loss's noise floor (~0.017 at spb 32)
        # drowned a 7e-4 perturbation signal entirely (round-5 phase-1b
        # failure). Linear space keeps the optimum exactly at the true
        # parameters (no resolve-bias); huber caps tile-mean fireflies.
        # ``target_pixels`` must be LINEAR radiance (target_lin / spp).
        G = 128  # sample_tile_ids tile size (16 x 8)
        n = rad.shape[0] // G
        r_t = (rad / spb).reshape(n, G, 3).mean(axis=1)
        t_t = target_pixels.reshape(n, G, 3).mean(axis=1)
        err = r_t - t_t
        a = jnp.abs(err)
        d = huber_delta
        return jnp.mean(jnp.where(a <= d, 0.5 * err * err,
                                  d * (a - 0.5 * d)))
    if loss_type == "linear_mse":
        # UNBIASED objective: the linear sample mean estimates the true
        # radiance for ANY spb, so the optimum sits exactly at the true
        # parameters. The resolved-space losses below are biased at low
        # spb (E[sqrt(mean_spb)] < sqrt(E) by Jensen, by a spb-dependent
        # amount — so a loss resolved at spb=32 against a target resolved
        # at 128 spp has its optimum AWAY from the true scene, flooring
        # exact-MSE recovery). Firefly variance is the tradeoff; cap the
        # residual's pull like huber but in linear space.
        err = rad / spb - target_pixels
        a = jnp.abs(err)
        d = huber_delta
        return jnp.mean(jnp.where(a <= d, 0.5 * err * err,
                                  d * (a - 0.5 * d)))
    # gamma-2 resolve + clamp like color.h:30-39 (the reference clamps to
    # 0.999 before quantizing, and the target is an 8-bit image, so values
    # past the clamp are unobservable). The clamp doubles as firefly
    # variance control: an unclamped low-spb estimator puts sqrt(250/spb)
    # ~ 2.8 into any pixel whose sample bounced into the HDR light,
    # flooring the loss at ~0.016 on the flagship — 3-8x the signal of a
    # realistic perturbation, which drowned every gradient (measured).
    # Epsilon keeps sqrt' finite at 0; clipped fireflies get zero grad.
    resolved = jnp.clip(jnp.sqrt(jnp.clip(rad / spb, 1e-8, None)), 0.0, 0.999)
    err = resolved - target_pixels
    if loss_type == "huber":
        # Robust loss for HDR scenes: a single direct hit on the
        # 250-intensity light saturates a low-spb pixel (bimodal
        # dark-vs-0.999 residuals, sigma ~ 0.4 on the flagship chief),
        # and those flips dominate the MSE gradient. Huber bounds each
        # pixel's pull at delta, a ~7x gradient-noise reduction there
        # while staying quadratic (exact) in smooth regions.
        a = jnp.abs(err)
        return jnp.mean(
            jnp.where(a <= huber_delta,
                      0.5 * err * err,
                      huber_delta * (a - 0.5 * huber_delta))
        )
    return jnp.mean(err * err)


class TrainState(NamedTuple):
    params: dict
    opt_state: object
    step: jnp.ndarray


def sample_tile_ids(rng_np, width, height, n_pixels, tile_w=16, tile_h=8,
                    roi=None):
    """Random screen tiles -> [n_pixels] int32 pixel ids.

    ``roi``: optional (row0, row1, col0, col1) region of interest — tiles
    are drawn inside it only. Concentrating samples on the subject is the
    lever that makes texel-level gradients usable: uniform flagship
    sampling gives each visible texel a ray every ~200 steps (pure-noise
    Adam updates, measured), an ROI multiplies that density by the
    inverse of the subject's screen fraction.

    Covers EVERY pixel (ADVICE r2: the old grid draw skipped the rightmost
    ``W % tile_w`` columns / bottom ``H % tile_h`` rows when the image is
    not tile-divisible, zeroing their gradients for the whole optimization)
    while staying spatially coherent within each 128-pixel tile so the
    clustered find kernel's ray blocks cull well (ops/pallas_find.py).
    Tiles are drawn from the ceil-grid with the last row/column clamped
    inward, so pixels in the clamped overlap get at most 2x sampling
    weight — a mild reweighting, not a hole.
    """
    tp = tile_w * tile_h
    n_tiles = max(1, n_pixels // tp)
    r0, r1, c0, c1 = roi if roi is not None else (0, height, 0, width)
    ntx = max(1, -(-(c1 - c0) // tile_w))
    nty = max(1, -(-(r1 - r0) // tile_h))
    # last tile clamps inward to the ROI edge when the ROI is at least one
    # tile wide (ADVICE r3: clamping only to the image edge let tiles spill
    # up to tile-1 pixels past the ROI's right/bottom edge)
    x0 = np.minimum(
        np.minimum(
            c0 + rng_np.integers(0, ntx, size=n_tiles) * tile_w,
            max(c1 - tile_w, c0),
        ),
        max(width - tile_w, 0),
    )
    y0 = np.minimum(
        np.minimum(
            r0 + rng_np.integers(0, nty, size=n_tiles) * tile_h,
            max(r1 - tile_h, r0),
        ),
        max(height - tile_h, 0),
    )
    yy = np.arange(tile_h)[:, None]
    xx = np.arange(tile_w)[None, :]
    # clamp inside the image (only bites when the image is smaller than a
    # tile; duplicates are harmless sample-weighting)
    y = np.minimum(y0[:, None, None] + yy[None], height - 1)
    x = np.minimum(x0[:, None, None] + xx[None], width - 1)
    ids = (y * width + x).reshape(-1)
    if ids.size < n_pixels:  # pad by repeating (n_pixels not tile-divisible)
        ids = np.concatenate([ids, ids[: n_pixels - ids.size]])
    return ids[:n_pixels].astype(np.int32)


def make_train_step(
    mesh,
    config: RenderConfig,
    optimizer,
    spb: int = 4,
    method: str = "auto",
    trainable=None,
    grad_masks=None,
    loss_type: str = "mse",
    huber_delta: float = 0.1,
    param_transform=None,
    donate_state: bool = False,
):
    """Build a jitted SPMD train step.

    Returns ``step(state, scene, camera, pixel_ids, target_pixels, key)
    -> (state, loss)`` where ``pixel_ids``/``target_pixels`` are sharded on
    the ray axis.

    ``grad_masks``: optional dict param-name -> broadcastable 0/1 array;
    masked-out elements receive zero gradient (e.g. freeze the ground and
    light spheres while optimizing the subject spheres' positions).

    ``param_transform``: optional differentiable fn mapping the optimized
    param dict -> the scene-field dict merged into the scene. Enables
    reparameterizations like coarse-to-fine texture optimization (optimize
    a downsampled delta, upsample into the atlas): a coarse texel
    aggregates the gradient of every fine texel under it, directly
    attacking per-texel ray starvation (VERDICT r3 weak #3).
    """
    kwargs = dict(
        width=config.width,
        height=config.height,
        spb=spb,
        # Training always wants every traced sample: the loss divides by
        # spb, so masking samples with sid >= config.samples_per_pixel
        # (renderer.py's overshoot guard for the *rendering* driver) would
        # silently bias the estimate dark whenever spb * n_sample_shards
        # exceeds the config's spp (ADVICE r4 medium). The sample-shard
        # offsets run to spb * n_shards, so that is the training spp.
        spp_total=spb * mesh.shape[SAMPLE_AXIS],
        max_bounce=config.max_bounce,
        method=method,
        loss_type=loss_type,
        huber_delta=huber_delta,
    )
    background = jnp.asarray(config.background, jnp.float32)

    def local_value_and_grad(params, scene, camera, pixel_ids, target_pixels, key):
        sample_shard = jax.lax.axis_index(SAMPLE_AXIS)
        loss_of = functools.partial(_loss_fn, **kwargs)
        if param_transform is not None:
            loss_of = (
                lambda p, *a, _f=loss_of: _f(param_transform(p), *a)
            )
        loss, grads = jax.value_and_grad(loss_of)(
            params,
            scene,
            camera,
            pixel_ids,
            target_pixels,
            sample_shard * spb,
            key,
            background,
        )
        # gradient all-reduce across the whole mesh (DP analogue)
        grads = jax.lax.pmean(
            jax.lax.pmean(grads, RAY_AXIS), SAMPLE_AXIS
        )
        loss = jax.lax.pmean(jax.lax.pmean(loss, RAY_AXIS), SAMPLE_AXIS)
        if grad_masks:
            grads = {
                k: g * jnp.asarray(grad_masks[k], g.dtype)
                if k in grad_masks else g
                for k, g in grads.items()
            }
        return loss, grads

    mapped = shard_map(
        local_value_and_grad,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(RAY_AXIS), P(RAY_AXIS), P()),
        out_specs=(P(), P()),
        check_vma=False,
    )

    # donate_state: params/opt-state buffers are dead after the call for
    # loop-style callers, and in-place reuse lets XLA alias the optimizer
    # update's outputs. Opt-in because donation DELETES the caller's input
    # buffers (callers that keep the original params for comparison, like
    # the dryrun, must not donate).
    @functools.partial(
        jax.jit, donate_argnums=(0,) if donate_state else ()
    )
    def _step_jit(state: TrainState, scene, camera, pixel_ids, target_pixels,
                  key):
        loss, grads = mapped(
            state.params, scene, camera, pixel_ids, target_pixels, key
        )
        updates, opt_state = optimizer.update(grads, state.opt_state, state.params)
        params = optax.apply_updates(state.params, updates)
        return TrainState(params, opt_state, state.step + 1), loss

    def step(state, scene, camera, pixel_ids, target_pixels, key):
        return _step_jit(state, scene, camera, pixel_ids, target_pixels, key)

    def init(params):
        """Convenience TrainState constructor."""
        # COPY the arrays: extract_params aliases the scene's own buffers,
        # and with donate_state the first step call would otherwise delete
        # the scene's arrays out from under every later use of it. The
        # state is placed replicated on the mesh, as the step returns it,
        # so the first call compiles the steady-state signature.
        params = {k: jnp.asarray(v).copy() for k, v in params.items()}
        state = TrainState(params, optimizer.init(params), jnp.int32(0))
        if jax.process_count() > 1:
            return state
        return jax.device_put(state, NamedSharding(mesh, P()))

    def params_of(state):
        return dict(state.params)

    step.init = init
    step.params_of = params_of
    return step


def make_optimizer(params, learning_rate, lr_overrides=None, decay_steps=None):
    """Adam with per-parameter-group learning rates and cosine decay.

    Adam's update magnitude is ~lr per element regardless of gradient
    scale, so parameter groups living on very different scales need
    different rates: the shade_atlas/atlas texel packs are 0-255
    reference scale (texture.h:147) while sphere centers and material
    factors are unit scale. A single lr either freezes the textures or
    explodes the geometry. Default: texel-pack params get ``lr * 256``.

    ``decay_steps``: cosine-decay the lr to 5% over the run. Essential
    under Monte-Carlo gradient noise — at constant lr Adam random-walks
    every parameter (measured: the *unperturbed* ground-sphere center
    drifted 2.3 units over 300 steps), so the loss plateaus noisily
    instead of converging.
    """
    lr_overrides = dict(lr_overrides) if lr_overrides else {}
    for texel_group in ("shade_atlas", "atlas"):
        if texel_group in params:
            lr_overrides.setdefault(texel_group, learning_rate * 256.0)
    lr_overrides = {k: v for k, v in lr_overrides.items() if k in params}

    def tx(lr):
        if decay_steps:
            lr = optax.cosine_decay_schedule(lr, decay_steps, alpha=0.05)
        # zero_nans: a single non-finite gradient (e.g. a degenerate
        # specular configuration on one sampled path) must skip that
        # element's update, not permanently poison the parameters.
        return optax.chain(optax.zero_nans(), optax.adam(lr))

    if not lr_overrides:
        return tx(learning_rate)
    labels = {k: (k if k in lr_overrides else "_default") for k in params}
    txs = {"_default": tx(learning_rate)}
    for k, v in lr_overrides.items():
        txs[k] = tx(v)
    return optax.multi_transform(txs, labels)


def inverse_render(
    scene,
    target_image: np.ndarray,
    config: RenderConfig,
    n_steps: int = 200,
    pixels_per_step: int = 4096,
    spb: int = 4,
    learning_rate: float = 3e-3,
    lr_overrides=None,
    trainable=None,
    mesh=None,
    method: str = "auto",
    camera: Camera | None = None,
    seed: int = 0,
    log_every: int = 25,
    progress: bool = True,
    param_ema: float = 0.98,
    grad_masks=None,
    roi=None,
    loss_type: str = "mse",
    huber_delta: float = 0.1,
    init_params=None,
    param_transform=None,
    crn_key=None,
):
    """Optimize scene params against ``target_image`` ([H,W,3] float 0..1).

    ``init_params``/``param_transform``: optimize in a reparameterized
    space — ``init_params`` is the starting dict and ``param_transform``
    maps it (differentiably) to scene-field arrays (see make_train_step).

    ``crn_key``: common-random-numbers mode. When the target is OUR OWN
    render (self-recovery experiments), pass its base PRNG key and set
    ``spb`` to the target's full spp: every step then traces the exact
    sample set the target used, so the Monte-Carlo noise cancels out of
    the residual identically — at the true parameters the loss is
    EXACTLY zero. This is correlated-sampling inverse rendering, the
    standard variance-reduction for render-to-render optimization;
    measured per-texel gradient SNR without it is ~0.03/step on the
    flagship (noise 40x signal — unrecoverable in any practical step
    count). Not applicable when the target is an external image.

    Returns (optimized SceneData, losses list).

    ``param_ema``: the returned parameters are an exponential moving
    average over the trajectory (Polyak averaging). Under Monte-Carlo
    gradient noise Adam's iterates random-walk around the optimum with
    radius ~lr — measured on the CI scene: the loss touched 8e-4
    mid-run, then wandered back to ~1e-2 — while the EMA sits at the
    walk's center. Set 0 to disable.
    """
    from sexy_raytracer_jax.diff.params import DEFAULT_TRAINABLE

    trainable = tuple(trainable or DEFAULT_TRAINABLE)
    # drop empty-array params (e.g. sphere centers in a sphere-free scene)
    trainable = tuple(
        n for n in trainable if getattr(scene, n).size > 0
    )
    if mesh is None:
        mesh = make_mesh()
    if camera is None:
        camera = Camera.from_config(config.camera, config.aspect)

    if init_params is not None:
        params = {k: jnp.asarray(v) for k, v in init_params.items()}
    else:
        params = extract_params(scene, trainable)
    optimizer = make_optimizer(
        params, learning_rate, lr_overrides, decay_steps=n_steps
    )
    state = TrainState(params, optimizer.init(params), jnp.int32(0))
    step = make_train_step(
        mesh, config, optimizer, spb=spb, method=method,
        grad_masks=grad_masks, loss_type=loss_type, huber_delta=huber_delta,
        param_transform=param_transform,
    )

    W, H = config.width, config.height
    target_flat = jnp.asarray(
        np.asarray(target_image, np.float32).reshape(H * W, 3)
    )
    n_ray_shards = mesh.shape[RAY_AXIS]
    pixels_per_step = max(
        n_ray_shards, pixels_per_step // n_ray_shards * n_ray_shards
    )

    key = jax.random.key(seed)
    rng_np = np.random.default_rng(seed)
    losses = []
    ema = None

    @jax.jit
    def _ema_update(ema, params):
        return jax.tree.map(
            lambda e, p: param_ema * e + (1.0 - param_ema) * p, ema, params
        )

    for i in range(n_steps):
        ids = sample_tile_ids(rng_np, W, H, pixels_per_step, roi=roi)
        ids_dev = jnp.asarray(ids)
        tgt = target_flat[ids_dev]
        if crn_key is not None:
            sub = crn_key
        else:
            key, sub = jax.random.split(key)
        state, loss = step(state, scene, camera, ids_dev, tgt, sub)
        if param_ema:
            ema = state.params if ema is None else _ema_update(ema, state.params)
        losses.append(loss)  # device value; sync'd in bulk below
        if progress and (i % log_every == 0 or i == n_steps - 1):
            print(f"step {i}: loss {float(loss):.6f}", flush=True)
    losses = [float(l) for l in losses]  # full per-step curve
    final = ema if param_ema else state.params
    if param_transform is not None:
        final = param_transform(final)
    return merge_params(scene, final), losses
