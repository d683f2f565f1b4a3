#!/usr/bin/env python
"""Smoke test of the main path on an NVIDIA GPU.

    python chip_smoke.py             # one card: phases 1-5 below
    python chip_smoke.py --chips 4   # four cards: the sharded paths only
                                     # (a 256x144 frame on 4x1 and 2x2
                                     # meshes, a train step on 2x2)

Runs in one JAX process and exits non-zero on any failure; with no GPU it
fails before doing any work. Phases (each prints its own lines):

1. device — platform, device kind and count, the card's name and power
   limit;
2. kernel parity — the find kernel against brute force on the wavefronts
   of all 4 bounces of a 131,072-path batch on the seeded flagship
   stand-in and on a 150k-triangle terrain; the gather's backward (the
   one-hot matmul for small tables, XLA's scatter-add for large ones) at
   every table shape on the path against a float64 ``np.add.at``;
3. train step — ``make_train_step`` on a one-device mesh: memory analysis,
   a warm-up step and 3 steps at 131,072 paths, 4 bounces, 1280x720; then
   loss and gradients with ``method="auto"`` against ``"bruteforce"``,
   the gradients also per parameter at a random-sign target, beside the
   brute-force step on the host CPU as the witness of float32 rounding;
4. GPU against CPU — the same 4,096 paths traced on the card and on the
   host CPU;
5. frame — a full 1280x720 frame at 16 spp through ``render_accumulate``.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import subprocess
import sys
import time

import numpy as np

PATHS = 131_072          # 32,768 tile pixels x spb 4
SPB = 4
PIXELS = PATHS // SPB
FIND_TIE_RTOL = 1e-5     # ids may differ only where the two t agree
LOSS_RTOL = 1e-5         # auto vs bruteforce: reassociation only
GRAD_RTOL = 1e-4
GATHER_RTOL = 1e-5       # gather backward vs float64 np.add.at
SIGNED_TARGET = 100.0


def say(phase, msg):
    print(f"[{phase}] {msg}", flush=True)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def card_name_and_power():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip()


def median_ms(fn, *args, reps=5):
    """Host-clock median of ``reps`` calls, each waited for (a record)."""
    import jax

    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)) * 1e3


def grad_capture():
    """An optax transformation that applies nothing and keeps the gradient
    in its state, so a train step reports the gradient it computed."""
    import jax
    import jax.numpy as jnp
    import optax

    def init(params):
        return {"g": jax.tree.map(jnp.zeros_like, params)}

    def update(grads, state, params=None):
        return jax.tree.map(jnp.zeros_like, grads), {"g": grads}

    return optax.GradientTransformation(init, update)


def signed_target(n, seed):
    """A target of +-SIGNED_TARGET per pixel and channel, random signs.

    The loss is the mean of (resolved - target)^2 with resolved in [0, 1),
    so its gradient is, to within 1%, a random-sign sum of the per-pixel
    derivatives: no parameter's gradient cancels towards zero, and a wrong
    gradient of a parameter with a small true gradient cannot hide under
    the largest one."""
    signs = np.random.default_rng(seed).choice([-1.0, 1.0], size=(n, 3))
    return (SIGNED_TARGET * signs).astype(np.float32)


def max_abs_diff(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def check_grads(phase, tag, ga, gb, ga_s, gb_s, gw_s):
    """Gradients of two programs that differ only in float32 rounding.

    ``ga``/``gb``: at the real target, checked as max|a - b| over all
    parameters / the largest |b|, at ``GRAD_RTOL``. ``ga_s``/``gb_s``: at
    the random-sign target, checked per parameter as max|a - b| / max|b| of
    that parameter, at ``GRAD_RTOL`` or at the witness ``gw_s`` (the
    reference program compiled for the host CPU), whichever is larger: a
    parameter whose derivative is ill-conditioned in float32 (the radius-
    1000 ground sphere's centre at grazing angles) differs that much
    between any two compilations, and a wrong gradient differs by O(1)."""
    diff = max(max_abs_diff(ga[k], gb[k]) for k in gb)
    scale = max(float(np.max(np.abs(np.asarray(gb[k])))) for k in gb)
    rel_g = diff / max(scale, 1e-30)

    def rel(x, k):
        peak = float(np.max(np.abs(np.asarray(gb_s[k]))))
        d = max_abs_diff(x[k], gb_s[k])
        return d / peak if peak > 0 else (0.0 if d == 0 else np.inf)

    per = {k: (rel(ga_s, k), rel(gw_s, k)) for k in sorted(gb_s)}
    bad = [k for k, (r, w) in per.items() if r > max(GRAD_RTOL, w)]
    say(phase, f"{tag} gradients: max|diff|/max|g| over all parameters "
        f"{rel_g:.3e} (tolerance {GRAD_RTOL}); per parameter at the "
        f"random-sign target, max|diff|/max|g| beside the host-CPU witness "
        f"(tolerance max({GRAD_RTOL}, witness)): "
        + ", ".join(f"{k} {r:.2e} (cpu {w:.2e})"
                    for k, (r, w) in per.items()))
    check(rel_g <= GRAD_RTOL, f"{tag}: gradients differ by {rel_g:.3e}")
    check(not bad, f"{tag}: gradients beyond tolerance: "
          + ", ".join(f"{k} {per[k][0]:.3e}" for k in bad))


def find_parity(tag, scene, org, dir, time_, t_min):
    """Kernel ids must equal brute-force ids except at exact-distance ties."""
    import jax

    from sexy_raytracer_jax.ops.intersect import find_hit, find_hit_bruteforce

    kernel = jax.jit(
        lambda s, o, d, tm, t0: find_hit(s, o, d, tm, t0, method="auto"))
    brute = jax.jit(find_hit_bruteforce)
    args = (scene, org, dir, time_, t_min)
    p_k, t_k = kernel(*args)
    with jax.default_matmul_precision("highest"):
        p_b, t_b = brute(*args)
    p_k, t_k, p_b, t_b = map(np.asarray, (p_k, t_k, p_b, t_b))
    dis = p_k != p_b
    both = np.isfinite(t_k) & np.isfinite(t_b)
    tk, tb = np.where(both, t_k, 0.0), np.where(both, t_b, 0.0)
    tie = both & (np.abs(tk - tb)
                  <= FIND_TIE_RTOL * np.maximum(np.abs(tk), np.abs(tb)))
    bad = int(np.sum(dis & ~tie))
    alive = int(np.sum(np.asarray(t_min) < 1e38))
    say("parity", f"find {tag}: {alive} live rays, {int(np.sum(p_b >= 0))} "
        f"hits, {int(dis.sum())} id differences, {bad} beyond ties "
        f"(tolerance: ids equal unless t agrees within {FIND_TIE_RTOL} rel)"
        f"; kernel {median_ms(kernel, *args):.3f} ms, brute force "
        f"{median_ms(brute, *args):.3f} ms (a record, not a claim)")
    check(bad == 0, f"find {tag}: {bad} id mismatches beyond ties")


def phase_parity(scene, cfg, camera):
    import jax
    import jax.numpy as jnp

    from sexy_raytracer_jax.diff.inverse import sample_tile_ids
    from sexy_raytracer_jax.models import presets
    from sexy_raytracer_jax.render.integrator import bounce_wavefronts
    from sexy_raytracer_jax.render.renderer import (
        camera_rays,
        tile_pixel_order,
    )

    ids = jnp.asarray(sample_tile_ids(np.random.default_rng(0), cfg.width,
                                      cfg.height, PIXELS))
    org, dir, time_, keys, _ = camera_rays(
        camera, ids, jnp.int32(0), jax.random.key(1),
        width=cfg.width, height=cfg.height, spb=SPB,
    )
    bg = jnp.asarray(cfg.background, jnp.float32)
    fronts = jax.jit(
        functools.partial(bounce_wavefronts, max_bounce=cfg.max_bounce)
    )(scene, org, dir, time_, keys, bg)
    for b, (o, d, t_min) in enumerate(fronts):
        find_parity(f"bounce {b}", scene, o, d, time_, t_min)

    # a mesh far larger than the flagship: the kernel reads it from global
    # memory at any size
    big, bcfg = presets.terrain_heightfield(tris=150_000)
    bcam = type(camera).from_config(bcfg.camera, bcfg.aspect)
    # the middle of the frame, where the camera looks down on the terrain
    order = tile_pixel_order(bcfg.width, bcfg.height)
    mid = order.size // 2
    order = jnp.asarray(order[mid - 32768:mid + 32768])
    o, d, tm, _, _ = camera_rays(bcam, order, jnp.int32(0), jax.random.key(2),
                                 width=bcfg.width, height=bcfg.height, spb=1)
    find_parity(f"terrain {big.tri_v0.shape[0]} tris", big, o, d, tm,
                jnp.full((o.shape[0],), 1e-3, jnp.float32))
    gather_parity(scene)


def gather_parity(scene):
    """The gather's backward over a 131,072-path batch at every table shape
    on the path, against a float64 ``np.add.at``."""
    import jax
    import jax.numpy as jnp

    from sexy_raytracer_jax.ops.lookup import SMALL_TABLE_ROWS, table_lookup
    from sexy_raytracer_jax.ops.shade import material_packs

    L, H, W, C = scene.shade_atlas.shape
    tables = [
        ("material", material_packs(scene)[0].shape),
        ("sphere pack", (scene.sph_c0.shape[0], 10)),
        ("triangle pack", (scene.tri_v0.shape[0], 16)),
        ("texture atlas", (L * H * W, C)),
    ]
    rng = np.random.default_rng(5)
    for name, (n, c) in tables:
        idx = rng.integers(0, n, size=PATHS).astype(np.int32)
        idx[: PATHS // 3] = idx[0]     # renders concentrate on few rows
        g = rng.normal(size=(PATHS, c)).astype(np.float32)
        exp = np.zeros((n, c), np.float64)
        np.add.at(exp, idx, g.astype(np.float64))
        args = (jnp.zeros((n, c), jnp.float32), jnp.asarray(idx),
                jnp.asarray(g))
        grad = jax.jit(jax.grad(
            lambda t, i, gg: jnp.sum(table_lookup(t, i) * gg)))
        plain = jax.jit(jax.grad(lambda t, i, gg: jnp.sum(t[i] * gg)))
        out = np.asarray(grad(*args), np.float64)
        scale = float(np.abs(exp).max())
        rel = float(np.max(np.abs(out - exp))) / scale
        ok = np.allclose(out, exp, rtol=GATHER_RTOL, atol=GATHER_RTOL * scale)
        route = ("select-sum + one-hot matmul" if n <= SMALL_TABLE_ROWS
                 else "XLA gather + scatter-add")
        timing = f"{median_ms(grad, *args):.3f} ms"
        if n <= SMALL_TABLE_ROWS:
            timing += f", plain XLA gather {median_ms(plain, *args):.3f} ms"
        say("parity", f"gather backward, {name} [{n}, {c}] x {PATHS} rows "
            f"({route}) vs float64 np.add.at: max|diff|/max|ref| {rel:.3e}, "
            f"within rtol {GATHER_RTOL} + atol {GATHER_RTOL} x max|ref|: "
            f"{ok}; {timing} fwd+bwd (a record, not a claim)")
        check(ok, f"gather backward {name}: beyond tolerance")


def phase_train(scene, cfg, camera):
    import jax
    import jax.numpy as jnp
    import optax

    from sexy_raytracer_jax.diff.inverse import make_train_step, sample_tile_ids
    from sexy_raytracer_jax.diff.params import extract_params
    from sexy_raytracer_jax.parallel.mesh import make_mesh, replicate_scene, shard_rays

    dev = jax.devices()[0]
    mesh = make_mesh(devices=[dev])
    params = extract_params(scene)
    step = make_train_step(mesh, cfg, optax.adam(1e-3), spb=SPB,
                           method="auto", donate_state=True)
    state = step.init(params)
    scene_r = replicate_scene(scene, mesh)
    ids = sample_tile_ids(np.random.default_rng(0), cfg.width, cfg.height,
                          PIXELS)
    pix = shard_rays(jnp.asarray(ids), mesh)
    tgt = shard_rays(jnp.full((PIXELS, 3), 0.5, jnp.float32), mesh)

    t0 = time.time()
    compiled = jax.jit(step).lower(state, scene_r, camera, pix, tgt,
                                   jax.random.key(0)).compile()
    mem = compiled.memory_analysis()
    say("train", f"compiled in {time.time() - t0:.1f} s; memory_analysis: "
        f"arguments {mem.argument_size_in_bytes} B, outputs "
        f"{mem.output_size_in_bytes} B, temporaries "
        f"{mem.temp_size_in_bytes} B, aliased {mem.alias_size_in_bytes} B, "
        f"code {mem.generated_code_size_in_bytes} B")
    state, loss = step(state, scene_r, camera, pix, tgt, jax.random.key(0))
    check(np.isfinite(float(loss)), f"warm-up loss {float(loss)}")
    losses = []
    t0 = time.time()
    for i in range(3):
        state, loss = step(state, scene_r, camera, pix, tgt,
                           jax.random.key(i + 1))
        losses.append(loss)
    jax.block_until_ready(state)
    dt = time.time() - t0
    losses = [float(x) for x in losses]
    check(all(np.isfinite(losses)), f"losses {losses}")
    moved = [k for k in params
             if float(jnp.max(jnp.abs(state.params[k] - params[k]))) > 0.0]
    check(moved, "no parameter moved")
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
    say("train", f"3 steps x {PATHS} paths x {cfg.max_bounce} bounces at "
        f"{cfg.width}x{cfg.height}: losses {losses}, {dt / 3 * 1e3:.1f} ms/"
        f"step (a record, not a claim), moved {sorted(moved)}, "
        f"peak_bytes_in_use {peak}")

    # the kernel path against the plain search, same parameters and keys
    tgt_s_host = signed_target(PIXELS, 8)
    tgt_s = shard_rays(jnp.asarray(tgt_s_host), mesh)
    results = {}
    for method in ("auto", "bruteforce"):
        gstep = make_train_step(mesh, cfg, grad_capture(), spb=SPB,
                                method=method)
        gargs = (gstep.init(params), scene_r, camera, pix, tgt,
                 jax.random.key(7))
        with jax.default_matmul_precision("highest"):
            gstate, gloss = gstep(*gargs)
            ms = median_ms(gstep, *gargs)
            sstate, _ = gstep(gargs[0], scene_r, camera, pix, tgt_s,
                              jax.random.key(7))
        results[method] = (float(gloss), gstate.opt_state["g"],
                           sstate.opt_state["g"])
        say("train", f"method={method}: {ms:.3f} ms/step, median of 5 "
            f"(a record, not a claim)")
    (la, ga, ga_s), (lb, gb, gb_s) = results["auto"], results["bruteforce"]
    rel_loss = abs(la - lb) / max(abs(lb), 1e-30)
    say("train", f"auto vs bruteforce: loss {la!r} vs {lb!r}, rel "
        f"{rel_loss:.3e} (tolerance {LOSS_RTOL})")
    check(rel_loss <= LOSS_RTOL, f"loss differs by {rel_loss:.3e}")
    # the witness: the brute-force step at the signed target on the host
    cpu = jax.devices("cpu")[0]
    cmesh = make_mesh(devices=[cpu])
    wstep = make_train_step(cmesh, cfg, grad_capture(), spb=SPB,
                            method="bruteforce")
    t0 = time.time()
    with jax.default_matmul_precision("highest"):
        wstate, _ = wstep(
            wstep.init(params), replicate_scene(scene, cmesh),
            jax.device_put(camera, cpu), shard_rays(jnp.asarray(ids), cmesh),
            shard_rays(jnp.asarray(tgt_s_host), cmesh),
            jax.device_put(jax.random.key(7), cpu))
        gw_s = jax.device_get(wstate.opt_state["g"])
    say("train", f"host-CPU witness step: {time.time() - t0:.1f} s with "
        f"compilation")
    check_grads("train", "auto vs bruteforce", ga, gb, ga_s, gb_s, gw_s)


def phase_cpu(scene, cfg, camera):
    import jax
    import jax.numpy as jnp

    from sexy_raytracer_jax.diff.inverse import sample_tile_ids
    from sexy_raytracer_jax.render.renderer import render_pixels

    n = 4096
    ids = jnp.asarray(sample_tile_ids(np.random.default_rng(3), cfg.width,
                                      cfg.height, n))
    fn = jax.jit(functools.partial(
        render_pixels, width=cfg.width, height=cfg.height, spb=1,
        spp_total=1, max_bounce=cfg.max_bounce, method="auto",
    ))
    args = (scene, camera, ids, jnp.int32(0), jax.random.key(11),
            jnp.asarray(cfg.background, jnp.float32))
    gpu = np.asarray(fn(*args), np.float64)
    cpu = np.asarray(fn(*jax.device_put(args, jax.devices("cpu")[0])),
                     np.float64)
    mean_g, mean_c = gpu.mean(axis=0), cpu.mean(axis=0)
    rel_mean = float(np.max(np.abs(mean_g - mean_c) / np.abs(mean_c)))
    close = np.all(np.abs(gpu - cpu) <= 1e-4 * np.maximum(np.abs(gpu),
                                                          np.abs(cpu)),
                   axis=1)
    say("cpu", f"{n} paths: mean radiance gpu {mean_g.round(6).tolist()} cpu "
        f"{mean_c.round(6).tolist()}, max rel {rel_mean:.3e} (tolerance 1e-3)"
        f"; {close.mean() * 100:.3f}% of paths within 1e-4 rel (tolerance "
        f"99%: a path may cross a discrete scatter decision on a last-bit "
        f"difference and diverge)")
    check(rel_mean <= 1e-3, f"mean radiance differs by {rel_mean:.3e}")
    check(close.mean() >= 0.99, f"only {close.mean():.4f} of paths agree")


def phase_frame(scene, cfg, card):
    from sexy_raytracer_jax.render.renderer import render_accumulate

    fcfg = dataclasses.replace(cfg, samples_per_pixel=16)
    runs = [("auto", "first (compiles)"), ("auto", "second"),
            ("bruteforce", "first (compiles)"), ("bruteforce", "second")]
    for method, run in runs:
        t0 = time.time()
        accum = render_accumulate(scene, fcfg, method=method)
        dt = time.time() - t0
        check(accum.shape == (cfg.height, cfg.width, 3), accum.shape)
        check(np.isfinite(accum).all(), "non-finite frame")
        say("frame", f"{cfg.width}x{cfg.height} at 16 spp, method={method}, "
            f"{run} run: "
            f"{dt:.2f} s wall on {card} (a record, not a claim); mean "
            f"radiance {(accum.mean(axis=(0, 1)) / 16).round(4).tolist()}")


def run_one_card(devices, card):
    import jax

    from sexy_raytracer_jax.models import presets
    from sexy_raytracer_jax.render.camera import Camera

    scene, cfg = presets.flagship_standin()
    scene = jax.device_put(scene, devices[0])
    camera = Camera.from_config(cfg.camera, cfg.aspect)
    phase_parity(scene, cfg, camera)
    phase_train(scene, cfg, camera)
    phase_cpu(scene, cfg, camera)
    phase_frame(scene, cfg, card)


def run_four_cards(devices):
    """The sharded paths on four cards against device 0 alone: a 256x144
    frame of the stand-in on a 4x1 and on a 2x2 ("rays", "samples") mesh,
    and one train step on the 2x2 mesh, whose gradients are pmean-reduced
    over both axes."""
    import jax
    import jax.numpy as jnp

    from sexy_raytracer_jax.diff.inverse import (
        _loss_fn,
        make_train_step,
        sample_tile_ids,
    )
    from sexy_raytracer_jax.diff.params import extract_params
    from sexy_raytracer_jax.models import presets
    from sexy_raytracer_jax.parallel.mesh import (
        make_mesh,
        replicate_scene,
        shard_rays,
    )
    from sexy_raytracer_jax.parallel.render import render_sharded
    from sexy_raytracer_jax.render.camera import Camera

    check(len(devices) == 4, f"need 4 devices, have {len(devices)}")
    scene, cfg = presets.flagship_standin(height=144, spp=8)
    cfg = dataclasses.replace(cfg, samples_per_batch=4)
    camera = Camera.from_config(cfg.camera, cfg.aspect)
    ref_img = render_sharded(scene, cfg, make_mesh(devices=devices[:1]))
    for n_rays, n_samples in ((4, 1), (2, 2)):
        img = render_sharded(scene, cfg, make_mesh(n_rays, n_samples,
                                                   devices=devices))
        rel = float(np.max(np.abs(img - ref_img))) / float(
            np.max(np.abs(ref_img)))
        say("4-card", f"{n_rays}x{n_samples} frame {cfg.width}x{cfg.height} "
            f"at {cfg.samples_per_pixel} spp vs device 0: max|diff|/max "
            f"{rel:.3e} (tolerance 1e-5)")
        check(rel <= 1e-5, f"{n_rays}x{n_samples} image differs by {rel:.3e}")

    n_samples = 2
    mesh = make_mesh(2, n_samples, devices=devices)
    params = extract_params(scene)
    n_pix = 8192
    ids = jnp.asarray(sample_tile_ids(np.random.default_rng(0), cfg.width,
                                      cfg.height, n_pix))
    tgt = jnp.full((n_pix, 3), 0.5, jnp.float32)
    key = jax.random.key(5)
    tgt_s = jnp.asarray(signed_target(n_pix, 9))
    step = make_train_step(mesh, cfg, grad_capture(), spb=SPB, method="auto")
    state0 = step.init(params)
    scene_r = replicate_scene(scene, mesh)
    mesh_out = []
    for target in (tgt, tgt_s):
        state, loss = step(state0, scene_r, camera, shard_rays(ids, mesh),
                           shard_rays(target, mesh), key)
        mesh_out.append((float(loss), state.opt_state["g"]))
    # device 0 alone: the mean over the sample shards of the full-batch
    # loss, which is what the mesh's pmean computes
    loss_of = jax.jit(jax.value_and_grad(functools.partial(
        _loss_fn, width=cfg.width, height=cfg.height, spb=SPB,
        spp_total=SPB * n_samples, max_bounce=cfg.max_bounce, method="auto",
    )))
    bg = jnp.asarray(cfg.background, jnp.float32)

    def device0(args, target):
        p, sc, cam, i, b = args
        outs = [loss_of(p, sc, cam, i, target, jnp.int32(s * SPB), key, b)
                for s in range(n_samples)]
        return (float(np.mean([float(v) for v, _ in outs])),
                {k: np.mean([np.asarray(g[k]) for _, g in outs], axis=0)
                 for k in params})

    args = (params, scene, camera, ids, bg)
    refs = [device0(args, target) for target in (tgt, tgt_s)]
    # the witness: device 0's program on the host CPU
    cpu = jax.devices("cpu")[0]
    _, gw_s = device0(jax.device_put(args, cpu), jax.device_put(tgt_s, cpu))
    mesh_loss, ref_loss = mesh_out[0][0], refs[0][0]
    rel_loss = abs(mesh_loss - ref_loss) / max(abs(ref_loss), 1e-30)
    say("4-card", f"2x2 train step vs device 0: loss rel {rel_loss:.3e} "
        f"(tolerance {LOSS_RTOL})")
    check(rel_loss <= LOSS_RTOL, f"2x2 loss differs by {rel_loss:.3e}")
    check_grads("4-card", "2x2 train step vs device 0", mesh_out[0][1],
                refs[0][1], mesh_out[1][1], refs[1][1], gw_s)


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--chips", type=int, choices=(1, 4), default=1,
                        help="4 runs only the sharded four-card phase")
    args = parser.parse_args(argv)

    import jax

    devices = jax.devices()
    dev = devices[0]
    say("device", f"platform {dev.platform}, kind {dev.device_kind!r}, "
        f"count {len(devices)}")
    if dev.platform != "gpu":
        print("chip_smoke: no GPU found; this test runs only on the card",
              file=sys.stderr)
        return 1
    card = card_name_and_power()
    say("device", f"nvidia-smi name, power.limit: {card}")
    print(card, flush=True)

    if args.chips == 4:
        run_four_cards(devices)
    else:
        run_one_card(devices, card)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
