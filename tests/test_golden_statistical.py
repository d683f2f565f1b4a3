"""Per-pixel statistical parity vs the reference binary (VERDICT r3 #5).

Renders the SAME 426x240 flagship config at matched spp in both renderers:

  * ``tests/reforacle/reforacle`` — the reference's own headers compiled
    unmodified (driver restates main.cpp; UB resolved golden-consistently
    by zero-initialised operator new, see driver.cpp),
  * this framework on CPU (bruteforce path; identical math to the
    GPU kernel, tests/test_pallas_find.py).

Comparison is per-pixel in LINEAR radiance with a z-test: the two
renderers use different RNGs (mt19937 vs threefry), so pixel values are
independent Monte-Carlo estimates of the same integral. Our per-pixel
variance is estimated from K independent sample batches; the reference's
estimator has the same per-sample variance, and its 8-bit quantisation
adds q^2/12. Pixels at the clamp (mirror reflections of the
250-intensity light, color.h:20-22) are excluded — their means are
censored.

Known tail (documented, bounded, not hidden): the reference's triangle
hit ignores tMax (model.h:128-129), so where several front-facing chief
surfaces overlap, its visible surface is the LAST in BVH traversal order
rather than the closest (we return the true closest; ops/intersect.py).
This affects a small fraction of chief-silhouette pixels and bounds the
permitted |z| tail below.

Oracle calibration on the table (ADVICE r4): the reforacle shim defaults
glTF metallic/roughness factors to 0.0 — the reference's vendored-cgltf-era
behavior, NOT the glTF 2.0 spec's 1.0 — because only that default
reproduces the checked-in goldens. A/B region deltas (VALIDATION.md §4):
with roughness=1 the chief gains an untinted GGX lobe and renders
+8..12/255 brighter/bluer than BOTH goldens; with roughness=0 the torso
red channel matches the golden to 0.1/255. The framework's loader uses the
same 0 default, so this test compares two renderers sharing one documented,
golden-verified calibration rather than a co-invented one.
"""

import os
import subprocess

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REFORACLE = os.path.join(HERE, "reforacle", "reforacle")
GLTF = "/root/reference/data/masterchief2-separate-xf.gltf"
REF_CWD = "/root/reference/images"  # '../data/' texture prefix must resolve

W, H = 426, 240
SPP = 64
SPB = 8  # our K = SPP/SPB independent batches for the variance estimate


@pytest.fixture(scope="module")
def reforacle_linear():
    if not (os.path.exists(REFORACLE) and os.path.exists(GLTF)
            and os.path.isdir(REF_CWD)):
        pytest.skip("reforacle binary or reference assets unavailable")
    out = f"/tmp/reforacle_stat_{SPP}.png"
    if not os.path.exists(out):
        subprocess.run(
            [REFORACLE, str(W), str(H), str(SPP), "4", out, GLTF],
            cwd=REF_CWD, check=True, timeout=600,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
    from sexy_raytracer_jax.utils.png import read_png

    png = read_png(out, 3).astype(np.float64)
    # invert the resolve: png = floor(256 * clamp(sqrt(mean), 0, 0.999));
    # bin midpoint in linear space + quantisation variance
    lo = (png / 256.0) ** 2
    hi = ((png + 1.0) / 256.0) ** 2
    return 0.5 * (lo + hi), ((hi - lo) ** 2) / 12.0, png


@pytest.fixture(scope="module")
def ours_batches(data_dir):
    from sexy_raytracer_jax.models import presets
    from sexy_raytracer_jax.render.camera import Camera
    from sexy_raytracer_jax.render.renderer import render_chunk

    scene, cfg = presets.masterchief(data_dir=data_dir, height=H)
    cam = Camera.from_config(cfg.camera, cfg.aspect)
    bg = jnp.asarray(cfg.background, jnp.float32)
    pid_all = np.arange(W * H, dtype=np.int32)
    batches = np.zeros((SPP // SPB, W * H, 3), np.float32)
    chunk = 16384
    key = jax.random.key(cfg.seed)
    for start in range(0, W * H, chunk):
        ids = pid_all[start:start + chunk]
        n = ids.shape[0]
        if n < chunk:
            ids = np.pad(ids, (0, chunk - n))
        ids_dev = jnp.asarray(ids)
        for k in range(SPP // SPB):
            out = render_chunk(
                scene, cam, ids_dev, jnp.int32(k * SPB), key, bg,
                width=W, height=H, spb=SPB, spp_total=SPP,
                max_bounce=cfg.max_bounce, method="bruteforce",
            )
            batches[k, start:start + n] = np.asarray(out)[:n]
    return batches.reshape(SPP // SPB, H, W, 3) / SPB


def test_per_pixel_statistical_parity(reforacle_linear, ours_batches):
    ref_mean, ref_qvar, ref_png = reforacle_linear
    K = ours_batches.shape[0]
    our_mean = ours_batches.mean(axis=0).astype(np.float64)
    var_batch = ours_batches.var(axis=0, ddof=1).astype(np.float64)

    # censored pixels at the 8-bit clamp (mirror reflections of the light)
    clamped = (ref_png >= 255) | (np.sqrt(np.maximum(our_mean, 0)) >= 0.999)

    # ---- per-pixel median |z| --------------------------------------
    # The per-pixel z TAIL is useless under this integrand's heavy tails:
    # a single 250-intensity firefly sample in either render shifts a
    # pixel mean by up to ~4 linear units while the 64-sample empirical
    # variance sees nothing (measured: the raw tail is ~6% at |z|>5,
    # all isolated speckle). The MEDIAN is tail-robust and pins any
    # systematic shading difference.
    denom = np.sqrt(2.0 * var_batch / K + ref_qvar + 1e-12)
    z_pix = np.abs(our_mean - ref_mean) / denom
    med_pix = float(np.median(z_pix[~clamped]))
    assert med_pix < 1.1, f"pixel median |z| {med_pix} — systematic diff"

    # ---- 8x8-block z-test ------------------------------------------
    # Block aggregation (4096 samples/block) brings the firefly rate into
    # CLT territory and the batch-block variance estimate actually
    # observes them. Measured on today's renders: median 1.27,
    # frac>5 1.9%, frac>8 0.5%; residual tail sources are (a) fireflies
    # still rarer than 1/4096, (b) grazing-angle precision noise on the
    # r=1000 ground sphere near the horizon (f32 cancellation in the
    # quadratic differs per implementation), (c) the reference's
    # ignores-tMax triangle quirk on chief-silhouette pixels
    # (model.h:128-129; we return the true closest hit). Bars carry
    # ~2x margin over measurement.
    BS = 8
    Hb, Wb = H // BS, W // BS

    def blocks(x, red=np.mean):
        return red(x[:Hb * BS, :Wb * BS].reshape(Hb, BS, Wb, BS, 3),
                   axis=(1, 3))

    bad = blocks(clamped.astype(float), np.max) > 0
    ref_b = blocks(ref_mean)
    our_b = blocks(our_mean)
    # quantization error treated as FULLY CORRELATED within a block
    # (no /64): in smooth or constant regions (sky) every pixel of a
    # block quantizes with the same error, so dividing the q^2/12 term
    # by the block size understated the denominator up to 8x and blew
    # zero-variance sky blocks to |z| ~ 12 from a 0.5% bin-midpoint
    # offset (round-5 Shirley calibration). Conservative for genuinely
    # independent errors; the per-pixel median still uses the full term.
    qvar_b = blocks(ref_qvar)
    bb = ours_batches[:, :Hb * BS, :Wb * BS].reshape(
        K, Hb, BS, Wb, BS, 3
    ).mean(axis=(2, 4)).astype(np.float64)
    var_bb = bb.var(axis=0, ddof=1) / K
    z_b = np.where(
        bad, 0.0,
        np.abs(our_b - ref_b) / np.sqrt(2.0 * var_bb + qvar_b + 1e-12),
    )
    zv = z_b[~bad]
    assert float(np.median(zv)) < 2.0, f"block median |z| {np.median(zv)}"
    assert float((z_b > 5.0).mean()) < 0.04, (
        f"frac block |z|>5 = {(z_b > 5.0).mean()}"
    )
    assert float((z_b > 8.0).mean()) < 0.015, (
        f"frac block |z|>8 = {(z_b > 8.0).mean()}"
    )

    # ---- region means in linear space (clamp-censored) -------------
    # Measured agreement is <= 0.002 on every region incl. the magenta
    # iron sentinel; tolerances carry ~3x margin.
    cm = ~clamped
    for name, (r0, r1, c0, c1), tol in [
        ("sky", (0, 50, 0, 426), 0.004),
        ("ground_right", (200, 236, 300, 424), 0.006),
        ("chief_torso", (66, 110, 193, 233), 0.006),
        ("chief_legs", (143, 200, 193, 233), 0.008),
        ("iron_sentinel", (150, 200, 55, 130), 0.006),
    ]:
        sel = cm[r0:r1, c0:c1]
        m_o = np.where(sel, our_mean[r0:r1, c0:c1], 0).sum((0, 1))
        m_r = np.where(sel, ref_mean[r0:r1, c0:c1], 0).sum((0, 1))
        n = np.maximum(sel.sum((0, 1)), 1)
        d = np.abs(m_o - m_r) / n
        assert d.max() < tol, f"{name}: |mean diff| {d}"
