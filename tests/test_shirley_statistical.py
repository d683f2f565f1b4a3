"""Per-pixel statistical parity vs the reference binary on the SHIRLEY
random-sphere field (VERDICT r4 missing #1 / next #4).

The masterchief statistical test (tests/test_golden_statistical.py)
exercises none of: dielectric glass (reference main.cpp:124 keeps it
commented), metal fuzz (the flagship mirror has fuzz 0), moving spheres
(motion blur), or aperture blur on near/far geometry. This test renders
the seeded Shirley field — the reference's own commented branch
(main.cpp:92-122) restated in tests/reforacle/driver.cpp — in BOTH
renderers and compares with the same z-test machinery:

  * reforacle builds the field from a 64-bit LCG (driver.cpp) that
    presets.shirley_parity() reproduces bit-for-bit, so the two renderers
    trace the SAME spheres/materials;
  * per-pixel means are independent Monte-Carlo estimates (mt19937 vs
    threefry); our variance comes from K independent sample batches; the
    reference's adds quantisation variance q^2/12.

Sampled-material caveat: dielectric's reflect-vs-refract choice and metal
fuzz draw per-sample randomness, so pixel distributions are heavy-tailed
where glass focuses the light — handled like the golden test: median for
systematics, block aggregation for tails.
"""

import os
import subprocess

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REFORACLE = os.path.join(HERE, "reforacle", "reforacle")

W, H = 320, 180
SPP = 48
SPB = 8  # K = SPP/SPB independent batches for the variance estimate
SEED = 42


@pytest.fixture(scope="module")
def reforacle_linear():
    if not os.path.exists(REFORACLE):
        pytest.skip("reforacle binary unavailable")
    out = f"/tmp/reforacle_shirley_{W}x{H}_{SPP}.png"
    if not os.path.exists(out):
        subprocess.run(
            [REFORACLE, str(W), str(H), str(SPP), "4", out, "shirley",
             str(SEED)],
            cwd="/tmp", check=True, timeout=1200,
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
        )
    from sexy_raytracer_jax.utils.png import read_png

    png = read_png(out, 3).astype(np.float64)
    lo = (png / 256.0) ** 2
    hi = ((png + 1.0) / 256.0) ** 2
    return 0.5 * (lo + hi), ((hi - lo) ** 2) / 12.0, png


@pytest.fixture(scope="module")
def ours_batches():
    from sexy_raytracer_jax.models import presets
    from sexy_raytracer_jax.render.camera import Camera
    from sexy_raytracer_jax.render.renderer import render_chunk

    scene, cfg = presets.shirley_parity(seed=SEED, spp=SPP, height=H)
    import dataclasses

    cfg = dataclasses.replace(cfg, width=W, height=H)
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


def test_shirley_statistical_parity(reforacle_linear, ours_batches):
    ref_mean, ref_qvar, ref_png = reforacle_linear
    K = ours_batches.shape[0]
    our_mean = ours_batches.mean(axis=0).astype(np.float64)
    var_batch = ours_batches.var(axis=0, ddof=1).astype(np.float64)

    clamped = (ref_png >= 255) | (np.sqrt(np.maximum(our_mean, 0)) >= 0.999)

    # per-pixel median |z|: pins any systematic shading difference in the
    # dielectric / fuzzy-metal / motion-blur / DoF paths
    denom = np.sqrt(2.0 * var_batch / K + ref_qvar + 1e-12)
    z_pix = np.abs(our_mean - ref_mean) / denom
    med_pix = float(np.median(z_pix[~clamped]))
    assert med_pix < 1.1, f"pixel median |z| {med_pix} — systematic diff"

    # 8x8-block z-test (tail control under glass-caustic fireflies)
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

    # region means in linear space (clamp-censored): sky / field / the
    # three hero spheres' band / near-field DoF blur zone
    cm = ~clamped
    for name, (r0, r1, c0, c1), tol in [
        ("sky", (0, 40, 0, W), 0.006),
        ("far_field", (75, 95, 40, 280), 0.008),
        ("hero_band", (60, 110, 100, 220), 0.010),
        ("near_ground", (140, 180, 0, W), 0.008),
    ]:
        sel = cm[r0:r1, c0:c1]
        m_o = np.where(sel, our_mean[r0:r1, c0:c1], 0).sum((0, 1))
        m_r = np.where(sel, ref_mean[r0:r1, c0:c1], 0).sum((0, 1))
        n = np.maximum(sel.sum((0, 1)), 1)
        d = np.abs(m_o / n - m_r / n)
        assert (d < tol).all(), f"region {name}: |mean diff| {d} >= {tol}"
