#!/usr/bin/env python
"""Flagship 720p render (VERDICT r2 #5): the reference's primary deliverable.

Renders the Master Chief scene at 1280x720 with checkpoint/resume on the
GPU, writes the full PNG + a 360p downsample into artifacts/flagship/, and
compares full-image region statistics against the reference golden
images/test-5kx720p.png (VALIDATION.md tolerances; the iron-sphere region
is excluded — its textures are absent from data/, reference texture.h:131).

    python tools/run_flagship_render.py --spp 1000
"""

import argparse
import dataclasses
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ART = os.path.join(REPO, "artifacts", "flagship")
GOLDEN = "/root/reference/images/test-5kx720p.png"

# 240p region map (tests/test_golden.py) scaled x3 to 720p; tolerances on
# LINEAR region means (golden squared), chief looser per VALIDATION.md §4
REGIONS = {
    "sky": ((0, 150), (0, 300), 0.01),
    "ground_right": ((600, 708), (900, 1272), 0.015),
    "metal_sphere": ((435, 540), (870, 1080), 0.03),
    "chief_torso": ((198, 330), (579, 699), 0.05),
    "chief_legs": ((429, 600), (579, 699), 0.05),
}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--spp", type=int, default=1000)
    ap.add_argument("--method", default="auto")
    args = ap.parse_args()
    os.makedirs(ART, exist_ok=True)

    import jax
    import numpy as np

    from sexy_raytracer_jax.models import presets
    from sexy_raytracer_jax.render.renderer import render_accumulate
    from sexy_raytracer_jax.utils import color as colorlib
    from sexy_raytracer_jax.utils.png import read_png, write_png

    scene, cfg = presets.masterchief(height=720, spp=args.spp)
    # batch samples: one compiled dispatch per 4 samples of a pixel chunk
    cfg = dataclasses.replace(cfg, samples_per_batch=4)

    print(f"rendering 1280x720 @ {args.spp} spp ({args.method})...", flush=True)
    t0 = time.time()
    accum = render_accumulate(
        scene, cfg, method=args.method, progress=True,
        checkpoint=os.path.join(ART, "checkpoint.npz"),
    )
    wall = time.time() - t0
    print(f"done in {wall:.1f}s", flush=True)

    resolved = np.asarray(colorlib.resolve(accum, args.spp))
    img = np.asarray(colorlib.to_uint8(resolved))
    write_png(os.path.join(ART, f"render_720p_{args.spp}spp.png"), img)
    write_png(os.path.join(ART, "render_360p.png"), img[::2, ::2])

    report = {"spp": args.spp, "method": args.method,
              "wall_s": round(wall, 1),
              "mpaths_per_s": round(1280 * 720 * args.spp / wall / 1e6, 3)}
    golden = read_png(GOLDEN, 3)
    if golden is not None:
        g = golden.astype(np.float64) / 255.0
        lin_ours = np.clip(accum / args.spp, 0.0, 0.998)
        failures = []
        for name, (rows, cols, tol) in REGIONS.items():
            ours = lin_ours[rows[0]:rows[1], cols[0]:cols[1]].mean(axis=(0, 1))
            ref = (g[rows[0]:rows[1], cols[0]:cols[1]] ** 2).mean(axis=(0, 1))
            err = float(np.abs(ours - ref).max())
            report[f"region_{name}"] = {
                "ours": [round(float(x), 4) for x in ours],
                "golden": [round(float(x), 4) for x in ref],
                "max_err": round(err, 4),
                "tol": tol,
                "pass": bool(err <= tol),
            }
            if err > tol:
                failures.append(name)
        report["regions_pass"] = not failures
        report["regions_failed"] = failures
    with open(os.path.join(ART, "report.json"), "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))


if __name__ == "__main__":
    main()
