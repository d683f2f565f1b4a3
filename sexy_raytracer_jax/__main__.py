"""CLI: render the BASELINE preset scenes / run inverse rendering.

The reference is reconfigured by editing constants in main.cpp
(reference README.md:33, main.cpp:60-80,175-180); here the same knobs are
flags over the preset registry.

Examples:
    python -m sexy_raytracer_jax render --preset standin --spp 100 \
        --height 360 --out test.png
    python -m sexy_raytracer_jax render --preset shirley
    python -m sexy_raytracer_jax inverse --preset masterchief \
        --target /root/reference/images/test-5kx720p.png --steps 200
    python -m sexy_raytracer_jax bench
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time


def _add_render_args(p):
    p.add_argument("--preset", default="standin",
                   help="standin | shirley | cube | rustediron | masterchief "
                        "(all but standin and shirley read reference assets)")
    p.add_argument("--data-dir", default=None)
    p.add_argument("--spp", type=int, default=None)
    p.add_argument("--height", type=int, default=None)
    p.add_argument("--max-bounce", type=int, default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--method", default="auto",
                   help="hit search: auto | pallas | bruteforce | bvh")
    p.add_argument("--samples-per-batch", type=int, default=None)


def _build(args):
    from sexy_raytracer_jax.models import presets

    if args.preset not in presets.PRESETS:
        raise SystemExit(
            f"unknown preset {args.preset!r}; available: "
            + ", ".join(sorted(presets.PRESETS))
        )
    kwargs = {}
    if args.data_dir and args.preset not in ("shirley", "standin"):
        kwargs["data_dir"] = args.data_dir
    if args.spp:
        kwargs["spp"] = args.spp
    if args.height:
        kwargs["height"] = args.height
    scene, cfg = presets.PRESETS[args.preset](**kwargs)
    updates = {}
    if args.max_bounce:
        updates["max_bounce"] = args.max_bounce
    if args.seed is not None:
        updates["seed"] = args.seed
    if args.samples_per_batch:
        updates["samples_per_batch"] = args.samples_per_batch
    if updates:
        cfg = dataclasses.replace(cfg, **updates)
    return scene, cfg


def cmd_render(args):
    from sexy_raytracer_jax.render.renderer import render_image
    from sexy_raytracer_jax.utils.png import write_png

    scene, cfg = _build(args)
    print(
        f"rendering {args.preset}: {cfg.width}x{cfg.height}, "
        f"{cfg.samples_per_pixel} spp, {cfg.max_bounce} bounces, "
        f"{scene.num_triangles} tris, {scene.num_spheres} spheres",
        file=sys.stderr,
    )
    t0 = time.time()
    img = render_image(
        scene, cfg, method=args.method, progress=True,
        checkpoint=args.checkpoint,
    )
    dt = time.time() - t0
    paths = cfg.width * cfg.height * cfg.samples_per_pixel
    print(
        f"done in {dt:.1f}s — {paths / dt / 1e6:.2f} Mpaths/s "
        f"({paths * cfg.max_bounce / dt / 1e6:.1f} Mray-casts/s)",
        file=sys.stderr,
    )
    write_png(args.out, img)
    print(f"wrote {args.out}", file=sys.stderr)


def cmd_inverse(args):
    import numpy as np

    from sexy_raytracer_jax.diff.inverse import inverse_render
    from sexy_raytracer_jax.utils.png import read_png, write_png
    from sexy_raytracer_jax.render.renderer import render_image

    scene, cfg = _build(args)
    target = read_png(args.target, channels=3)
    if target is None:
        print(f"cannot read target {args.target}", file=sys.stderr)
        return 1
    if target.shape[:2] != (cfg.height, cfg.width):
        print(
            f"target is {target.shape[1]}x{target.shape[0]}, "
            f"render is {cfg.width}x{cfg.height}",
            file=sys.stderr,
        )
        return 1
    target_f = target.astype(np.float32) / 255.0
    scene_opt, losses = inverse_render(
        scene, target_f, cfg,
        n_steps=args.steps,
        pixels_per_step=args.pixels_per_step,
        spb=args.spb,
        learning_rate=args.lr,
        method=args.method,
    )
    print(
        f"loss: first {losses[0]:.6f}, "
        f"min {min(losses):.6f}, last {losses[-1]:.6f} "
        f"({len(losses)} steps)",
        file=sys.stderr,
    )
    if args.losses_out:
        import json

        with open(args.losses_out, "w") as f:
            json.dump(losses, f)
        print(f"wrote {args.losses_out}", file=sys.stderr)
    if args.out:
        preview = render_image(
            scene_opt,
            dataclasses.replace(cfg, samples_per_pixel=args.preview_spp),
            method=args.method,
        )
        write_png(args.out, preview)
        print(f"wrote {args.out}", file=sys.stderr)
    return 0


def cmd_bench(args):
    import bench

    return bench.main()


def main(argv=None):
    parser = argparse.ArgumentParser(prog="sexy_raytracer_jax")
    sub = parser.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render a preset scene to PNG")
    _add_render_args(p)
    p.add_argument("--out", default="test.png")
    p.add_argument("--checkpoint", default=None,
                   help="npz checkpoint path for resumable renders")
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("inverse", help="inverse rendering against a target")
    _add_render_args(p)
    p.add_argument("--target", required=True)
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--pixels-per-step", type=int, default=4096)
    p.add_argument("--spb", type=int, default=4)
    p.add_argument("--lr", type=float, default=3e-3)
    p.add_argument("--out", default=None)
    p.add_argument("--preview-spp", type=int, default=64)
    p.add_argument("--losses-out", default=None,
                   help="write the per-step loss curve as JSON")
    p.set_defaults(fn=cmd_inverse)

    p = sub.add_parser("bench", help="run the headline benchmark")
    p.set_defaults(fn=cmd_bench)

    args = parser.parse_args(argv)
    return args.fn(args) or 0


if __name__ == "__main__":
    sys.exit(main())
