"""Worker process for the multi-process jax.distributed CI test.

Launched by tests/test_distributed.py: N OS processes x 2 local CPU devices
each form one global mesh (localhost coordinator). Each process feeds only
its *local* shard of the ray batch through
``jax.make_array_from_process_local_data`` (parallel/mesh.py
host_to_global) — the real multi-host data path (VERDICT r3 missing #1:
``device_put`` of host-global arrays cannot work when remote devices are
non-addressable).

Prints per-step losses and a sharded-render checksum; the parent asserts
they agree across processes and match its own single-process run of the
identical global batch.
"""

import os
import sys


def main() -> int:
    pid = int(sys.argv[1])
    nproc = int(sys.argv[2])
    port = sys.argv[3]

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

    import jax

    jax.config.update("jax_platforms", "cpu")

    from sexy_raytracer_jax.parallel.mesh import init_distributed

    init_distributed(
        coordinator=f"localhost:{port}", num_processes=nproc, process_id=pid
    )
    assert jax.process_count() == nproc, jax.process_count()

    import jax.numpy as jnp
    import numpy as np
    import optax

    from sexy_raytracer_jax.diff.inverse import TrainState, make_train_step
    from sexy_raytracer_jax.diff.params import extract_params
    from sexy_raytracer_jax.models import SceneBuilder
    from sexy_raytracer_jax.parallel.mesh import (
        RAY_AXIS,
        make_mesh,
        replicate_scene,
        shard_rays,
    )
    from sexy_raytracer_jax.parallel.render import make_sharded_chunk_fn
    from sexy_raytracer_jax.render.camera import Camera
    from sexy_raytracer_jax.utils.config import CameraConfig, RenderConfig

    # same tiny scene/config as tests/test_parallel.py
    b = SceneBuilder()
    checker = b.add_checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9))
    b.add_sphere((0, -1000, 0), 1000.0, b.add_pbr_material(albedo_tex=checker))
    b.add_sphere((-2, 1, 0), 1.0, b.add_light_material(color=(10, 9, 7)))
    b.add_sphere((2, 1, 0), 1.0, b.add_metal_material((0.7, 0.6, 0.5), 0.0))
    mat = b.add_pbr_material(base_color=(0.9, 0.3, 0.3, 1.0))
    b.add_mesh([[-1, 0, -2], [1, 0, -2], [0, 2, -2]], None, [[0, 1, 2]], mat)
    scene = b.build(build_bvh=False)
    cfg = RenderConfig(
        width=32, height=24, samples_per_pixel=8, max_bounce=3,
        rays_per_chunk=256, samples_per_batch=4,
        camera=CameraConfig(eye=(0, 2, 6), look_at=(0, 1, 0),
                            vfov_degrees=45.0, aperture=0.0, focus_dist=6.0),
    )
    camera = Camera.from_config(cfg.camera, cfg.aspect)

    n_dev = len(jax.devices())
    mesh = make_mesh(n_rays=n_dev // 2, n_samples=2)
    n_ray_shards = mesh.shape[RAY_AXIS]

    # cheap warm-up collective FIRST: it compiles in seconds, so both
    # processes align here before the minutes-long train-step compile —
    # otherwise the faster process reaches the first real collective
    # while the other is still compiling and Gloo's 30 s key-value
    # exchange times out (observed under CPU contention)
    from jax.sharding import NamedSharding, PartitionSpec as P

    probe = jax.make_array_from_process_local_data(
        NamedSharding(mesh, P(RAY_AXIS)),
        np.full((2,), 1.0, np.float32),
    )
    total = jax.jit(
        lambda a: jnp.sum(a), out_shardings=NamedSharding(mesh, P())
    )(probe)
    assert float(total) == float(nproc * 2)

    scene_r = replicate_scene(scene, mesh)

    # global batch, identical in every process; each feeds its local slice
    ids_global = np.arange(128, dtype=np.int32) % (cfg.width * cfg.height)
    tgt_global = np.full((128, 3), 0.4, np.float32)
    per_proc = 128 // nproc
    lo, hi = pid * per_proc, (pid + 1) * per_proc
    ids = shard_rays(ids_global[lo:hi], mesh)
    tgt = shard_rays(tgt_global[lo:hi], mesh)

    params = extract_params(scene)
    optimizer = optax.adam(1e-3)
    state = TrainState(params, optimizer.init(params), jnp.int32(0))
    step = make_train_step(mesh, cfg, optimizer, spb=2, method="bruteforce")
    for i in range(2):
        state, loss = step(state, scene_r, camera, ids, tgt, jax.random.key(7))
        print(f"LOSS {i} {float(loss):.9f}", flush=True)

    # sharded forward render through the same host_to_global path
    fn = make_sharded_chunk_fn(
        mesh, width=cfg.width, height=cfg.height, spb=2,
        spp_total=cfg.samples_per_pixel, max_bounce=cfg.max_bounce,
        method="bruteforce",
    )
    camera_r = jax.tree.map(
        lambda a: host_to_global_cam(a, mesh), camera
    )
    out = fn(scene_r, camera_r, ids, jnp.int32(0), jax.random.key(3),
             jnp.asarray(cfg.background, jnp.float32))
    # per-process view of the fully-computed global output: gather the
    # addressable shards and checksum the local slice
    local = np.concatenate(
        [np.asarray(s.data) for s in sorted(
            out.addressable_shards, key=lambda s: s.index[0].start or 0)]
    )
    print(f"RSUM {float(np.float64(local.sum())):.6f}", flush=True)
    return 0


def host_to_global_cam(a, mesh):
    from jax.sharding import PartitionSpec as P

    from sexy_raytracer_jax.parallel.mesh import host_to_global

    return host_to_global(a, mesh, P())


if __name__ == "__main__":
    sys.exit(main())
