"""Per-sample RNG key derivation: no collisions at the flagship config.

Round-1 bug (VERDICT): ``uid = pid * spp + sid`` in int32 overflows at
1280x720x5000spp (max uid 4.6e9 > 2^32), aliasing ~7% of sample keys.
The two-level (pixel, sample) fold-in keys every pair distinctly.
"""

import jax
import jax.numpy as jnp
import numpy as np

from sexy_raytracer_jax.utils import rng


def _key_data(keys):
    return np.asarray(jax.vmap(jax.random.key_data)(keys))


def test_flagship_config_no_aliasing():
    """Pairs that collide under flat int32 uid get distinct keys."""
    W, H, spp = 1280, 720, 5000
    base = jax.random.key(0)
    rng_np = np.random.default_rng(7)
    pid = rng_np.integers(0, W * H, size=4096).astype(np.int64)
    sid = rng_np.integers(0, spp, size=4096).astype(np.int64)
    uid = pid * spp + sid
    # construct flat-uid collisions: uid2 = uid + 2^32 maps to a valid
    # (pid2, sid2) pair whenever it stays inside the grid
    uid2 = uid + 2**32
    ok = uid2 < W * H * spp
    pid2, sid2 = uid2 // spp, uid2 % spp
    assert ok.sum() > 100  # the overflow regime is actually reachable

    k1 = rng.ray_keys_2d(base, jnp.asarray(pid[ok], jnp.int32),
                         jnp.asarray(sid[ok], jnp.int32))
    k2 = rng.ray_keys_2d(base, jnp.asarray(pid2[ok], jnp.int32),
                         jnp.asarray(sid2[ok], jnp.int32))
    d1, d2 = _key_data(k1), _key_data(k2)
    # flat int32 uids would alias exactly; 2-level fold-in must not
    assert not np.any(np.all(d1 == d2, axis=-1))


def test_keys_unique_within_pixel_and_across_pixels():
    base = jax.random.key(3)
    pid = jnp.repeat(jnp.arange(64, dtype=jnp.int32), 32)
    sid = jnp.tile(jnp.arange(32, dtype=jnp.int32), 64)
    data = _key_data(rng.ray_keys_2d(base, pid, sid))
    uniq = np.unique(data.reshape(data.shape[0], -1), axis=0)
    assert uniq.shape[0] == data.shape[0]


def test_sharded_overshoot_no_collision():
    """sid >= spp (sharded overshoot) must not collide with other pixels."""
    base = jax.random.key(1)
    spp = 16
    # pixel 0 with overshoot sample ids vs pixel 1's normal range
    k_over = rng.ray_keys_2d(
        base, jnp.zeros((spp,), jnp.int32),
        spp + jnp.arange(spp, dtype=jnp.int32),
    )
    k_next = rng.ray_keys_2d(
        base, jnp.ones((spp,), jnp.int32), jnp.arange(spp, dtype=jnp.int32)
    )
    d = np.concatenate([_key_data(k_over), _key_data(k_next)])
    uniq = np.unique(d.reshape(d.shape[0], -1), axis=0)
    assert uniq.shape[0] == d.shape[0]
