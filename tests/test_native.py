"""Native C++ BVH builder vs the numpy oracle: bit-identical trees."""

import numpy as np
import pytest

from sexy_raytracer_jax.models.bvh import build_bvh_numpy, validate_bvh
from sexy_raytracer_jax.native import bvh_native


@pytest.mark.skipif(not bvh_native.available(), reason="no native toolchain")
@pytest.mark.parametrize("n", [1, 2, 7, 128, 3042])
def test_native_matches_numpy(n, rng_np):
    centers = rng_np.normal(size=(n, 3)).astype(np.float32) * 10
    half = (0.01 + rng_np.random((n, 3)).astype(np.float32)) * 2
    pmin = centers - half
    pmax = centers + half
    a = build_bvh_numpy(pmin, pmax)
    b = bvh_native.build(pmin, pmax)
    np.testing.assert_array_equal(a.left, b.left)
    np.testing.assert_array_equal(a.right, b.right)
    np.testing.assert_array_equal(a.node_min, b.node_min)
    np.testing.assert_array_equal(a.node_max, b.node_max)
    validate_bvh(b, pmin, pmax)


@pytest.mark.skipif(not bvh_native.available(), reason="no native toolchain")
def test_native_speed_sanity():
    """The native builder handles a large scene quickly (it exists for
    million-primitive scenes where numpy's per-node argsort dominates)."""
    import time

    rng = np.random.default_rng(0)
    n = 200_000
    centers = rng.normal(size=(n, 3)).astype(np.float32) * 100
    pmin = centers - 0.5
    pmax = centers + 0.5
    t0 = time.time()
    bvh = bvh_native.build(pmin, pmax)
    dt = time.time() - t0
    assert bvh.left.shape[0] == 2 * n - 1
    assert dt < 10.0, f"native build too slow: {dt:.1f}s"
