"""The one place that chooses an implementation by platform.

Two platforms are supported:

* ``cuda`` (an NVIDIA GPU): hand-written kernels compiled for the card,
  Pallas through its Triton route;
* ``cpu``: plain XLA code, and Pallas kernels in interpret mode — for
  tests only.

The choice is made when a computation is *lowered*, not when it is traced
(``jax.lax.platform_dependent``), so one process can run the same function
on the card and on its host CPU and each gets its own implementation.
Lowering for any other platform raises. Nothing here ever falls back from
a kernel to a reference on the card, and interpret mode is reachable only
from the ``cpu`` branch.

The dispatched branches see stop-gradient operands: kernels behind this
switch are index searches with no derivative.
"""

from __future__ import annotations

import jax


def by_platform(*args, gpu, cpu):
    """``gpu(*args)`` when lowered for CUDA, ``cpu(*args)`` for the CPU."""
    args = jax.tree.map(jax.lax.stop_gradient, args)
    return jax.lax.platform_dependent(*args, cuda=gpu, cpu=cpu)
