"""In-framework profiling: throughput counters.

The reference's only observability is a stderr scanline counter
(main.cpp:201). Here rendering/training entry points report structured
throughput (rays/s, paths/s, wall-clock) through ``Meter``.

JAX returns before the device finishes, so ``Meter.step`` waits for the
value it is given (``sync()``, i.e. ``block_until_ready``) before it stops
the clock.
"""

from __future__ import annotations

import contextlib
import json
import time
from dataclasses import dataclass, field

import jax


def sync(value=None) -> None:
    """Wait until every array of ``value`` (any pytree) is computed."""
    if value is not None:
        jax.block_until_ready(value)


@dataclass
class Meter:
    """Accumulating throughput meter for render/train loops.

    >>> m = Meter("render")
    >>> with m.step(paths=131072, bounces=4) as s: out = fn(); s.value = out
    >>> print(m.report())
    """

    name: str
    paths: int = 0
    rays: int = 0
    seconds: float = 0.0
    steps: int = 0
    _t0: float = field(default=0.0, repr=False)

    @contextlib.contextmanager
    def step(self, paths: int, bounces: int = 1):
        class _S:
            value = None

        s = _S()
        t0 = time.time()
        yield s
        sync(s.value)
        self.seconds += time.time() - t0
        self.paths += paths
        self.rays += paths * bounces
        self.steps += 1

    @property
    def mrays_per_s(self) -> float:
        return self.rays / max(self.seconds, 1e-9) / 1e6

    @property
    def mpaths_per_s(self) -> float:
        return self.paths / max(self.seconds, 1e-9) / 1e6

    def report(self) -> str:
        return json.dumps(
            {
                "meter": self.name,
                "steps": self.steps,
                "seconds": round(self.seconds, 3),
                "mpaths_per_s": round(self.mpaths_per_s, 3),
                "mrays_per_s": round(self.mrays_per_s, 3),
            }
        )
