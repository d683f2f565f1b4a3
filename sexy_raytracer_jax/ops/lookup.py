"""Row gathers from small tables with a select-sum forward and a one-hot
matmul backward.

``table_lookup(table, idx)`` is ``table[idx]``. For tables of at most
``SMALL_TABLE_ROWS`` rows (the material and sphere tables) the forward is a
select-sum over rows (idx == m picks row m) and the backward a one-hot
matmul (dTable = onehot^T @ g) instead of autodiff's scatter-add; both
measured faster than the plain gather on the H100 (PERF.md). Larger tables
use the plain gather and its scatter-add.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# tables of at most this many rows take the select-sum forward (bit-exact:
# multiplies by 0/1 only; out-of-range idx yields row 0 like the clamped
# gathers the callers build) and the one-hot backward
SMALL_TABLE_ROWS = 16


def table_lookup(table, idx):
    """``table[idx]``: [N, K], [R] int32 -> [R, K]; idx must be in-range."""
    if table.shape[0] > SMALL_TABLE_ROWS:
        return table[idx]
    return _lookup(table.shape[0], table, idx)


@functools.partial(jax.custom_vjp, nondiff_argnums=(0,))
def _lookup(n_rows, table, idx):
    out = jnp.broadcast_to(table[0], (idx.shape[0], table.shape[1]))
    sel = idx[:, None]
    for m in range(1, n_rows):
        out = jnp.where(sel == m, table[m], out)
    return out


def _fwd(n_rows, table, idx):
    return _lookup(n_rows, table, idx), idx


def _bwd(n_rows, idx, g):
    onehot = jax.nn.one_hot(idx, n_rows, dtype=jnp.float32)     # [R, N]
    dtable = jax.lax.dot_general(
        onehot,
        g.astype(jnp.float32),
        dimension_numbers=(((0,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=jnp.float32,
    )
    return dtable.astype(g.dtype), None


_lookup.defvjp(_fwd, _bwd)
