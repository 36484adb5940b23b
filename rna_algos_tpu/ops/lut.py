"""Small-table lookups for the per-sequence score-matrix precompute.

The precompute reads tiny tables (5..5^4 entries) at every (i, d) cell.
``lookup`` is a plain gather: exact on every platform, with no matrix
product whose precision the compiler could lower.
"""

import jax.numpy as jnp


def lookup(table, *idx):
    """table[idx_0, ..., idx_k] with all idx broadcast to a common shape."""
    table = jnp.asarray(table)
    if table.ndim != len(idx):
        raise ValueError(
            f"lookup: {len(idx)} index arrays for a {table.ndim}-d table"
        )
    return table[tuple(jnp.asarray(x) for x in idx)]
