"""Diagonal-layout access utilities for anti-diagonal wavefront DP.

The reference fills triangular DP tables cell-by-cell in span-major order
(`/root/reference/src/mccaskill_algo.rs:290-292`).  This formulation keeps
every state table dense and *diagonal-addressable* so that one `lax.scan` step
updates a whole anti-diagonal with static shapes:

* left layout  ``P[i, d] = state(i, i + d)``  — row ``i`` holds everything
  anchored at left end ``i`` (contiguous reads of ``ext[i][k-1]``-style terms),
* right layout ``Q[j, d] = state(j - d, j)`` — row ``j`` holds everything
  anchored at right end ``j`` (contiguous reads of ``rm[k][j]``-style terms).

All helpers here are shape-static: dynamic span offsets go through
`lax.dynamic_slice` on padded buffers, never through dynamic shapes, so the
whole DP compiles to one XLA program per (bucket, model).
"""

import jax.numpy as jnp
from jax import lax

from ..constants import NEG_INF

# 2-loop window extent: loop lengths 0..30 on each side (MAX_2LOOP_LEN /
# MAX_LOOP_LEN = 30 in both parameter sets, mccaskill_algo.rs:306-315,412-420).
WINDOW = 31
# Row/column padding margins sized so every window/diag access stays in-bounds.
_ROW_PAD = WINDOW + 2
_COL_PAD = 2 * WINDOW + 4


def pad_table(M, fill=NEG_INF):
    """Embed (N, N) table in a padded buffer for window/diag reads.

    Returns a ((N + 2*_ROW_PAD), (N + 2*_COL_PAD)) buffer with M at offset
    (_ROW_PAD, _COL_PAD).
    """
    return jnp.pad(
        M,
        ((_ROW_PAD, _ROW_PAD), (_COL_PAD, _COL_PAD)),
        constant_values=fill,
    )


def write_col_padded(Mpad, col, values):
    """Write a diagonal column into a pad_table buffer (carry tables padded
    across scan steps so window reads need no per-step re-padding)."""
    return lax.dynamic_update_slice(
        Mpad, values[:, None], (_ROW_PAD, _COL_PAD + col)
    )


def unpad_table(Mpad, N):
    return Mpad[_ROW_PAD : _ROW_PAD + N, _COL_PAD : _COL_PAD + N]


def window_gather(Mpad, row_off, row_sign, col_off, col_sign, N):
    """W[i, a, b] = M[i + row_off + row_sign*a, col_off + col_sign*(a+b)].

    ``Mpad`` must come from :func:`pad_table`.  ``a, b`` range over
    ``[0, WINDOW)``; out-of-range cells read the pad fill.  ``col_off`` may be
    a traced scalar (the span offset); everything else is static.

    This is the 2-loop window read (mccaskill_algo.rs:306-315 inner loops):
    the (k, l) double loop becomes one static gather from a dynamic slice.
    """
    W = WINDOW
    m_max = 2 * W - 2  # max a+b
    row_lo = row_off if row_sign > 0 else row_off - (W - 1)
    col_lo = col_off if col_sign > 0 else col_off - m_max
    S = lax.dynamic_slice(
        Mpad,
        (_ROW_PAD + row_lo, _COL_PAD + col_lo),
        (N + W - 1, m_max + 1),
    )
    a = jnp.arange(W)
    b = jnp.arange(W)
    i = jnp.arange(N)
    rows = i[:, None, None] + (a if row_sign > 0 else (W - 1 - a))[None, :, None]
    cols = (a[:, None] + b[None, :]) if col_sign > 0 else (m_max - a[:, None] - b[None, :])
    return S[rows, cols[None, :, :]]


def shift_rows(M, shift, fill=NEG_INF):
    """A[i, :] = M[i + shift, :] for traced ``shift`` in [0, N]; OOB rows = fill."""
    N = M.shape[0]
    buf = jnp.concatenate([M, jnp.full_like(M, fill)], axis=0)
    return lax.dynamic_slice(buf, (shift, 0), (N, M.shape[1]))


def reverse_cols_at(M, d, fill=NEG_INF, limit=None):
    """R[i, t] = M[i, d - t] for traced ``d``; t > d (or t > limit) -> fill.

    Used to turn right-layout row reads ``Q[j, d - t]`` into a t-contiguous
    term matrix for the O(span) bifurcation reductions.
    """
    N, C = M.shape
    fA = jnp.flip(M, axis=1)  # fA[i, c] = M[i, C-1-c]
    buf = jnp.concatenate([fA, jnp.full_like(fA, fill)], axis=1)
    R = lax.dynamic_slice(buf, (0, (C - 1) - d), (N, C))
    t = jnp.arange(C)[None, :]
    return jnp.where(t <= (d if limit is None else jnp.minimum(d, limit)), R, fill)


def shift_cols_left(M, k=1, fill=NEG_INF):
    """B[i, t] = M[i, t - k] (static k >= 1); t < k -> fill."""
    N, C = M.shape
    pad = jnp.full((N, k), fill, dtype=M.dtype)
    return jnp.concatenate([pad, M[:, : C - k]], axis=1)


def roll_cols_at(M, d, fill=NEG_INF):
    """R[i, t] = M[i, d + t] for traced ``d``; d + t >= C -> fill."""
    N, C = M.shape
    buf = jnp.concatenate([M, jnp.full_like(M, fill)], axis=1)
    return lax.dynamic_slice(buf, (0, d), (N, C))


def write_col(M, col, values):
    """M[:, col] = values with traced ``col`` (dynamic_update_slice)."""
    return lax.dynamic_update_slice(M, values[:, None], (0, col))


def left_to_right_col(values, d, fill=NEG_INF):
    """Convert a diagonal vector v[i] = state(i, i+d) to right layout rows.

    Returns w with w[j] = state(j - d, j) = v[j - d]; rows j < d get fill.
    """
    N = values.shape[0]
    buf = jnp.concatenate([jnp.full((N,), fill, dtype=values.dtype), values])
    w = lax.dynamic_slice(buf, (N - d,), (N,))
    return jnp.where(jnp.arange(N) >= d, w, fill)
