"""Gamma-centroid MEA structure estimator in plain JAX.

Re-design of `/root/reference/src/centroid_fold.rs:25-105`:

* the O(n^3) max-expected-accuracy fill runs on device as the same
  anti-diagonal wavefront used by the McCaskill scans (max-plus semiring:
  per-span vectorized candidates + a masked N-wide max for the bifurcation),
  vmappable over the gamma grid so the reference CLI's 18-gamma fan-out
  (bin/centroid_fold.rs:148-161) is one batched call on one BPP matrix;
* the traceback (centroid_fold.rs:66-102) re-derives choices by float
  equality and is inherently sequential — it runs on host NumPy over the
  device-produced float32 fill, recomputing candidates with the exact same
  float32 expressions so the equality tests match the reference semantics.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..constants import NEG_INF
from ..ops import diag

# Reference CLI gamma grid: 2^-7 .. 2^10 (bin/centroid_fold.rs:9-10,148-161).
MIN_POW_2 = -7
MAX_POW_2 = 10
DEFAULT_GAMMAS = tuple(float(2.0 ** k) for k in range(MIN_POW_2, MAX_POW_2 + 1))


def _col(M, d):
    return lax.dynamic_slice(M, (0, jnp.maximum(d, 0)), (M.shape[0], 1))[:, 0]


def _shift_up(v, fill):
    return jnp.concatenate([v[1:], jnp.full((1,), fill, v.dtype)])


def _left_from_square(B, N):
    """left[i, d] = B[i, i + d] (zero where i + d >= N)."""
    i = jnp.arange(N)[:, None]
    dd = jnp.arange(N)[None, :]
    j = jnp.clip(i + dd, 0, N - 1)
    vals = jnp.take_along_axis(B, jnp.broadcast_to(j, B.shape), axis=1)
    return jnp.where(i + dd < N, vals, 0.0)


def _square_from_left(P, N, fill=0.0):
    i = jnp.arange(N)[:, None]
    j = jnp.arange(N)[None, :]
    dd = jnp.clip(j - i, 0, N - 1)
    vals = jnp.take_along_axis(P, jnp.broadcast_to(dd, P.shape), axis=1)
    return jnp.where(j >= i, vals, fill)


@partial(jax.jit, static_argnames=("N",))
def mea_fill(bpp, gamma, N):
    """Max-expected-accuracy fill (centroid_fold.rs:35-64) -> square (N, N) f32.

    ``bpp`` is the dense square BPP matrix from mccaskill_bpp. The candidate
    expressions reproduce the reference float32 evaluation order exactly so
    the host traceback's equality re-derivation holds bit-for-bit.
    """
    bpp_left = _left_from_square(bpp, N)
    gamma = jnp.float32(gamma)
    t_idx = jnp.arange(N)[None, :]

    def step(carry, d):
        P, Q = carry
        c1 = _shift_up(_col(P, d - 1), 0.0)        # M[i+1][j]
        c2 = _col(P, d - 1)                        # M[i][j-1]
        p = _col(bpp_left, d)
        m_in = _shift_up(_col(P, d - 2), 0.0)      # M[i+1][j-1]
        c3 = jnp.where(p > 0.0, (m_in + gamma * p) - 1.0, NEG_INF)
        R = diag.reverse_cols_at(diag.shift_rows(Q, d), d - 1, limit=d - 1)
        terms = jnp.where((t_idx >= 1) & (t_idx <= d - 1), P + R, NEG_INF)
        c4 = jnp.max(terms, axis=1)
        m_new = jnp.maximum(jnp.maximum(c1, c2), jnp.maximum(c3, c4))
        m_new = jnp.where(d == 0, 0.0, m_new)
        P = diag.write_col(P, d, m_new)
        Q = diag.write_col(Q, d, diag.left_to_right_col(m_new, d))
        return (P, Q), None

    P0 = jnp.zeros((N, N), dtype=jnp.float32)
    Q0 = jnp.full((N, N), NEG_INF, dtype=jnp.float32)
    (P, _), _ = lax.scan(step, (P0, Q0), jnp.arange(N))
    return _square_from_left(P, N, 0.0)


@partial(jax.jit, static_argnames=("N",))
def mea_fill_gammas(bpp, gammas, N):
    """vmap over the gamma grid: (N, N) bpp + (G,) gammas -> (G, N, N) fills."""
    return jax.vmap(lambda g: mea_fill(bpp, g, N=N))(gammas)


def traceback(M, bpp, gamma, n):
    """Stack traceback by float-equality re-derivation (centroid_fold.rs:66-102).

    Host pass over the device float32 fill; candidate order and float32
    expressions mirror the reference exactly.  Returns (pairs, expect_accuracy).
    Uses the native C kernel (native/rna_algos_native.c) when built; the
    NumPy path below is the reference fallback.
    """
    from .._native import native

    M = np.asarray(M, dtype=np.float32)
    bpp = np.asarray(bpp, dtype=np.float32)
    if (
        native is not None
        and M.ndim == 2
        and M.shape[0] == M.shape[1]
        and M.flags.c_contiguous
    ):
        bppc = np.ascontiguousarray(bpp, dtype=np.float32)
        pairs = native.traceback(M, bppc, M.shape[1], int(n), float(gamma))
        return pairs, float(M[0, n - 1])
    gamma = np.float32(gamma)
    one = np.float32(1.0)
    pairs = []
    stack = [(0, n - 1)]
    while stack:
        i, j = stack.pop()
        if j <= i:
            continue
        m = M[i, j]
        if m == np.float32(0.0):
            continue
        if m == M[i + 1, j]:
            stack.append((i + 1, j))
        elif m == M[i, j - 1]:
            stack.append((i, j - 1))
        elif bpp[i, j] > 0.0 and m == np.float32(
            (M[i + 1, j - 1] + gamma * bpp[i, j]) - one
        ):
            stack.append((i + 1, j - 1))
            pairs.append((i, j))
        else:
            for k in range(i + 1, j):
                if m == np.float32(M[i, k] + M[k + 1, j]):
                    stack.append((i, k))
                    stack.append((k + 1, j))
                    break
    return pairs, float(M[0, n - 1])


def centroid_fold(bpp, n, gamma, N=None):
    """Full gamma-centroid estimate from a dense BPP matrix.

    Mirrors centroid_fold<T> (centroid_fold.rs:25-105): device fill + host
    traceback.  Returns (sorted basepair list, expected accuracy).
    """
    bpp = jnp.asarray(bpp)
    if N is None:
        N = bpp.shape[0]
    M = np.asarray(mea_fill(bpp, gamma, N=N))
    return traceback(M, np.asarray(bpp), gamma, n)
