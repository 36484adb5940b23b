"""Durbin 3-state pair-HMM posterior match probabilities in plain JAX.

Re-design of `/root/reference/src/durbin_algo.rs:73-242`:

* the O(n·m) forward/backward fills become a `lax.scan` over rows with each
  row fully vectorized; the within-row delete recurrence
  ``D[j] = ins[j] + lse(a[j], D[j-1] + ext)`` is a first-order linear
  recurrence in the (logsumexp, +) semiring and runs as a
  `lax.associative_scan` (log-depth);
* the backward pass reuses the *same* row scan on coordinate-reversed
  sequences: the reference's "ends_sum -> 0" initialization
  (durbin_algo.rs:150-155) is exactly the forward recurrence with the two
  init scores set to 0;
* all shapes are static; true lengths (n1, n2) are traced scalars, so the
  kernel vmaps over padded batches of pairs.

Sequences must carry PSEUDO_BASE sentinels at both ends, as the reference CLI
does (bin/durbin_algo.rs:49-50); score tables carry a zero PSEUDO row so the
sentinel lanes are score-neutral.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..constants import NEG_INF, PSEUDO_BASE
from ..numerics import lse_pair, expf, get_mode, force_mode


def _lse3(a, b, c):
    return lse_pair(lse_pair(a, b), c)


def _shift_right(v, fill=NEG_INF):
    return jnp.concatenate([jnp.full((1,), fill, v.dtype), v[:-1]])


def _linrec_lse(b, c):
    """x[j] = lse(b[j], c[j] + x[j-1]) via associative scan."""

    def combine(l, r):
        cl, bl = l
        cr, br = r
        return cl + cr, lse_pair(br, cr + bl)

    _, x = lax.associative_scan(combine, (c, b))
    return x


def _pairhmm_rows(x1, x2, n1, n2, sc, N1, N2, init_match, init_insert):
    """Row-scan fill of (M, I, D) for i in [0, n1-1), j in [0, n2-1).

    M[0,0] = 0; the begins-sum special cases use ``init_match``/``init_insert``
    (forward: durbin_algo.rs:92-98,109-116,125-131; backward reversal passes 0).
    """
    m2m = sc["match2match_score"]
    m2i = sc["match2insert_score"]
    ext = sc["insert_extend_score"]
    MS = sc["match_scores"]
    INS = sc["insert_scores"]
    ins2 = INS[x2]  # (N2,)
    jj = jnp.arange(N2)

    def step(carry, i):
        fm_p, fi_p, fd_p = carry
        row_ok = i < n1 - 1
        valid_j = (jj < n2 - 1) & row_ok
        x1i = jnp.take(x1, jnp.minimum(i, N1 - 1), mode="clip")
        ms = MS[x1i, x2]

        # match: from (i-1, j-1)
        begins_m = (i == 1) & (jj == 1)
        tm = _lse3(
            _shift_right(fm_p) + jnp.where(begins_m, init_match, m2m),
            _shift_right(fi_p) + m2i,
            _shift_right(fd_p) + m2i,
        )
        fm = jnp.where((i >= 1) & (jj >= 1) & valid_j, tm + ms, NEG_INF)
        fm = jnp.where((i == 0) & (jj == 0) & row_ok, 0.0, fm)

        # insert (gap in seq2): from (i-1, j)
        begins_i = (i == 1) & (jj == 0)
        ti = lse_pair(
            fm_p + jnp.where(begins_i, init_insert, m2i),
            fi_p + ext,
        )
        fi = jnp.where((i >= 1) & valid_j, ti + INS[x1i], NEG_INF)

        # delete (gap in seq1): within-row linear recurrence
        begins_d = (i == 0) & (jj == 1)
        a = _shift_right(fm) + jnp.where(begins_d, init_insert, m2i)
        b = jnp.where((jj >= 1) & valid_j, a + ins2, NEG_INF)
        c = jnp.where((jj >= 1) & valid_j, ext + ins2, NEG_INF)
        fd = _linrec_lse(b, c)

        return (fm, fi, fd), (fm, fi, fd)

    neg = jnp.full((N2,), NEG_INF, dtype=jnp.float32)
    _, (FM, FI, FD) = lax.scan(step, (neg, neg, neg), jnp.arange(N1))
    return FM, FI, FD


def _reverse2d(M, n1, n2, N1, N2, fill=NEG_INF):
    """R[i, j] = M[n1-1-i, n2-1-j] inside the valid box, fill outside."""
    i = jnp.arange(N1)[:, None]
    j = jnp.arange(N2)[None, :]
    ri = jnp.clip(n1 - 1 - i, 0, N1 - 1)
    rj = jnp.clip(n2 - 1 - j, 0, N2 - 1)
    out = M[ri, rj]
    return jnp.where((i < n1) & (j < n2), out, fill)


def durbin_match_probs(seq1, n1, seq2, n2, sc, N1, N2):
    return _durbin_match_probs(
        seq1, n1, seq2, n2, sc, N1=N1, N2=N2, mode=get_mode()
    )


@partial(jax.jit, static_argnames=("N1", "N2", "mode"))
def _durbin_match_probs(seq1, n1, seq2, n2, sc, N1, N2, mode):
    with force_mode(mode):
        return _durbin_match_probs_body(seq1, n1, seq2, n2, sc, N1, N2)


def _durbin_match_probs_body(seq1, n1, seq2, n2, sc, N1, N2):
    """Posterior match probabilities for one sentinel-wrapped padded pair.

    Args:
      seq1/seq2: (N1,)/(N2,) int32, PSEUDO_BASE sentinels at positions 0 and
        n-1, PSEUDO_BASE padding beyond n.
      n1/n2: traced true lengths (including both sentinels).
      sc: build_align_scores() pytree.

    Returns:
      (N1, N2) float32 probs; zero outside [1, n1-2] x [1, n2-2]
      (durbin_algo.rs:201-242).
    """
    FM, FI, FD = _pairhmm_rows(
        seq1, seq2, n1, n2, sc, N1, N2,
        sc["init_match_score"], sc["init_insert_score"],
    )
    # backward = forward on reversed coordinates with zero init scores
    x1r = jnp.where(
        jnp.arange(N1) < n1,
        jnp.take(seq1, jnp.clip(n1 - 1 - jnp.arange(N1), 0, N1 - 1)),
        PSEUDO_BASE,
    )
    x2r = jnp.where(
        jnp.arange(N2) < n2,
        jnp.take(seq2, jnp.clip(n2 - 1 - jnp.arange(N2), 0, N2 - 1)),
        PSEUDO_BASE,
    )
    RM, RI, RD = _pairhmm_rows(x1r, x2r, n1, n2, sc, N1, N2, 0.0, 0.0)
    BM = _reverse2d(RM, n1, n2, N1, N2)
    BI = _reverse2d(RI, n1, n2, N1, N2)
    BD = _reverse2d(RD, n1, n2, N1, N2)

    def shift11(M):
        out = jnp.full_like(M, NEG_INF)
        return out.at[:-1, :-1].set(M[1:, 1:])

    BM1, BI1, BD1 = shift11(BM), shift11(BI), shift11(BD)

    i = jnp.arange(N1)[:, None]
    j = jnp.arange(N2)[None, :]
    m2m = sc["match2match_score"]
    m2i = sc["match2insert_score"]
    ends = (i + 1 == n1 - 1) & (j + 1 == n2 - 1)
    ssum = _lse3(
        BM1 + jnp.where(ends, 0.0, m2m),
        m2i + BI1,
        m2i + BD1,
    )
    corner = (jnp.maximum(n1 - 2, 0), jnp.maximum(n2 - 2, 0))
    z = _lse3(
        lax.dynamic_slice(FM, corner, (1, 1))[0, 0],
        lax.dynamic_slice(FI, corner, (1, 1))[0, 0],
        lax.dynamic_slice(FD, corner, (1, 1))[0, 0],
    )
    p = expf(FM + ssum - z)
    inner = (i >= 1) & (i <= n1 - 2) & (j >= 1) & (j <= n2 - 2)
    return jnp.where(inner, p, 0.0)


def durbin_match_probs_batch(seqs1, ns1, seqs2, ns2, sc, N1, N2):
    """vmapped over a batch of pairs: (B, N1), (B,), (B, N2), (B,) -> (B, N1, N2)."""
    return _durbin_match_probs_batch(
        seqs1, ns1, seqs2, ns2, sc, N1=N1, N2=N2, mode=get_mode()
    )


@partial(jax.jit, static_argnames=("N1", "N2", "mode"))
def _durbin_match_probs_batch(seqs1, ns1, seqs2, ns2, sc, N1, N2, mode):
    with force_mode(mode):
        def one(s1, n1, s2, n2):
            return _durbin_match_probs_body(s1, n1, s2, n2, sc, N1, N2)

        return jax.vmap(one)(seqs1, ns1, seqs2, ns2)
