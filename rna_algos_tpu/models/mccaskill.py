"""McCaskill partition-function DP (Turner 2004 + CONTRAfold v2.02) in plain JAX.

Re-design of `/root/reference/src/mccaskill_algo.rs:247-723` as anti-diagonal
wavefront scans:

* every state table is dense (N, N) float32 in *left layout* ``P[i, d] =
  state(i, i+d)`` (plus a *right layout* copy ``Q[j, d] = state(j-d, j)`` for
  the two tables read by right-end: the rightmost-basepair sums);
* one `lax.scan` step processes a whole anti-diagonal: the sparse-hashmap
  pair states of the reference become -inf-masked dense lanes, the bounded
  (k, l) 2-loop double loop (mccaskill_algo.rs:306-315) becomes a static
  (N, 31, 31) window gather + tree-LSE, and the O(span) bifurcation loops
  (mccaskill_algo.rs:344-375) become masked N-wide tree-LSE reductions;
* the rightmost-basepair sums are built *incrementally* across spans
  (``rm[i, j] = lse(rm[i, j-1] (+unpair), acc[i, j] (+bp))``) which matches
  the reference's fresh k-ascending stream exactly up to float re-association;
* the outside pass (mccaskill_algo.rs:518-723) is the mirrored span-decreasing
  scan over log outside sums and the two multibranch-context tables, with the
  final ``expf`` into probability space.

All shapes static; ``n`` (true length) is a traced scalar so the whole thing
vmaps over a padded batch and pjits over a data mesh.  This one scan is the
only implementation and runs unchanged on every platform XLA compiles for.

Numerics tiers (``numerics.get_mode()``, part of every jit key): "exact"
(default) and "parity" both evaluate the reference's piecewise-cubic
log-sum-exp; "fast" uses hardware ``logaddexp``/``exp``.
"""

from functools import partial

import jax
import jax.numpy as jnp
from jax import lax

from ..constants import (
    MIN_SPAN_HAIRPIN_CLOSE,
    NEG_INF,
)
from ..numerics import lse_pair, lse_reduce, expf, get_mode, force_mode
from ..ops import diag
from ..ops import scores as S


def _col(M, d):
    return lax.dynamic_slice(M, (0, jnp.maximum(d, 0)), (M.shape[0], 1))[:, 0]


def _shift_up(v, k=1, fill=NEG_INF):
    return jnp.concatenate([v[k:], jnp.full((k,), fill, v.dtype)])


def _skew_left_to_right(P, fill=NEG_INF):
    """Q[r, c] = P[r - c, c] (state(r-c, r)); rows r < c get fill."""
    N = P.shape[0]
    r = jnp.arange(N)[:, None]
    c = jnp.arange(N)[None, :]
    rows = jnp.clip(r - c, 0, N - 1)
    vals = jnp.take_along_axis(P, jnp.broadcast_to(rows, P.shape), axis=0)
    # take_along_axis indexes rows per column: need P[rows[r,c], c]
    return jnp.where(r >= c, vals, fill)


def _square_from_left(P, n, N, fill=0.0):
    """square[i, j] = P[i, j - i] for j >= i and j < n, else fill."""
    i = jnp.arange(N)[:, None]
    j = jnp.arange(N)[None, :]
    dd = jnp.clip(j - i, 0, N - 1)
    vals = jnp.take_along_axis(P, jnp.broadcast_to(dd, P.shape), axis=1)
    return jnp.where((j >= i) & (j < n), vals, fill)


# ---------------------------------------------------------------------------
# Inside pass
# ---------------------------------------------------------------------------

def _inside(seq, n, N, tbl, pre, contra, allows_short_hairpins):
    """Span-increasing wavefront; returns the inside state pytree.

    Mirrors get_fold_sums / get_fold_sums_contra (mccaskill_algo.rs:282-516).
    """
    i_idx = jnp.arange(N)
    neg = jnp.full((N, N), NEG_INF, dtype=jnp.float32)
    state = {
        # close is carried in padded form: the 2-loop window reads it every
        # step, and re-padding per step would re-materialize the buffer
        "P_close_pad": diag.pad_table(neg),
        "P_rm": neg,
        "P_ext": jnp.zeros((N, N), dtype=jnp.float32),
        "P_mb": neg,
        "P_one": neg,
        "Q_rm": neg,
    }
    if contra:
        state["P_rmmb"] = neg
        state["Q_rmmb"] = neg
        ext_unpair = tbl["external_score_unpair"]
        ext_bp = tbl["external_score_basepair"]
        mb_unpair = tbl["multibranch_score_unpair"]
        mb_bp = tbl["multibranch_score_basepair"]

    H, MBC, ACC, canon = pre["H"], pre["MBC"], pre["ACC"], pre["canon"]

    def step(st, d):
        span = d + 1

        # --- close (pair-anchored ensembles) ---
        if contra:
            TL = S.twoloop_inside_contra(seq, tbl, pre, d, N)
        else:
            TL = S.twoloop_inside_turner(seq, tbl, pre, d, N)
        Wc = diag.window_gather(st["P_close_pad"], 1, +1, d - 2, -1, N)
        two = lse_reduce((Wc + TL).reshape(N, -1), axis=1)
        mb_in = jnp.where(d >= 2, _shift_up(_col(st["P_mb"], d - 2)), NEG_INF)
        mb_term = mb_in + _col(MBC, d)
        close_new = lse_pair(lse_pair(_col(H, d), two), mb_term)
        span_ok = (span >= MIN_SPAN_HAIRPIN_CLOSE) | (
            jnp.bool_(allows_short_hairpins and contra) & (span >= 2)
        )
        close_new = jnp.where(_col(canon, d) & span_ok, close_new, NEG_INF)
        acc_new = close_new + _col(ACC, d)

        # --- rightmost-basepair sums (incremental across spans) ---
        prev_rm = jnp.where(d >= 1, _col(st["P_rm"], d - 1), NEG_INF)
        if contra:
            rm_new = lse_pair(prev_rm + ext_unpair, acc_new + ext_bp)
            prev_rmmb = jnp.where(d >= 1, _col(st["P_rmmb"], d - 1), NEG_INF)
            rmmb_new = lse_pair(prev_rmmb + mb_unpair, acc_new + mb_bp)
        else:
            rm_new = lse_pair(prev_rm, acc_new)

        Q_rm = diag.write_col(st["Q_rm"], d, diag.left_to_right_col(rm_new, d))
        if contra:
            Q_rmmb = diag.write_col(
                st["Q_rmmb"], d, diag.left_to_right_col(rmmb_new, d)
            )

        # --- external ensemble: k-bifurcation over t = k - i in [0, span-1) ---
        Qrow = diag.reverse_cols_at(diag.shift_rows(Q_rm, d), d, limit=d - 1)
        terms = Qrow + diag.shift_cols_left(st["P_ext"], 1, 0.0)
        base = ext_unpair * span.astype(jnp.float32) if contra else 0.0
        ext_new = lse_pair(jnp.full((N,), 0.0) + base, lse_reduce(terms, axis=1))

        # --- multibranch / one-or-more: t = k - i in [1, span-2] ---
        t_idx = jnp.arange(N)[None, :]
        mask_t = (t_idx >= 1) & (t_idx <= d - 1)
        if contra:
            Qrow_mb = diag.reverse_cols_at(diag.shift_rows(Q_rmmb, d), d, limit=d - 1)
            x = jnp.where(mask_t, Qrow_mb, NEG_INF)
            s1 = lse_pair(
                rmmb_new,
                lse_reduce(x + mb_unpair * t_idx.astype(jnp.float32), axis=1),
            )
        else:
            coeff = tbl["coeff_num_branches"]
            x = jnp.where(mask_t, Qrow + coeff, NEG_INF)
            s1 = lse_pair(rm_new + coeff, lse_reduce(x, axis=1))
        s2 = lse_reduce(diag.shift_cols_left(st["P_one"], 1) + x, axis=1)
        mb_new = s2
        one_new = lse_pair(s1, s2)

        new = {
            "P_close_pad": diag.write_col_padded(st["P_close_pad"], d, close_new),
            "P_rm": diag.write_col(st["P_rm"], d, rm_new),
            "P_ext": diag.write_col(st["P_ext"], d, ext_new),
            "P_mb": diag.write_col(st["P_mb"], d, mb_new),
            "P_one": diag.write_col(st["P_one"], d, one_new),
            "Q_rm": Q_rm,
        }
        if contra:
            new["P_rmmb"] = diag.write_col(st["P_rmmb"], d, rmmb_new)
            new["Q_rmmb"] = Q_rmmb
        return new, None

    state, _ = lax.scan(step, state, jnp.arange(N))
    state["P_close"] = diag.unpad_table(state["P_close_pad"], N)
    return state


# ---------------------------------------------------------------------------
# Outside pass
# ---------------------------------------------------------------------------

def _outside(seq, n, N, tbl, pre, inside, contra, allows_short_hairpins):
    """Span-decreasing wavefront; returns log outside-weighted pair sums.

    Mirrors get_basepair_probs{,_contra} (mccaskill_algo.rs:518-723).
    """
    P_close = inside["P_close"]
    P_one = inside["P_one"]
    P_ext = inside["P_ext"]
    Q_one = _skew_left_to_right(P_one)
    P_close_pad = diag.pad_table(P_close)
    MBC, ACC = pre["MBC"], pre["ACC"]

    i_vec = jnp.arange(N)
    extL = P_ext[0, :]  # ext(0, p)
    extR = jnp.where(
        i_vec <= n - 1,
        jnp.take_along_axis(
            P_ext, jnp.clip(n - 1 - i_vec, 0, N - 1)[:, None], axis=1
        )[:, 0],
        0.0,
    )  # ext(p, n-1)
    global_sum = extR[0]

    if contra:
        mb_unpair = tbl["multibranch_score_unpair"]
        mb_bp = tbl["multibranch_score_basepair"]
        ext_bp = tbl["external_score_basepair"]
        min_span = 2 if allows_short_hairpins else MIN_SPAN_HAIRPIN_CLOSE
    else:
        coeff = tbl["coeff_num_branches"]
        min_span = MIN_SPAN_HAIRPIN_CLOSE

    neg = jnp.full((N, N), NEG_INF, dtype=jnp.float32)
    state = {"P_bppo_pad": diag.pad_table(neg), "Q_pm": neg, "Q_pm2": neg}
    t_idx = jnp.arange(N)[None, :].astype(jnp.float32)
    t_int = jnp.arange(N)[None, :]

    def step(st, d):
        span = d + 1
        j = i_vec + d
        span_valid = span >= min_span

        # --- pm / pm2: k > j context (mccaskill_algo.rs:542-555,643-659) ---
        P_bppo = diag.unpad_table(st["P_bppo_pad"], N)
        G = jnp.where(
            jnp.isfinite(P_close), P_bppo + MBC - P_close, NEG_INF
        )
        Xr = diag.roll_cols_at(G, d)  # Xr[i, t] = G[i, d+t], t = k - j
        S_one = diag.shift_cols_left(diag.shift_rows(P_one, d + 1), 2)
        pm_terms = jnp.where(t_int >= 1, Xr + S_one, NEG_INF)
        pm_new = lse_reduce(pm_terms, axis=1)
        if contra:
            pm2_terms = jnp.where(t_int >= 1, Xr + mb_unpair * (t_idx - 1.0), NEG_INF)
        else:
            pm2_terms = jnp.where(t_int >= 1, Xr, NEG_INF)
        pm2_new = lse_reduce(pm2_terms, axis=1)
        pm_new = jnp.where(span_valid, pm_new, NEG_INF)
        pm2_new = jnp.where(span_valid, pm2_new, NEG_INF)

        # --- bpp outside for pair cells on this diagonal ---
        close_col = _col(P_close, d)
        acc_col = close_col + _col(ACC, d)
        lt = jnp.where(i_vec >= 1, jnp.take(extL, jnp.maximum(i_vec - 1, 0)), 0.0)
        rt = jnp.where(
            j <= n - 2,
            jnp.take(extR, jnp.clip(j + 1, 0, N - 1)),
            0.0,
        )
        base = lt + acc_col + rt - global_sum
        if contra:
            base = base + ext_bp

        # 2-loop context: outer (i-1-a, j+1+b)
        if contra:
            TLo = S.twoloop_outside_contra(seq, tbl, pre, d, N)
        else:
            TLo = S.twoloop_outside_turner(seq, tbl, pre, d, N)
        Wb = diag.window_gather(st["P_bppo_pad"], -1, -1, d + 2, +1, N)
        Wcl = diag.window_gather(P_close_pad, -1, -1, d + 2, +1, N)
        two_terms = jnp.where(
            jnp.isfinite(Wcl),
            Wb + close_col[:, None, None] - Wcl + TLo,
            NEG_INF,
        )
        two = lse_reduce(two_terms.reshape(N, -1), axis=1)

        # multibranch context: k < i, t' = i - k in [1, i]
        if contra:
            acc_mb = acc_col + mb_bp
        else:
            acc_mb = acc_col + coeff
        R_pm = diag.roll_cols_at(diag.shift_rows(st["Q_pm"], d), d)
        R_pm2 = diag.roll_cols_at(diag.shift_rows(st["Q_pm2"], d), d)
        Bq = jnp.concatenate([jnp.full((1, N), NEG_INF), Q_one[:-1]], axis=0)
        S_qone = diag.shift_cols_left(Bq, 2)
        mask1 = t_int >= 1
        terms_a = jnp.where(mask1, acc_mb[:, None] + R_pm2 + S_qone, NEG_INF)
        if contra:
            terms_b = jnp.where(
                mask1, acc_mb[:, None] + R_pm + mb_unpair * (t_idx - 1.0), NEG_INF
            )
        else:
            terms_b = jnp.where(mask1, acc_mb[:, None] + R_pm, NEG_INF)
        terms_c = jnp.where(mask1, acc_mb[:, None] + R_pm + S_qone, NEG_INF)
        mb_ctx = lse_reduce(
            jnp.concatenate([terms_a, terms_b, terms_c], axis=1), axis=1
        )

        bppo_new = lse_pair(lse_pair(base, two), mb_ctx)
        bppo_new = jnp.where(
            jnp.isfinite(close_col) & span_valid, bppo_new, NEG_INF
        )

        return {
            "P_bppo_pad": diag.write_col_padded(st["P_bppo_pad"], d, bppo_new),
            "Q_pm": diag.write_col(st["Q_pm"], d, diag.left_to_right_col(pm_new, d)),
            "Q_pm2": diag.write_col(
                st["Q_pm2"], d, diag.left_to_right_col(pm2_new, d)
            ),
        }, None

    dvals = jnp.arange(N - 1, -1, -1)
    state, _ = lax.scan(step, state, dvals)
    return diag.unpad_table(state["P_bppo_pad"], N)


# ---------------------------------------------------------------------------
# Public entry points
# ---------------------------------------------------------------------------

def mccaskill_bpp(seq, n, tbl, N, contra=False, allows_short_hairpins=False):
    """Basepair probabilities for one padded sequence.

    Args:
      seq: (N,) int32 bases (PSEUDO_BASE-padded beyond ``n``).
      n: traced true length.
      tbl: turner_table_pytree() or contra_table_pytree(fss).
      N: static padded length.
      contra: static model switch (mccaskill_algo.rs:247-280).
      allows_short_hairpins: static; CONTRA only (mccaskill_algo.rs:401-404).

    Returns:
      (bpp, memos): bpp is a dense (N, N) prob matrix (upper triangle), memos
      carry the per-loop score matrices the reference returns as FoldScores
      (mccaskill_algo.rs:13-19,279).
    """
    return _mccaskill_bpp(
        seq, n, tbl, N=N, contra=contra,
        allows_short_hairpins=allows_short_hairpins, mode=get_mode(),
    )


@partial(
    jax.jit, static_argnames=("N", "contra", "allows_short_hairpins", "mode")
)
def _mccaskill_bpp(seq, n, tbl, N, contra, allows_short_hairpins, mode):
    with force_mode(mode):
        return _mccaskill_bpp_body(seq, n, tbl, N, contra, allows_short_hairpins)


def _mccaskill_bpp_body(seq, n, tbl, N, contra, allows_short_hairpins):
    if contra:
        pre = S.precompute_contra(seq, n, N, tbl)
    else:
        pre = S.precompute_turner(seq, n, N, tbl)
    inside = _inside(seq, n, N, tbl, pre, contra, allows_short_hairpins)
    bppo = _outside(seq, n, N, tbl, pre, inside, contra, allows_short_hairpins)
    bpp_left = expf(bppo)
    bpp = _square_from_left(bpp_left, n, N, 0.0)
    # The reference's sparse map contains every pair with a finite outside sum
    # (mccaskill_algo.rs:602-609) — including expf-underflowed zeros; CLI
    # output parity needs this presence set, not just bpp > 0.
    presence = _square_from_left(
        jnp.isfinite(bppo).astype(jnp.float32), n, N, 0.0
    ) > 0.5
    memos = {
        "hairpin": pre["H"],
        "multibranch_close": pre["MBC"],
        "accessible": pre["ACC"],
        "close": inside["P_close"],
        "external": inside["P_ext"],
        "presence": presence,
    }
    return bpp, memos


def mccaskill_bpp_batch(seqs, ns, tbl, N, contra=False,
                        allows_short_hairpins=False, return_memos=False):
    """vmapped batch variant: seqs (B, N), ns (B,) -> (bpp, presence) (B, N, N).

    With ``return_memos=True`` returns (bpp, memos) instead, where memos is
    the batched FoldScores contract (mccaskill_algo.rs:13-19,279): the
    per-loop score grids {"hairpin", "multibranch_close", "accessible"} in
    left layout ``[b, i, d] = score(i, i+d)``, plus "presence".
    """
    return _mccaskill_bpp_batch(
        seqs, ns, tbl, N=N, contra=contra,
        allows_short_hairpins=allows_short_hairpins, mode=get_mode(),
        return_memos=bool(return_memos),
    )


@partial(
    jax.jit,
    static_argnames=("N", "contra", "allows_short_hairpins", "mode",
                     "return_memos"),
)
def _mccaskill_bpp_batch(seqs, ns, tbl, N, contra, allows_short_hairpins,
                         mode, return_memos=False):
    with force_mode(mode):
        def one(seq, n):
            bpp, memos = _mccaskill_bpp_body(
                seq, n, tbl, N, contra, allows_short_hairpins
            )
            if return_memos:
                return bpp, {
                    "hairpin": memos["hairpin"],
                    "multibranch_close": memos["multibranch_close"],
                    "accessible": memos["accessible"],
                    "presence": memos["presence"],
                }
            return bpp, memos["presence"]

        return jax.vmap(one)(seqs, ns)


def mccaskill_twoloop_memo(seq, n, tbl, N, contra=False):
    """On-demand per-sequence ``twoloop_scores`` memo.

    The reference's FoldScores returns the (i, j, k, l)-keyed 2-loop score
    memo alongside hairpin/multibranch-close/accessible
    (`/root/reference/src/mccaskill_algo.rs:13-19,279`).  Here it is a dense
    grid ``TL[d, i, a, b]`` = 2-loop score with outer pair (i, i+d) and
    inner pair (i+1+a, i+d-1-b), NEG_INF outside the valid window (loop
    length cap 30 per side / combined, inner span >= 1, j < n) — the same
    vectorized score assembly the inside scan consumes per span.

    This grid is O(n^2 L^2) floats (~63 MB at N=128), which is why it is an
    on-demand per-sequence API and deliberately NOT part of the batch
    ``return_memos`` contract (hairpin/multibranch_close/accessible/presence
    only) — see docs/API.md "FoldScores memos".  Pinned against the oracle's
    per-(i,j,k,l) scores by tests/test_mccaskill.py::test_twoloop_memo.
    """
    return _twoloop_memo(seq, n, tbl, N=N, contra=bool(contra),
                         mode=get_mode())


@partial(jax.jit, static_argnames=("N", "contra", "mode"))
def _twoloop_memo(seq, n, tbl, N, contra, mode):
    with force_mode(mode):
        pre = (
            S.precompute_contra(seq, n, N, tbl)
            if contra
            else S.precompute_turner(seq, n, N, tbl)
        )

        i_idx = jnp.arange(N)
        a = jnp.arange(31)[None, :, None]
        b = jnp.arange(31)[None, None, :]

        def step(_, d):
            TL = (
                S.twoloop_inside_contra(seq, tbl, pre, d, N)
                if contra
                else S.twoloop_inside_turner(seq, tbl, pre, d, N)
            )
            j = i_idx[:, None, None] + d
            valid = (
                (a + b <= jnp.minimum(30, d - 3))
                & (j < n)
            )
            return None, jnp.where(valid, TL, NEG_INF)

        _, TLs = lax.scan(step, None, jnp.arange(N))
        return TLs
