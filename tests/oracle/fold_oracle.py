"""Scalar NumPy oracle of the McCaskill inside/outside DP (test-only).

Faithful float32 re-derivation of the reference recurrences
(`/root/reference/src/mccaskill_algo.rs:282-723` and the scoring functions in
`/root/reference/src/utils.rs:162-556`), accumulating log-sum-exp terms in the
same streaming order with the same CONTRAfold approximations
(tests/oracle/numerics_oracle).  Shares only the parameter *tables* with the
production code; all DP arithmetic here is independent scalar Python and is used
to generate golden BPP matrices for the vectorized JAX implementation.
"""

import numpy as np

from rna_algos_tpu.constants import (
    A, C, G, U,
    CANONICAL_PAIRS,
    MIN_HAIRPIN_LEN,
    MIN_SPAN_HAIRPIN_CLOSE,
    MAX_LOOP_LEN,
    MAX_2LOOP_LEN,
    MAX_HAIRPIN_LEN_EXTRAPOLATION,
    MIN_HAIRPIN_LEN_EXTRAPOLATION,
    MAX_INTERIOR_EXPLICIT,
)
from rna_algos_tpu.params import turner as T
from .numerics_oracle import logsumexp, expf, F, DT

NEG_INF = F(-np.inf)
_CANON = set(CANONICAL_PAIRS)
_AUGU = {(A, U), (U, A), (G, U), (U, G)}


def is_canonical(a, b):
    return (a, b) in _CANON


# --------------------------------------------------------------------------
# Turner scoring (scalar)
# --------------------------------------------------------------------------

def special_hairpin_score(seq, i, j):
    sub = list(seq[i : j + 1])
    for s, l, v in zip(
        T.HAIRPIN_SPECIAL_SEQS, T.HAIRPIN_SPECIAL_LENS, T.HAIRPIN_SPECIAL_SCORES
    ):
        if l == len(sub) and list(s[:l]) == sub:
            return F(v)
    return NEG_INF


def hairpin_score_turner(seq, i, j):
    sp = special_hairpin_score(seq, i, j)
    if sp > NEG_INF:
        return sp
    hlen = j - i - 1
    a, b = seq[i], seq[j]
    if hlen == MIN_HAIRPIN_LEN:
        score = F(T.HAIRPIN_SCORES_INIT[hlen])
    else:
        if hlen <= MAX_HAIRPIN_LEN_EXTRAPOLATION:
            init = F(T.HAIRPIN_SCORES_INIT[hlen])
        else:
            init = F(
                T.HAIRPIN_SCORES_INIT[MIN_HAIRPIN_LEN_EXTRAPOLATION - 1]
                + T.COEFF_HAIRPIN_LEN_EXTRAPOLATION
                * F(
                    np.log(
                        F(hlen)
                        / F(MIN_HAIRPIN_LEN_EXTRAPOLATION - 1)
                    )
                )
            )
        score = F(
            init + T.TERMINAL_MISMATCH_SCORES_HAIRPIN[a][b][seq[i + 1]][seq[j - 1]]
        )
    if (a, b) in _AUGU:
        score = F(score + T.HELIX_AUGU_END_PENALTY)
    return score


def stack_score_turner(seq, ci, cj, ai, aj):
    return F(T.STACK_SCORES[seq[ci]][seq[cj]][seq[ai]][seq[aj]])


def twoloop_score_turner(seq, ci, cj, ai, aj):
    d1, d2 = ai - ci - 1, cj - aj - 1
    if d1 == 0 and d2 == 0:
        return stack_score_turner(seq, ci, cj, ai, aj)
    bp_c = (seq[ci], seq[cj])
    bp_a = (seq[ai], seq[aj])
    if d1 == 0 or d2 == 0:  # bulge
        blen = d1 + d2
        if blen == 1:
            return F(T.BULGE_SCORES_INIT[1] + stack_score_turner(seq, ci, cj, ai, aj))
        s = F(T.BULGE_SCORES_INIT[blen])
        if bp_c in _AUGU:
            s = F(s + T.HELIX_AUGU_END_PENALTY)
        if bp_a in _AUGU:
            s = F(s + T.HELIX_AUGU_END_PENALTY)
        return s
    # interior
    ilen = d1 + d2
    if (d1, d2) == (1, 1):
        return F(
            T.INTERIOR_SCORES_1X1[bp_c[0]][bp_c[1]][seq[ci + 1]][seq[cj - 1]][bp_a[0]][bp_a[1]]
        )
    if (d1, d2) == (1, 2):
        return F(
            T.INTERIOR_SCORES_1X2[bp_c[0]][bp_c[1]][seq[ci + 1]][seq[cj - 1]][seq[cj - 2]][bp_a[0]][bp_a[1]]
        )
    if (d1, d2) == (2, 1):
        return F(
            T.INTERIOR_SCORES_1X2[bp_a[1]][bp_a[0]][seq[cj - 1]][seq[ci + 2]][seq[ci + 1]][bp_c[1]][bp_c[0]]
        )
    if (d1, d2) == (2, 2):
        return F(
            T.INTERIOR_SCORES_2X2[bp_c[0]][bp_c[1]][seq[ci + 1]][seq[cj - 1]][seq[ci + 2]][seq[cj - 2]][bp_a[0]][bp_a[1]]
        )
    # generic interior: mismatch table family chosen by the loop-length pair
    if d1 == 1 or d2 == 1:
        tm = T.TERMINAL_MISMATCH_SCORES_1XMANY
    elif (d1, d2) in ((2, 3), (3, 2)):
        tm = T.TERMINAL_MISMATCH_SCORES_2X3
    else:
        tm = T.TERMINAL_MISMATCH_SCORES_INTERIOR
    mism = F(
        tm[bp_c[0]][bp_c[1]][seq[ci + 1]][seq[cj - 1]]
        + tm[seq[aj]][seq[ai]][seq[aj + 1]][seq[ai - 1]]
    )
    s = F(
        T.INTERIOR_SCORES_INIT[ilen]
        + max(F(T.NINIO_COEFF * abs(d1 - d2)), F(T.NINIO_MAX))
        + mism
    )
    if bp_c in _AUGU:
        s = F(s + T.HELIX_AUGU_END_PENALTY)
    if bp_a in _AUGU:
        s = F(s + T.HELIX_AUGU_END_PENALTY)
    return s


def multibranch_close_score_turner(seq, i, j):
    a, b = seq[i], seq[j]
    s = F(
        T.INIT_MULTIBRANCH_BASE
        + T.TERMINAL_MISMATCH_SCORES_MULTIBRANCH[b][a][seq[j - 1]][seq[i + 1]]
    )
    if (a, b) in _AUGU:
        s = F(s + T.HELIX_AUGU_END_PENALTY)
    return s


def accessible_score_turner(seq, i, j, uses_sentinel_bases=False):
    n = len(seq)
    end5 = 1 if uses_sentinel_bases else 0
    end3 = n - (2 if uses_sentinel_bases else 1)
    a, b = seq[i], seq[j]
    if i > end5 and j < end3:
        s = F(T.TERMINAL_MISMATCH_SCORES_MULTIBRANCH[a][b][seq[i - 1]][seq[j + 1]])
    elif i > end5:
        s = F(T.DANGLING_SCORES_5PRIME[a][b][seq[i - 1]])
    elif j < end3:
        s = F(T.DANGLING_SCORES_3PRIME[a][b][seq[j + 1]])
    else:
        s = F(0.0)
    if (a, b) in _AUGU:
        s = F(s + T.HELIX_AUGU_END_PENALTY)
    return s


# --------------------------------------------------------------------------
# CONTRAfold scoring (scalar), over the assembled FoldScoreSets dict
# --------------------------------------------------------------------------

def junction_score_single(seq, p0, p1, fss):
    a, b = seq[p0], seq[p1]
    return F(
        fss["helix_close_scores"][a][b]
        + fss["terminal_mismatch_scores"][a][b][seq[p0 + 1]][seq[p1 - 1]]
    )


def junction_score(seq, p0, p1, fss, uses_sentinel_bases=False):
    n = len(seq)
    a, b = seq[p0], seq[p1]
    end5 = 1 if uses_sentinel_bases else 0
    end3 = n - (2 if uses_sentinel_bases else 1)
    s = F(fss["helix_close_scores"][a][b])
    if p0 < end3:
        s = F(s + fss["dangling_scores_left"][a][b][seq[p0 + 1]])
    if p1 > end5:
        s = F(s + fss["dangling_scores_right"][a][b][seq[p1 - 1]])
    return s


def hairpin_score_contra(seq, i, j, fss):
    hlen = j - i - 1
    return F(
        fss["hairpin_scores_len_cumulative"][min(hlen, MAX_LOOP_LEN)]
        + junction_score_single(seq, i, j, fss)
    )


def twoloop_score_contra(seq, ci, cj, ai, aj, fss):
    d1, d2 = ai - ci - 1, cj - aj - 1
    a, b = seq[ai], seq[aj]
    if d1 == 0 and d2 == 0:
        s = F(fss["stack_scores"][seq[ci]][seq[cj]][a][b])
    elif d1 == 0 or d2 == 0:  # bulge
        blen = d1 + d2
        s = F(0.0)
        if blen == 1:
            nuc = seq[ci + 1] if d1 == 1 else seq[cj - 1]
            s = F(fss["bulge_scores_0x1"][nuc])
        s = F(
            s
            + fss["bulge_scores_len_cumulative"][blen - 1]
            + junction_score_single(seq, ci, cj, fss)
            + junction_score_single(seq, aj, ai, fss)
        )
    else:  # interior
        ilen = d1 + d2
        if d1 == d2:
            s = F(0.0)
            if ilen == 2:
                s = F(fss["interior_scores_1x1"][seq[ci + 1]][seq[cj - 1]])
            s = F(s + fss["interior_scores_symmetric_cumulative"][d1 - 1])
        else:
            s = F(fss["interior_scores_asymmetric_cumulative"][abs(d1 - d2) - 1])
        if d1 <= MAX_INTERIOR_EXPLICIT and d2 <= MAX_INTERIOR_EXPLICIT:
            s = F(s + fss["interior_scores_explicit"][d1 - 1][d2 - 1])
        s = F(
            s
            + fss["interior_scores_len_cumulative"][ilen - 2]
            + junction_score_single(seq, ci, cj, fss)
            + junction_score_single(seq, aj, ai, fss)
        )
    return F(s + fss["basepair_scores"][a][b])


# --------------------------------------------------------------------------
# Inside passes
# --------------------------------------------------------------------------

def _new_sums(n):
    return {
        "ext": np.zeros((n, n), dtype=DT()),
        "rm_ext": np.full((n, n), NEG_INF, dtype=DT()),
        "rm_mb": np.full((n, n), NEG_INF, dtype=DT()),
        "mb": np.full((n, n), NEG_INF, dtype=DT()),
        "one": np.full((n, n), NEG_INF, dtype=DT()),
        "close": {},
        "acc": {},
    }


def inside_turner(seq):
    n = len(seq)
    sums = _new_sums(n)
    scores = {"hairpin": {}, "twoloop": {}, "mb_close": {}, "acc": {}}
    for span in range(MIN_SPAN_HAIRPIN_CLOSE, n + 1):
        for i in range(0, n - span + 1):
            j = i + span - 1
            s = NEG_INF
            if span >= MIN_SPAN_HAIRPIN_CLOSE and is_canonical(seq[i], seq[j]):
                hp = hairpin_score_turner(seq, i, j)
                scores["hairpin"][(i, j)] = hp
                s = logsumexp(s, hp)
                for k in range(i + 1, j - 1):
                    if k - i - 1 > MAX_2LOOP_LEN:
                        break
                    for l in range(j - 1, k, -1):
                        if (j - l - 1) + (k - i - 1) > MAX_2LOOP_LEN:
                            break
                        if (k, l) in sums["close"]:
                            tl = twoloop_score_turner(seq, i, j, k, l)
                            scores["twoloop"][(i, j, k, l)] = tl
                            s = logsumexp(s, F(sums["close"][(k, l)] + tl))
                mbc = multibranch_close_score_turner(seq, i, j)
                s = logsumexp(s, F(sums["mb"][i + 1][j - 1] + mbc))
                acc_sc = accessible_score_turner(seq, i, j)
                if s > NEG_INF:
                    scores["mb_close"][(i, j)] = mbc
                    scores["acc"][(i, j)] = acc_sc
                    sums["close"][(i, j)] = s
                    sums["acc"][(i, j)] = F(s + acc_sc)
            # rightmost-basepair (external weighting)
            s = NEG_INF
            for k in range(i + 1, j + 1):
                if (i, k) in sums["acc"]:
                    s = logsumexp(s, sums["acc"][(i, k)])
            sums["rm_ext"][i][j] = s
            # external
            s = F(0.0)
            for k in range(i, j):
                x = sums["rm_ext"][k][j]
                y = F(0.0) if (i == 0 and k == 0) else sums["ext"][i][k - 1]
                s = logsumexp(s, F(x + y))
            sums["ext"][i][j] = s
            # multibranch / one-or-more
            s = F(sums["rm_ext"][i][j] + T.COEFF_NUM_BRANCHES)
            s2 = NEG_INF
            for k in range(i + 1, j):
                x = F(sums["rm_ext"][k][j] + T.COEFF_NUM_BRANCHES)
                s = logsumexp(s, x)
                s2 = logsumexp(s2, F(sums["one"][i][k - 1] + x))
            sums["mb"][i][j] = s2
            s = logsumexp(s, s2)
            sums["one"][i][j] = s
    return sums, scores


def inside_contra(seq, fss, allows_short_hairpins=False):
    n = len(seq)
    sums = _new_sums(n)
    scores = {"hairpin": {}, "twoloop": {}, "mb_close": {}, "acc": {}}
    ext_unpair = F(fss["external_score_unpair"])
    ext_bp = F(fss["external_score_basepair"])
    mb_unpair = F(fss["multibranch_score_unpair"])
    mb_bp = F(fss["multibranch_score_basepair"])
    for span in range(1, n + 1):
        for i in range(0, n - span + 1):
            j = i + span - 1
            s = NEG_INF
            if is_canonical(seq[i], seq[j]) and (
                allows_short_hairpins or span >= MIN_SPAN_HAIRPIN_CLOSE
            ):
                if j - i - 1 <= MAX_LOOP_LEN:
                    hp = hairpin_score_contra(seq, i, j, fss)
                    scores["hairpin"][(i, j)] = hp
                    s = logsumexp(s, hp)
                for k in range(i + 1, j - 1):
                    if k - i - 1 > MAX_LOOP_LEN:
                        break
                    for l in range(j - 1, k, -1):
                        if (j - l - 1) + (k - i - 1) > MAX_LOOP_LEN:
                            break
                        if (k, l) in sums["close"]:
                            tl = twoloop_score_contra(seq, i, j, k, l, fss)
                            scores["twoloop"][(i, j, k, l)] = tl
                            s = logsumexp(s, F(sums["close"][(k, l)] + tl))
                mbc = F(
                    fss["multibranch_score_base"]
                    + mb_bp
                    + junction_score(seq, i, j, fss)
                )
                s = logsumexp(s, F(sums["mb"][i + 1][j - 1] + mbc))
                acc_sc = F(
                    junction_score(seq, j, i, fss)
                    + fss["basepair_scores"][seq[i]][seq[j]]
                )
                if s > NEG_INF:
                    scores["mb_close"][(i, j)] = mbc
                    scores["acc"][(i, j)] = acc_sc
                    sums["close"][(i, j)] = s
                    sums["acc"][(i, j)] = F(s + acc_sc)
            # rightmost-basepair sums under external / multibranch weights
            s = NEG_INF
            s2 = NEG_INF
            for k in range(i + 1, j + 1):
                if (i, k) in sums["acc"]:
                    x = sums["acc"][(i, k)]
                    s = logsumexp(s, F(x + ext_bp + ext_unpair * (j - k)))
                    s2 = logsumexp(s2, F(x + mb_bp + mb_unpair * (j - k)))
            sums["rm_ext"][i][j] = s
            sums["rm_mb"][i][j] = s2
            # external
            s = F(ext_unpair * span)
            for k in range(i, j):
                x = sums["rm_ext"][k][j]
                y = F(0.0) if (i == 0 and k == 0) else sums["ext"][i][k - 1]
                s = logsumexp(s, F(x + y))
            sums["ext"][i][j] = s
            # multibranch / one-or-more
            s = sums["rm_mb"][i][j]
            s2 = NEG_INF
            for k in range(i + 1, j):
                x = sums["rm_mb"][k][j]
                s = logsumexp(s, F(x + mb_unpair * (k - i)))
                s2 = logsumexp(s2, F(sums["one"][i][k - 1] + x))
            sums["mb"][i][j] = s2
            s = logsumexp(s, s2)
            sums["one"][i][j] = s
    return sums, scores


# --------------------------------------------------------------------------
# Outside passes -> base-pairing probabilities
# --------------------------------------------------------------------------

def _outside(seq, sums, scores, model, fss=None, allows_short_hairpins=False):
    n = len(seq)
    contra = model == "contra"
    max_2loop = MAX_LOOP_LEN if contra else MAX_2LOOP_LEN
    global_sum = sums["ext"][0][n - 1]
    bpp = {}
    pm = np.full((n, n), NEG_INF, dtype=DT())
    pm2 = np.full((n, n), NEG_INF, dtype=DT())
    if contra:
        mb_unpair = F(fss["multibranch_score_unpair"])
        mb_bp = F(fss["multibranch_score_basepair"])
        ext_bp = F(fss["external_score_basepair"])
        min_span = 2 if allows_short_hairpins else MIN_SPAN_HAIRPIN_CLOSE
    else:
        min_span = MIN_SPAN_HAIRPIN_CLOSE
    for span in range(n, min_span - 1, -1):
        for i in range(0, n - span + 1):
            j = i + span - 1
            s = NEG_INF
            s2 = NEG_INF
            for k in range(j + 1, n):
                if (i, k) in sums["close"]:
                    x = F(
                        bpp[(i, k)]
                        + scores["mb_close"][(i, k)]
                        - sums["close"][(i, k)]
                    )
                    s = logsumexp(s, F(x + sums["one"][j + 1][k - 1]))
                    if contra:
                        s2 = logsumexp(s2, F(x + mb_unpair * (k - j - 1)))
                    else:
                        s2 = logsumexp(s2, x)
            pm[i][j] = s
            pm2[i][j] = s2
            if (i, j) not in sums["close"]:
                continue
            sum_close = sums["close"][(i, j)]
            left = F(0.0) if i < 1 else sums["ext"][0][i - 1]
            right = F(0.0) if j > n - 2 else sums["ext"][j + 1][n - 1]
            if contra:
                s = F(left + right + sums["acc"][(i, j)] + ext_bp - global_sum)
            else:
                s = F(left + sums["acc"][(i, j)] + right - global_sum)
            for k in range(i - 1, -1, -1):
                if i - k - 1 > max_2loop:
                    break
                for l in range(j + 1, n):
                    if (l - j - 1) + (i - k - 1) > max_2loop:
                        break
                    if (k, l) in sums["close"]:
                        s = logsumexp(
                            s,
                            F(
                                bpp[(k, l)]
                                + sum_close
                                - sums["close"][(k, l)]
                                + scores["twoloop"][(k, l, i, j)]
                            ),
                        )
            if contra:
                acc_mb = F(sums["acc"][(i, j)] + mb_bp)
            else:
                acc_mb = F(sums["acc"][(i, j)] + T.COEFF_NUM_BRANCHES)
            for k in range(0, i):
                x = sums["one"][k + 1][i - 1]
                s = logsumexp(s, F(acc_mb + pm2[k][j] + x))
                y = pm[k][j]
                if contra:
                    s = logsumexp(s, F(acc_mb + y + mb_unpair * (i - k - 1)))
                else:
                    s = logsumexp(s, F(acc_mb + y))
                s = logsumexp(s, F(acc_mb + x + y))
            if s > NEG_INF:
                bpp[(i, j)] = s
    return {k: expf(v) for k, v in bpp.items()}


def mccaskill_oracle(seq, uses_contra_model=False, allows_short_hairpins=False, fss=None):
    """(bpp dict, scores dict, inside sums) for one integer-encoded sequence."""
    seq = [int(b) for b in seq]
    if uses_contra_model:
        assert fss is not None
        sums, scores = inside_contra(seq, fss, allows_short_hairpins)
        bpp = _outside(seq, sums, scores, "contra", fss, allows_short_hairpins)
    else:
        sums, scores = inside_turner(seq)
        bpp = _outside(seq, sums, scores, "turner")
    return bpp, scores, sums
