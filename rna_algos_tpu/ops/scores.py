"""Vectorized scoring for the McCaskill DP: per-sequence score matrices and
per-anti-diagonal 2-loop score tensors.

The reference computes every score scalar-by-scalar inside the DP loops
(`/root/reference/src/utils.rs:162-556`).  This formulation splits each
scoring function into

* **per-sequence precomputation** — everything that depends only on one
  position pair (hairpin, multibranch-close, accessible/junction, terminal
  mismatches, AU/GU penalties) becomes a dense (N, N) left-layout matrix
  ``M[i, d] = score(i, i + d)`` built once with a handful of table gathers;
* **per-span assembly** — the 2-loop score for outer pair (i, j) and inner
  pair (k, l) = (i+1+a, j-1-b) becomes a (N, 31, 31) tensor built from those
  matrices via the window reads in :mod:`.diag` plus a few O(N) gathers for
  the special small-loop tables (1x1/1x2/2x2, bulge-of-1, CONTRA 0x1/1x1).

Both models are covered: Turner 2004 (utils.rs:166-411) and CONTRAfold v2.02
(utils.rs:413-556).  Scalar streaming semantics live in tests/oracle; these
tensors are consumed by the wavefront scans in models/mccaskill.py.
"""

import numpy as np
import jax.numpy as jnp
from jax import lax

from ..constants import (
    A, C, G, U,
    CANONICAL_PAIRS,
    MAX_LOOP_LEN,
    MAX_2LOOP_LEN,
    MAX_HAIRPIN_LEN_EXTRAPOLATION,
    MIN_HAIRPIN_LEN_EXTRAPOLATION,
    MIN_HAIRPIN_LEN,
    MAX_INTERIOR_EXPLICIT,
    MAX_INTERIOR_SYMMETRIC,
    MAX_INTERIOR_ASYMMETRIC,
    NEG_INF,
    NUM_BASES_PAD,
    PSEUDO_BASE,
)
from ..params import turner as T
from . import diag
from .lut import lookup as LUT

WINDOW = diag.WINDOW

# --- static (5,5) pair predicates ---
_CANON_NP = np.zeros((NUM_BASES_PAD, NUM_BASES_PAD), dtype=bool)
for _a, _b in CANONICAL_PAIRS:
    _CANON_NP[_a, _b] = True
_AUGU_NP = np.zeros((NUM_BASES_PAD, NUM_BASES_PAD), dtype=np.float32)
for _a, _b in ((A, U), (U, A), (G, U), (U, G)):
    _AUGU_NP[_a, _b] = 1.0

CANON_MAT = jnp.asarray(_CANON_NP)
AUGU_MAT = jnp.asarray(_AUGU_NP)


def sget(seq, idx):
    """Gather bases with PSEUDO_BASE for any out-of-range index."""
    return jnp.take(seq, idx, mode="fill", fill_value=PSEUDO_BASE)


def _col(M, d):
    """v[i] = M[i, d] for traced d (clamped; callers mask invalid spans)."""
    return lax.dynamic_slice(M, (0, jnp.maximum(d, 0)), (M.shape[0], 1))[:, 0]


# ---------------------------------------------------------------------------
# Table pytrees
# ---------------------------------------------------------------------------

def turner_table_pytree(tables=None):
    """Turner 2004 tables as jnp arrays (rna-ss-params compiled_scores_turner).

    ``tables`` defaults to `params.turner.active_tables()` — the embedded
    values, overridden by RNA_ALGOS_TURNER_PARAMS / turner.set_tables()
    (drop-in ViennaRNA .par ingestion; see PARAMS.md).
    """
    tabs = T.active_tables() if tables is None else tables
    return {
        "stack": jnp.asarray(tabs["STACK_SCORES"]),
        "hairpin_init": jnp.asarray(tabs["HAIRPIN_SCORES_INIT"]),
        "bulge_init": jnp.asarray(tabs["BULGE_SCORES_INIT"]),
        "interior_init": jnp.asarray(tabs["INTERIOR_SCORES_INIT"]),
        "int_1x1": jnp.asarray(tabs["INTERIOR_SCORES_1X1"]),
        "int_1x2": jnp.asarray(tabs["INTERIOR_SCORES_1X2"]),
        "int_2x2": jnp.asarray(tabs["INTERIOR_SCORES_2X2"]),
        "tm_hairpin": jnp.asarray(tabs["TERMINAL_MISMATCH_SCORES_HAIRPIN"]),
        "tm_interior": jnp.asarray(tabs["TERMINAL_MISMATCH_SCORES_INTERIOR"]),
        "tm_1xmany": jnp.asarray(tabs["TERMINAL_MISMATCH_SCORES_1XMANY"]),
        "tm_2x3": jnp.asarray(tabs["TERMINAL_MISMATCH_SCORES_2X3"]),
        "tm_multibranch": jnp.asarray(
            tabs["TERMINAL_MISMATCH_SCORES_MULTIBRANCH"]
        ),
        "dangle5": jnp.asarray(tabs["DANGLING_SCORES_5PRIME"]),
        "dangle3": jnp.asarray(tabs["DANGLING_SCORES_3PRIME"]),
        "special_seqs": jnp.asarray(tabs["HAIRPIN_SPECIAL_SEQS"]),
        "special_lens": jnp.asarray(tabs["HAIRPIN_SPECIAL_LENS"]),
        "special_scores": jnp.asarray(tabs["HAIRPIN_SPECIAL_SCORES"]),
        "ninio_coeff": jnp.float32(tabs["NINIO_COEFF"]),
        "ninio_max": jnp.float32(tabs["NINIO_MAX"]),
        "augu_penalty": jnp.float32(tabs["HELIX_AUGU_END_PENALTY"]),
        "init_multibranch_base": jnp.float32(tabs["INIT_MULTIBRANCH_BASE"]),
        "coeff_num_branches": jnp.float32(tabs["COEFF_NUM_BRANCHES"]),
        "coeff_hairpin_extrap": jnp.float32(
            tabs["COEFF_HAIRPIN_LEN_EXTRAPOLATION"]
        ),
    }


def contra_table_pytree(fss):
    """CONTRAfold FoldScoreSets (dict of numpy) -> jnp pytree."""
    out = {}
    for k, v in fss.items():
        out[k] = jnp.asarray(v)
    return out


# ---------------------------------------------------------------------------
# Shared grids
# ---------------------------------------------------------------------------

def _grids(N):
    i = jnp.arange(N)[:, None]
    dd = jnp.arange(N)[None, :]
    return i, dd


def canonical_matrix(seq, n, N):
    """canon[i, d] = is_canonical(seq[i], seq[i+d]) and i + d < n."""
    i, dd = _grids(N)
    j = i + dd
    xi = seq[:, None]
    xj = sget(seq, j)
    return CANON_MAT[xi, xj] & (j < n)


_AB = np.arange(WINDOW)
_AGRID = jnp.asarray(_AB[:, None])  # (31, 1)
_BGRID = jnp.asarray(_AB[None, :])  # (1, 31)
_MGRID = _AGRID + _BGRID            # a + b


# ---------------------------------------------------------------------------
# Turner per-sequence precompute
# ---------------------------------------------------------------------------

def special_hairpin_id(seq, tt, N):
    """H_sp[i, d] = special-hairpin score of [i, i+d] (incl. the closing
    pair); -inf where no special sequence matches (utils.rs:198-205)."""
    sp_seqs = tt["special_seqs"]          # (S, Lmax) with -1 padding
    sp_lens = tt["special_lens"]          # (S,)
    sp_scores = tt["special_scores"]      # (S,)
    _, Lmax = sp_seqs.shape
    offs = jnp.arange(Lmax)
    win = sget(seq, jnp.arange(N)[:, None] + offs[None, :])  # (N, Lmax)
    ok = (win[:, None, :] == sp_seqs[None, :, :]) | (
        offs[None, None, :] >= sp_lens[None, :, None]
    )
    match = jnp.all(ok, axis=-1)  # (N, S)
    sp_at = jnp.where(match, sp_scores[None, :], NEG_INF)  # (N, S)
    dd = jnp.arange(N)
    len_eq = (dd[None, :, None] + 1) == sp_lens[None, None, :]
    return jnp.max(jnp.where(len_eq, sp_at[:, None, :], NEG_INF), axis=-1)


def precompute_turner(seq, n, N, tt):
    """All (N, N) left-layout score matrices for one padded sequence.

    Mirrors the scalar fns: hairpin (utils.rs:166-205), multibranch close
    (utils.rs:368-382), accessible (utils.rs:384-411), plus the terminal
    mismatch / AU-GU matrices consumed by the per-span 2-loop assembly.
    """
    i, dd = _grids(N)
    j = i + dd
    xi = seq[:, None] * jnp.ones_like(dd)
    xj = sget(seq, j)
    s_i1 = sget(seq, i + 1) * jnp.ones_like(dd)
    s_j1 = sget(seq, j - 1)
    augu_pen = AUGU_MAT[xi, xj] * tt["augu_penalty"]

    # --- hairpin (utils.rs:166-205) ---
    hlen = dd - 1
    init_in = tt["hairpin_init"][jnp.clip(hlen, 0, MAX_HAIRPIN_LEN_EXTRAPOLATION)]
    extrap = tt["hairpin_init"][MIN_HAIRPIN_LEN_EXTRAPOLATION - 1] + tt[
        "coeff_hairpin_extrap"
    ] * jnp.log(
        jnp.maximum(hlen, 1).astype(jnp.float32)
        / np.float32(MIN_HAIRPIN_LEN_EXTRAPOLATION - 1)
    )
    init = jnp.where(hlen <= MAX_HAIRPIN_LEN_EXTRAPOLATION, init_in, extrap)
    tm = LUT(tt["tm_hairpin"], xi, xj, s_i1, s_j1)
    generic = jnp.where(
        hlen == MIN_HAIRPIN_LEN,
        tt["hairpin_init"][jnp.clip(hlen, 0, MAX_LOOP_LEN)],
        init + tm,
    ) + augu_pen
    # special hairpins: exact subsequence match incl. closing pair
    H_sp = special_hairpin_id(seq, tt, N)
    H = jnp.where(jnp.isfinite(H_sp), H_sp, generic)

    # --- multibranch close (utils.rs:368-382): note reversed pair indexing ---
    MBC = (
        tt["init_multibranch_base"]
        + LUT(tt["tm_multibranch"], xj, xi, s_j1, s_i1)
        + augu_pen
    )

    # --- accessible (utils.rs:384-411), boundary-cased ---
    s_im1 = sget(seq, i - 1) * jnp.ones_like(dd)
    s_jp1 = sget(seq, j + 1)
    c_tm = LUT(tt["tm_multibranch"], xi, xj, s_im1, s_jp1)
    c_d5 = LUT(tt["dangle5"], xi, xj, s_im1)
    c_d3 = LUT(tt["dangle3"], xi, xj, s_jp1)
    has_l = i > 0
    has_r = j < n - 1
    ACC = (
        jnp.where(
            has_l & has_r, c_tm, jnp.where(has_l, c_d5, jnp.where(has_r, c_d3, 0.0))
        )
        + augu_pen
    )

    # --- matrices consumed by the per-span 2-loop assembly ---
    # outer mismatch per family: TMo_f[i, d] = TM_f[x_i, x_j, s(i+1), s(j-1)]
    TMo = {
        f: LUT(tt[f], xi, xj, s_i1, s_j1)
        for f in ("tm_interior", "tm_1xmany", "tm_2x3")
    }
    # inner mismatch per family: TMi_f[r, c] = TM_f[x_{r+c}, x_r, s(r+c+1), s(r-1)]
    s_rc1 = sget(seq, j + 1)
    TMi = {
        f: LUT(tt[f], xj, xi, s_rc1, s_im1)
        for f in ("tm_interior", "tm_1xmany", "tm_2x3")
    }
    AUGU = AUGU_MAT[xi, xj] * tt["augu_penalty"]

    return {
        "H": H,
        "MBC": MBC,
        "ACC": ACC,
        "AUGU": AUGU,
        "AUGU_pad": diag.pad_table(AUGU, 0.0),
        "TMo_int": TMo["tm_interior"],
        "TMo_1xmany": TMo["tm_1xmany"],
        "TMo_2x3": TMo["tm_2x3"],
        "TMo_int_pad": diag.pad_table(TMo["tm_interior"], 0.0),
        "TMo_1xmany_pad": diag.pad_table(TMo["tm_1xmany"], 0.0),
        "TMo_2x3_pad": diag.pad_table(TMo["tm_2x3"], 0.0),
        "TMi_int": TMi["tm_interior"],
        "TMi_1xmany": TMi["tm_1xmany"],
        "TMi_2x3": TMi["tm_2x3"],
        "TMi_int_pad": diag.pad_table(TMi["tm_interior"], 0.0),
        "TMi_1xmany_pad": diag.pad_table(TMi["tm_1xmany"], 0.0),
        "TMi_2x3_pad": diag.pad_table(TMi["tm_2x3"], 0.0),
        "canon": canonical_matrix(seq, n, N),
    }


# static (31, 31) grids for the Turner 2-loop
def _turner_len_consts(tt):
    m = jnp.clip(_MGRID, 0, MAX_2LOOP_LEN)
    init_int = tt["interior_init"][m]
    init_bulge = tt["bulge_init"][jnp.clip(_MGRID, 1, MAX_2LOOP_LEN)]
    ninio = jnp.maximum(
        tt["ninio_coeff"] * jnp.abs(_AGRID - _BGRID).astype(jnp.float32),
        tt["ninio_max"],
    )
    return init_int, init_bulge, ninio


def _fam_select(vec_int, vec_1xmany, vec_2x3):
    """Select per (a,b) among the three generic-interior mismatch families."""
    is_1 = (_AGRID == 1) | (_BGRID == 1)
    is_23 = ((_AGRID == 2) & (_BGRID == 3)) | ((_AGRID == 3) & (_BGRID == 2))
    return jnp.where(is_1, vec_1xmany, jnp.where(is_23, vec_2x3, vec_int))


def twoloop_inside_turner(seq, tt, pre, d, N):
    """TL[i, a, b] = Turner 2-loop score, outer (i, i+d), inner (i+1+a, i+d-1-b).

    Vectorized get_2loop_score (utils.rs:207-366).
    """
    i = jnp.arange(N)
    j = i + d
    xi, xj = seq, sget(seq, j)
    s_i1, s_i2, s_i3 = sget(seq, i + 1), sget(seq, i + 2), sget(seq, i + 3)
    s_j1, s_j2, s_j3 = sget(seq, j - 1), sget(seq, j - 2), sget(seq, j - 3)

    stack00 = tt["stack"][xi, xj, s_i1, s_j1]
    b01 = tt["bulge_init"][1] + tt["stack"][xi, xj, s_i1, s_j2]
    b10 = tt["bulge_init"][1] + tt["stack"][xi, xj, s_i2, s_j1]
    i11 = tt["int_1x1"][xi, xj, s_i1, s_j1, s_i2, s_j2]
    i12 = tt["int_1x2"][xi, xj, s_i1, s_j1, s_j2, s_i2, s_j3]
    i21 = tt["int_1x2"][s_j2, s_i3, s_j1, s_i2, s_i1, xj, xi]
    i22 = tt["int_2x2"][xi, xj, s_i1, s_j1, s_i2, s_j2, s_i3, s_j3]

    init_int, init_bulge, ninio = _turner_len_consts(tt)
    aug_out = _col(pre["AUGU"], d)[:, None, None]
    W_AUGU = diag.window_gather(pre["AUGU_pad"], 1, +1, d - 2, -1, N)
    W_TMi = _fam_select(
        diag.window_gather(pre["TMi_int_pad"], 1, +1, d - 2, -1, N),
        diag.window_gather(pre["TMi_1xmany_pad"], 1, +1, d - 2, -1, N),
        diag.window_gather(pre["TMi_2x3_pad"], 1, +1, d - 2, -1, N),
    )
    TMo = _fam_select(
        _col(pre["TMo_int"], d)[:, None, None],
        _col(pre["TMo_1xmany"], d)[:, None, None],
        _col(pre["TMo_2x3"], d)[:, None, None],
    )

    interior_gen = init_int[None] + ninio[None] + TMo + W_TMi + aug_out + W_AUGU
    bulge_gen = init_bulge[None] + aug_out + W_AUGU

    a, b = _AGRID[None], _BGRID[None]
    m = a + b
    TL = jnp.where(
        m == 0,
        stack00[:, None, None],
        jnp.where(
            (a == 0) & (b == 1),
            b01[:, None, None],
            jnp.where(
                (a == 1) & (b == 0),
                b10[:, None, None],
                jnp.where(
                    (a == 0) | (b == 0),
                    bulge_gen,
                    jnp.where(
                        (a == 1) & (b == 1),
                        i11[:, None, None],
                        jnp.where(
                            (a == 1) & (b == 2),
                            i12[:, None, None],
                            jnp.where(
                                (a == 2) & (b == 1),
                                i21[:, None, None],
                                jnp.where(
                                    (a == 2) & (b == 2),
                                    i22[:, None, None],
                                    interior_gen,
                                ),
                            ),
                        ),
                    ),
                ),
            ),
        ),
    )
    return TL


def twoloop_outside_turner(seq, tt, pre, d, N):
    """TL[i, a, b] = Turner 2-loop score, outer (i-1-a, i+d+1+b), inner (i, i+d)."""
    i = jnp.arange(N)
    j = i + d
    xi, xj = seq, sget(seq, j)
    s_im1, s_im2, s_im3 = sget(seq, i - 1), sget(seq, i - 2), sget(seq, i - 3)
    s_jp1, s_jp2, s_jp3 = sget(seq, j + 1), sget(seq, j + 2), sget(seq, j + 3)

    stack00 = tt["stack"][s_im1, s_jp1, xi, xj]
    b01 = tt["bulge_init"][1] + tt["stack"][s_im1, s_jp2, xi, xj]
    b10 = tt["bulge_init"][1] + tt["stack"][s_im2, s_jp1, xi, xj]
    i11 = tt["int_1x1"][s_im2, s_jp2, s_im1, s_jp1, xi, xj]
    i12 = tt["int_1x2"][s_im2, s_jp3, s_im1, s_jp2, s_jp1, xi, xj]
    i21 = tt["int_1x2"][xj, xi, s_jp1, s_im1, s_im2, s_jp2, s_im3]
    i22 = tt["int_2x2"][s_im3, s_jp3, s_im2, s_jp2, s_im1, s_jp1, xi, xj]

    init_int, init_bulge, ninio = _turner_len_consts(tt)
    aug_in = _col(pre["AUGU"], d)[:, None, None]
    W_AUGU = diag.window_gather(pre["AUGU_pad"], -1, -1, d + 2, +1, N)
    W_TMo = _fam_select(
        diag.window_gather(pre["TMo_int_pad"], -1, -1, d + 2, +1, N),
        diag.window_gather(pre["TMo_1xmany_pad"], -1, -1, d + 2, +1, N),
        diag.window_gather(pre["TMo_2x3_pad"], -1, -1, d + 2, +1, N),
    )
    TMi = _fam_select(
        _col(pre["TMi_int"], d)[:, None, None],
        _col(pre["TMi_1xmany"], d)[:, None, None],
        _col(pre["TMi_2x3"], d)[:, None, None],
    )

    interior_gen = init_int[None] + ninio[None] + W_TMo + TMi + aug_in + W_AUGU
    bulge_gen = init_bulge[None] + aug_in + W_AUGU

    a, b = _AGRID[None], _BGRID[None]
    m = a + b
    TL = jnp.where(
        m == 0,
        stack00[:, None, None],
        jnp.where(
            (a == 0) & (b == 1),
            b01[:, None, None],
            jnp.where(
                (a == 1) & (b == 0),
                b10[:, None, None],
                jnp.where(
                    (a == 0) | (b == 0),
                    bulge_gen,
                    jnp.where(
                        (a == 1) & (b == 1),
                        i11[:, None, None],
                        jnp.where(
                            (a == 1) & (b == 2),
                            i12[:, None, None],
                            jnp.where(
                                (a == 2) & (b == 1),
                                i21[:, None, None],
                                jnp.where(
                                    (a == 2) & (b == 2),
                                    i22[:, None, None],
                                    interior_gen,
                                ),
                            ),
                        ),
                    ),
                ),
            ),
        ),
    )
    return TL


# ---------------------------------------------------------------------------
# CONTRAfold per-sequence precompute
# ---------------------------------------------------------------------------

def precompute_contra(seq, n, N, ct):
    """All (N, N) left-layout CONTRAfold score matrices for one sequence.

    Mirrors hairpin/junction scoring (utils.rs:413-421,522-556) and the
    2-loop decomposition of get_2loop_score_contra (utils.rs:423-442).
    """
    i, dd = _grids(N)
    j = i + dd
    xi = seq[:, None] * jnp.ones_like(dd)
    xj = sget(seq, j)
    s_i1 = sget(seq, i + 1) * jnp.ones_like(dd)
    s_j1 = sget(seq, j - 1)
    s_im1 = sget(seq, i - 1) * jnp.ones_like(dd)
    s_jp1 = sget(seq, j + 1)

    hc = ct["helix_close_scores"]
    tm = ct["terminal_mismatch_scores"]
    dl = ct["dangling_scores_left"]
    dr = ct["dangling_scores_right"]
    bp = ct["basepair_scores"]

    # junction_score_single(i, j) (utils.rs:545-548)
    JS = LUT(hc, xi, xj) + LUT(tm, xi, xj, s_i1, s_j1)
    # junction_score_single(j, i) — reversed pair, read at inner (k, l)
    JSrev = LUT(hc, xj, xi) + LUT(tm, xj, xi, s_jp1, s_im1)
    BP = LUT(bp, xi, xj)
    JB = JSrev + BP

    hlen = dd - 1
    H = jnp.where(
        (hlen >= 0) & (hlen <= MAX_LOOP_LEN),
        ct["hairpin_scores_len_cumulative"][jnp.clip(hlen, 0, MAX_LOOP_LEN)] + JS,
        NEG_INF,
    )

    # full junction (utils.rs:522-543), no sentinels: dangles inside the pair
    # are unconditional for i < j <= n-1; MBC = mb base + bp weight + junction(i,j)
    MBC = (
        ct["multibranch_score_base"]
        + ct["multibranch_score_basepair"]
        + LUT(hc, xi, xj)
        + LUT(dl, xi, xj, s_i1)
        + LUT(dr, xi, xj, s_j1)
    )
    # accessible = junction(j, i) + basepair score, boundary-cased
    ACC = (
        LUT(hc, xj, xi)
        + jnp.where(j < n - 1, LUT(dl, xj, xi, s_jp1), 0.0)
        + jnp.where(i > 0, LUT(dr, xj, xi, s_im1), 0.0)
        + BP
    )

    return {
        "H": H,
        "MBC": MBC,
        "ACC": ACC,
        "JS": JS,
        "JS_pad": diag.pad_table(JS, 0.0),
        "JSrev": JSrev,
        "BP": BP,
        "JB_pad": diag.pad_table(JB, 0.0),
        "canon": canonical_matrix(seq, n, N),
    }


def _contra_len_consts(ct):
    """(31, 31) length/feature terms of the CONTRA 2-loop (a, b > 0 cells)."""
    a, b = _AGRID, _BGRID
    m = a + b
    bulge = ct["bulge_scores_len_cumulative"][jnp.clip(m - 1, 0, MAX_LOOP_LEN - 1)]
    sym = ct["interior_scores_symmetric_cumulative"][
        jnp.clip(a - 1, 0, MAX_INTERIOR_SYMMETRIC - 1)
    ]
    asym = ct["interior_scores_asymmetric_cumulative"][
        jnp.clip(jnp.abs(a - b) - 1, 0, MAX_INTERIOR_ASYMMETRIC - 1)
    ]
    explicit = jnp.where(
        (a >= 1) & (a <= MAX_INTERIOR_EXPLICIT) & (b >= 1) & (b <= MAX_INTERIOR_EXPLICIT),
        ct["interior_scores_explicit"][
            jnp.clip(a - 1, 0, MAX_INTERIOR_EXPLICIT - 1),
            jnp.clip(b - 1, 0, MAX_INTERIOR_EXPLICIT - 1),
        ],
        0.0,
    )
    interior = (
        ct["interior_scores_len_cumulative"][jnp.clip(m - 2, 0, MAX_LOOP_LEN - 2)]
        + jnp.where(a == b, sym, asym)
        + explicit
    )
    return bulge, interior


def twoloop_inside_contra(seq, ct, pre, d, N):
    """TL[i, a, b] = CONTRA 2-loop score, outer (i, i+d), inner (i+1+a, i+d-1-b).

    Vectorized get_2loop_score_contra (utils.rs:423-520).
    """
    i = jnp.arange(N)
    j = i + d
    s_i1, s_j1 = sget(seq, i + 1), sget(seq, j - 1)
    xi, xj = seq, sget(seq, j)

    stack00 = (
        ct["stack_scores"][xi, xj, s_i1, s_j1]
        + ct["basepair_scores"][s_i1, s_j1]
    )
    b0x1_left = ct["bulge_scores_0x1"][s_i1]   # d1 == 1 (a=1, b=0)
    b0x1_right = ct["bulge_scores_0x1"][s_j1]  # d2 == 1 (a=0, b=1)
    i1x1 = ct["interior_scores_1x1"][s_i1, s_j1]

    W_JB = diag.window_gather(pre["JB_pad"], 1, +1, d - 2, -1, N)
    js_out = _col(pre["JS"], d)[:, None, None]

    bulge_len, interior_len = _contra_len_consts(ct)
    a, b = _AGRID[None], _BGRID[None]
    m = a + b
    bulge = bulge_len[None] + jnp.where(
        m == 1,
        jnp.where(a == 1, b0x1_left[:, None, None], b0x1_right[:, None, None]),
        0.0,
    )
    interior = interior_len[None] + jnp.where(
        (a == 1) & (b == 1), i1x1[:, None, None], 0.0
    )
    body = jnp.where((a == 0) | (b == 0), bulge, interior) + js_out + W_JB
    return jnp.where(m == 0, stack00[:, None, None], body)


def twoloop_outside_contra(seq, ct, pre, d, N):
    """TL[i, a, b] = CONTRA 2-loop score, outer (i-1-a, i+d+1+b), inner (i, i+d)."""
    i = jnp.arange(N)
    j = i + d
    xi, xj = seq, sget(seq, j)
    s_im1, s_jp1 = sget(seq, i - 1), sget(seq, j + 1)

    stack00 = (
        ct["stack_scores"][s_im1, s_jp1, xi, xj] + ct["basepair_scores"][xi, xj]
    )
    b0x1_left = ct["bulge_scores_0x1"][s_im1]   # d1 == 1 (a=1): nuc = seq[ci+1]
    b0x1_right = ct["bulge_scores_0x1"][s_jp1]  # d2 == 1 (b=1): nuc = seq[cj-1]
    i1x1 = ct["interior_scores_1x1"][s_im1, s_jp1]

    W_JS = diag.window_gather(pre["JS_pad"], -1, -1, d + 2, +1, N)
    jsrev_in = _col(pre["JSrev"], d)[:, None, None]
    bp_in = _col(pre["BP"], d)[:, None, None]

    bulge_len, interior_len = _contra_len_consts(ct)
    a, b = _AGRID[None], _BGRID[None]
    m = a + b
    bulge = bulge_len[None] + jnp.where(
        m == 1,
        jnp.where(a == 1, b0x1_left[:, None, None], b0x1_right[:, None, None]),
        0.0,
    )
    interior = interior_len[None] + jnp.where(
        (a == 1) & (b == 1), i1x1[:, None, None], 0.0
    )
    # basepair score of the inner (accessible) pair applies to every branch;
    # stack00 already folded it in above.
    body = jnp.where((a == 0) | (b == 0), bulge, interior) + jsrev_in + W_JS + bp_in
    return jnp.where(m == 0, stack00[:, None, None], body)
