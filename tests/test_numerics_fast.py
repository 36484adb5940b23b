"""The "fast" numerics mode: hardware transcendentals instead of the
reference's piecewise cubics.

Fast mode trades bit-level reference parity for throughput; since
`jnp.logaddexp`/`jnp.exp` are *more* accurate than the CONTRAfold cubics
(~1e-6 relative error in log space), fast-mode BPPs must still agree with the
exact-mode BPPs (and hence the oracle) to well within the cubic error budget.
The mode travels in the jit cache key (models/mccaskill.py), so switching
modes in one process re-traces rather than reusing a stale compilation.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from rna_algos_tpu import numerics
from rna_algos_tpu.constants import (
    NEG_INF,
    PSEUDO_BASE,
    PROB_BOUND_LOWER,
    PROB_BOUND_UPPER,
)
from rna_algos_tpu.params import build_fold_score_sets, build_align_scores
from rna_algos_tpu.ops import scores as S
from rna_algos_tpu.models import mccaskill as M
from rna_algos_tpu.models.durbin import durbin_match_probs


@pytest.fixture
def fast_mode():
    numerics.set_mode("fast")
    yield
    numerics.set_mode("exact")


def test_mode_validation():
    assert numerics.get_mode() == "exact"
    with pytest.raises(ValueError):
        numerics.set_mode("approximate")
    with numerics.force_mode("fast"):
        assert numerics.get_mode() == "fast"
    assert numerics.get_mode() == "exact"


def test_parity_tier_matches_exact_numerics():
    """At the numerics level "parity" IS the cubic evaluation ("exact" only
    diverges at kernel dispatch, models/mccaskill.py)."""
    xs = jnp.asarray(np.linspace(-12.0, 8.0, 41), dtype=jnp.float32)
    with numerics.force_mode("exact"):
        e_pair = np.asarray(numerics.lse_pair(xs, 0.5 * xs))
        e_exp = np.asarray(numerics.expf(xs))
    with numerics.force_mode("parity"):
        p_pair = np.asarray(numerics.lse_pair(xs, 0.5 * xs))
        p_exp = np.asarray(numerics.expf(xs))
    np.testing.assert_array_equal(e_pair, p_pair)
    np.testing.assert_array_equal(e_exp, p_exp)


def test_fast_lse_pair_semantics(fast_mode):
    # same identity/skip semantics as exact mode (logsumexp, utils.rs:579-596)
    assert float(numerics.lse_pair(NEG_INF, NEG_INF)) == NEG_INF
    assert float(numerics.lse_pair(NEG_INF, 1.5)) == 1.5
    assert float(numerics.lse_pair(2.5, NEG_INF)) == 2.5
    got = float(numerics.lse_pair(0.3, -0.9))
    # hardware transcendentals are approximate (~1e-4 abs in log space)
    assert abs(got - np.logaddexp(0.3, -0.9)) < 3e-4
    assert float(numerics.expf(NEG_INF)) == 0.0


def test_fast_lse_reduce(fast_mode):
    rng = np.random.default_rng(5)
    x = rng.normal(size=(4, 13)).astype(np.float32)
    x[1, 3:] = NEG_INF
    x[2, :] = NEG_INF  # all -inf row -> identity (-inf), no NaN
    got = np.asarray(numerics.lse_reduce(jnp.asarray(x), axis=1))
    with np.errstate(divide="ignore"):
        ref = np.logaddexp.reduce(x, axis=1)
    assert np.allclose(got[[0, 1, 3]], ref[[0, 1, 3]], atol=3e-4)
    assert got[2] == NEG_INF


def _pad(seq, N):
    out = np.full(N, PSEUDO_BASE, dtype=np.int32)
    out[: len(seq)] = seq
    return jnp.asarray(out)


@pytest.mark.parametrize("contra", [False, True])
def test_fast_vs_exact_bpp(contra, fast_mode):
    fss = build_fold_score_sets()
    tbl = S.contra_table_pytree(fss) if contra else S.turner_table_pytree()
    rng = np.random.default_rng(11)
    N = 32
    n = 20
    seq = rng.integers(0, 4, size=n).astype(np.int32)

    bpp_fast, _ = M.mccaskill_bpp(_pad(seq, N), jnp.int32(n), tbl, N=N, contra=contra)
    numerics.set_mode("exact")
    bpp_exact, _ = M.mccaskill_bpp(_pad(seq, N), jnp.int32(n), tbl, N=N, contra=contra)
    numerics.set_mode("fast")

    bf, be = np.asarray(bpp_fast), np.asarray(bpp_exact)
    assert np.abs(bf - be).max() < 5e-4
    assert (bf > PROB_BOUND_LOWER).all() and (bf < PROB_BOUND_UPPER).all()


def test_fast_durbin(fast_mode):
    sc = build_align_scores()
    rng = np.random.default_rng(3)
    n1, n2 = 14, 17
    s1 = np.concatenate([[PSEUDO_BASE], rng.integers(0, 4, n1), [PSEUDO_BASE]])
    s2 = np.concatenate([[PSEUDO_BASE], rng.integers(0, 4, n2), [PSEUDO_BASE]])
    N1, N2 = 24, 24
    args = (
        _pad(s1.astype(np.int32), N1), jnp.int32(n1 + 2),
        _pad(s2.astype(np.int32), N2), jnp.int32(n2 + 2),
    )
    p_fast = np.asarray(durbin_match_probs(*args, sc, N1=N1, N2=N2))
    numerics.set_mode("exact")
    p_exact = np.asarray(durbin_match_probs(*args, sc, N1=N1, N2=N2))
    numerics.set_mode("fast")
    assert np.abs(p_fast - p_exact).max() < 5e-4
    assert (p_fast >= 0).all() and (p_fast <= 1 + 1e-3).all()
