"""Vectorized numerics vs the scalar float32 oracle and exact math."""

import numpy as np
import pytest

from rna_algos_tpu.numerics import ln_exp_1p, expf, lse_pair, lse_reduce, lse_accumulate
from tests.oracle import numerics_oracle as oracle


def test_ln_exp_1p_matches_scalar_oracle():
    xs = np.linspace(0.0, 11.862479, 4001, dtype=np.float32)
    got = np.asarray(ln_exp_1p(xs))
    want = np.array([oracle.ln_exp_1p(x) for x in xs], dtype=np.float32)
    np.testing.assert_array_equal(got, want)


def test_ln_exp_1p_approximates_exact():
    xs = np.linspace(0.0, 11.862479, 1001, dtype=np.float32)
    got = np.asarray(ln_exp_1p(xs), dtype=np.float64)
    exact = np.log1p(np.exp(xs.astype(np.float64)))
    assert np.max(np.abs(got - exact)) < 2e-5


def test_expf_matches_scalar_oracle():
    # x < 0: piecewise cubics must agree bit-for-bit.
    xs = np.linspace(-12.0, -1e-6, 4001, dtype=np.float32)
    got = np.asarray(expf(xs))
    want = np.array([oracle.expf(x) for x in xs], dtype=np.float32)
    np.testing.assert_array_equal(got, want)
    # x >= 0 uses the platform exp (XLA vs libm differ at ~1e-6 relative).
    xs = np.linspace(0.0, 3.0, 301, dtype=np.float32)
    got = np.asarray(expf(xs))
    want = np.array([oracle.expf(x) for x in xs], dtype=np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_expf_approximates_exact():
    xs = np.linspace(-9.0, 2.0, 1001, dtype=np.float32)
    got = np.asarray(expf(xs), dtype=np.float64)
    exact = np.exp(xs.astype(np.float64))
    # The CONTRAfold cubic itself has ~5e-5 absolute error (inherent to the
    # reference's approximation, not to our vectorization).
    assert np.max(np.abs(got - exact)) < 1e-4


def test_expf_handles_neg_inf():
    got = np.asarray(expf(np.array([-np.inf, -100.0, 0.0], dtype=np.float32)))
    np.testing.assert_array_equal(got, np.array([0.0, 0.0, 1.0], dtype=np.float32))


def test_lse_pair_matches_streaming_combine():
    rng = np.random.default_rng(0)
    a = rng.uniform(-30, 10, size=512).astype(np.float32)
    b = rng.uniform(-30, 10, size=512).astype(np.float32)
    got = np.asarray(lse_pair(a, b))
    want = np.array([oracle.logsumexp(x, y) for x, y in zip(a, b)], dtype=np.float32)
    np.testing.assert_array_equal(got, want)


def test_lse_pair_identity_and_nonfinite():
    """Contract: operands are finite or -inf (the only values DP states take);
    -inf behaves as the additive identity exactly like the reference's
    is_finite skip (utils.rs:580-584).  NaN/+inf operands are out of contract
    (the full skip logic was dropped for elementwise throughput)."""
    neg_inf = np.float32(-np.inf)
    assert np.asarray(lse_pair(neg_inf, neg_inf)) == neg_inf
    assert np.asarray(lse_pair(neg_inf, np.float32(1.5))) == np.float32(1.5)
    assert np.asarray(lse_pair(np.float32(1.5), neg_inf)) == np.float32(1.5)


def test_lse_accumulate_asymmetric_skip():
    # Non-finite x leaves the accumulator untouched even when it is -inf.
    s = np.float32(-np.inf)
    assert np.asarray(lse_accumulate(s, np.float32(np.inf))) == s


@pytest.mark.parametrize("n", [1, 2, 3, 7, 31, 100])
def test_lse_reduce_close_to_exact(n):
    rng = np.random.default_rng(n)
    x = rng.uniform(-25, 5, size=(8, n)).astype(np.float32)
    got = np.asarray(lse_reduce(x, axis=-1), dtype=np.float64)
    exact = np.log(np.sum(np.exp(x.astype(np.float64)), axis=-1))
    assert np.max(np.abs(got - exact)) < 1e-4


def test_lse_reduce_all_neg_inf():
    x = np.full((4, 9), -np.inf, dtype=np.float32)
    got = np.asarray(lse_reduce(x, axis=-1))
    assert np.all(got == -np.inf)


def test_lse_reduce_vs_streaming_order_tolerance():
    """Tree order differs from the reference's streaming order only at the level
    of the cubic-approximation error."""
    rng = np.random.default_rng(42)
    for _ in range(20):
        x = rng.uniform(-20, 5, size=64).astype(np.float32)
        got = float(np.asarray(lse_reduce(x)))
        want = float(oracle.lse_stream(x))
        assert abs(got - want) < 5e-5
