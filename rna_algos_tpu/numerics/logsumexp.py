"""Log-space numerics: CONTRAfold's piecewise-cubic fast-LSE, vectorized.

The reference implements a streaming log-sum-exp built on two piecewise-cubic
approximations from CONTRAfold (`/root/reference/src/utils.rs:579-655`):

* ``ln_exp_1p(x)`` ~= ln(1 + e^x) for 0 <= x <= LOGSUMEXP_THRESHOLD_UPPER
  (8 cubic segments),
* ``expf(x)`` ~= e^x for x < 0 (7 cubic segments; exact ``exp`` for x >= 0).

We reproduce those polynomials exactly (same f32 coefficients and breakpoints) but
evaluate them data-parallel as elementwise code: the segment is chosen per element
by comparing against the breakpoint vector, the coefficients are selected, and a
single Horner evaluation runs for the whole tensor.

Reduction order: the reference accumulates terms one by one in program order.
Here we reduce along an axis with a balanced binary tree of the *same* pairwise
combiner (``lse_pair``).  The combiner is symmetric, so the tree is well defined;
re-association changes results only at the level of the cubic-approximation error
(~1e-6 in log space).  Golden tests pin the resulting probabilities against a
streaming-order NumPy oracle at 1e-4 absolute.

Everything is float32; -inf is the additive identity (empty ensemble) and the
combiner skips non-finite inputs exactly like the reference's ``logsumexp``.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import LOGSUMEXP_THRESHOLD_UPPER, NEG_INF

# --- numerics mode -----------------------------------------------------------
#
# Three tiers, one DP implementation (the wavefront scans in models/):
#
# "exact" (default): the reference's piecewise cubics, balanced-tree
#   reductions of the same pairwise combiner.  Identical arithmetic to
#   "parity"; the name is kept for the library default.
# "parity": the same cubics — the tier for bit-level investigations against
#   the Rust reference.
# "fast": hardware transcendentals (`jnp.logaddexp` / `jnp.exp`).
#
# Every tier stays within the 5e-4 golden budget of the oracle.  The mode is
# read at *trace* time.  Every public jitted entry point threads the current
# mode into its static cache key (see models/mccaskill.py, models/durbin.py),
# so switching modes re-traces instead of silently reusing a stale
# compilation.

_VALID_MODES = ("exact", "parity", "fast")
_MODE = os.environ.get("RNA_ALGOS_NUMERICS", "exact")
if _MODE not in _VALID_MODES:
    raise ValueError(
        f"RNA_ALGOS_NUMERICS={_MODE!r}: expected one of {_VALID_MODES}"
    )


def get_mode():
    """Current numerics mode ("exact", "parity" or "fast")."""
    return _MODE


def set_mode(mode):
    """Set the process-wide numerics mode (trace-time effect)."""
    global _MODE
    if mode not in _VALID_MODES:
        raise ValueError(f"numerics mode {mode!r}: expected one of {_VALID_MODES}")
    _MODE = mode


@contextlib.contextmanager
def force_mode(mode):
    """Temporarily pin the numerics mode (used inside jitted bodies at trace
    time so the mode travels with the jit cache key)."""
    global _MODE
    prev = _MODE
    set_mode(mode)
    try:
        yield
    finally:
        _MODE = prev

# --- ln(1 + e^x) piecewise cubics (utils.rs:602-627). Segment k covers
# [BREAKS[k-1], BREAKS[k]); coefficients are (c3, c2, c1, c0) of
# ((c3*x + c2)*x + c1)*x + c0, evaluated with the same nesting as the reference.
_LN_EXP_1P_BREAKS = np.array(
    [0.66153675, 1.6320158, 2.4912589, 3.37925, 4.426169, 5.789071, 7.8162727],
    dtype=np.float32,
)
_LN_EXP_1P_COEFFS = np.array(
    [
        [-0.0065591595, 0.12764427, 0.49965546, 0.6931542],
        [-0.015515756, 0.14467756, 0.48829398, 0.6958093],
        [-0.012890925, 0.13010283, 0.51503986, 0.6795586],
        [-0.0072142647, 0.087754086, 0.6208708, 0.5909676],
        [-0.0031455354, 0.046722945, 0.7592532, 0.43487945],
        [-0.0010110698, 0.018594341, 0.88317305, 0.25236955],
        [-0.000196278, 0.0046084408, 0.9634432, 0.09831489],
        [-0.0000113994, 0.0003734731, 0.9959107, 0.0149855051],
    ],
    dtype=np.float32,
)

# --- e^x piecewise cubics for x < 0 (utils.rs:631-655). Segment k covers
# [EXPF_BREAKS[k-1], EXPF_BREAKS[k]); below the first break the result is 0,
# at or above 0 the exact exp is used.
_EXPF_BREAKS = np.array(
    [-9.91152, -5.8622823, -3.839663, -2.4915035, -1.4805375, -0.6725053, 0.0],
    dtype=np.float32,
)
_EXPF_COEFFS = np.array(
    [
        [0.0, 0.0, 0.0, 0.0],  # x < -9.91152 -> 0
        [0.0000803850, 0.002162743, 0.019470856, 0.058808003],
        [0.0013889414, 0.024467647, 0.14712906, 0.30427578],
        [0.0072335607, 0.09060027, 0.39831114, 0.62459594],
        [0.023241036, 0.2085646, 0.6906368, 0.86823225],
        [0.057378277, 0.35802585, 0.9121133, 0.9793092],
        [0.119917594, 0.48156682, 0.9975992, 0.9999505],
    ],
    dtype=np.float32,
)


def _piecewise_cubic(x, breaks, coeffs):
    """Evaluate a piecewise cubic via per-break coefficient selects.

    Gather-free: each break upgrades the four Horner coefficients with a
    `where` — pure select chains, which XLA fuses into surrounding
    elementwise code.
    """
    x = x.astype(jnp.float32)
    c3 = jnp.full_like(x, float(coeffs[0][0]))
    c2 = jnp.full_like(x, float(coeffs[0][1]))
    c1 = jnp.full_like(x, float(coeffs[0][2]))
    c0 = jnp.full_like(x, float(coeffs[0][3]))
    for k in range(len(breaks)):
        above = x >= float(breaks[k])
        c3 = jnp.where(above, float(coeffs[k + 1][0]), c3)
        c2 = jnp.where(above, float(coeffs[k + 1][1]), c2)
        c1 = jnp.where(above, float(coeffs[k + 1][2]), c1)
        c0 = jnp.where(above, float(coeffs[k + 1][3]), c0)
    return ((c3 * x + c2) * x + c1) * x + c0


def ln_exp_1p(x):
    """CONTRAfold approximation of ln(1 + e^x) for 0 <= x <= 11.862479."""
    return _piecewise_cubic(jnp.asarray(x), _LN_EXP_1P_BREAKS, _LN_EXP_1P_COEFFS)


def expf(x):
    """CONTRAfold approximation of e^x (exact for x >= 0, 0 below -9.91152).

    In "fast" mode: hardware `jnp.exp`."""
    x = jnp.asarray(x, dtype=jnp.float32)
    if _MODE == "fast":
        return jnp.exp(x)
    approx = _piecewise_cubic(x, _EXPF_BREAKS[:-1], _EXPF_COEFFS)
    # Guard the underflow segment explicitly: the all-zero cubic would produce
    # 0 * -inf = NaN for x = -inf.
    approx = jnp.where(x < _EXPF_BREAKS[0], 0.0, approx)
    return jnp.where(x >= 0.0, jnp.exp(x), approx)


def lse_pair(a, b):
    """Symmetric pairwise log-add with the reference's skip/threshold semantics.

    Mirrors `logsumexp` (utils.rs:579-596).  Operands in every DP state are
    finite or -inf (never NaN/+inf), which lets the skip logic collapse to a
    single select: z = max - min is NaN (both -inf) or +inf (one -inf) exactly
    when the finite-pair branch must not be taken, and both compare false
    against the threshold — so `where(z < thresh, min + f(z), max)` returns
    the surviving operand (or -inf) in every skip case and the reference's
    `min + ln_exp_1p(z)` in the finite case.
    """
    a = jnp.asarray(a, dtype=jnp.float32)
    b = jnp.asarray(b, dtype=jnp.float32)
    if _MODE == "fast":
        # jnp.logaddexp already returns the surviving operand (or -inf) when
        # either input is -inf — same skip semantics, hardware exp/log1p.
        return jnp.logaddexp(a, b)
    lo = jnp.minimum(a, b)
    hi = jnp.maximum(a, b)
    z = hi - lo
    # large-z branch is the reference's `y + z` (1-ulp-faithful), except when
    # an operand was -inf (z = inf/nan) where the survivor `hi` is returned
    big = jnp.where(lo > NEG_INF, lo + z, hi)
    return jnp.where(z < LOGSUMEXP_THRESHOLD_UPPER, lo + ln_exp_1p(z), big)


def lse_accumulate(sum_val, x):
    """Streaming accumulate matching `logsumexp(&mut sum, x)` exactly.

    Unlike ``lse_pair`` this is asymmetric: a non-finite ``x`` leaves ``sum``
    unchanged even if ``sum`` itself is non-finite (incl. NaN/inf)."""
    sum_val = jnp.asarray(sum_val, dtype=jnp.float32)
    x = jnp.asarray(x, dtype=jnp.float32)
    return jnp.where(jnp.isfinite(x), lse_pair(sum_val, x), sum_val)


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def lse_reduce(x, axis=-1):
    """Balanced-tree log-sum-exp reduction along ``axis`` using ``lse_pair``.

    The tree has static depth ceil(log2(n)); the axis is padded with -inf
    (the identity). All shapes stay static, so this lowers to elementwise code.
    """
    x = jnp.asarray(x, dtype=jnp.float32)
    axis = axis % x.ndim
    x = jnp.moveaxis(x, axis, -1)
    n = x.shape[-1]
    if n == 0:
        return jnp.full(x.shape[:-1], NEG_INF, dtype=jnp.float32)
    if _MODE == "fast":
        # max-form LSE: one transcendental pass instead of a logaddexp tree
        m = jnp.max(x, axis=-1)
        safe = jnp.where(jnp.isfinite(m), m, 0.0)
        s = jnp.sum(jnp.exp(x - safe[..., None]), axis=-1)
        return jnp.where(jnp.isfinite(m), safe + jnp.log(s), NEG_INF)
    p = _next_pow2(n)
    if p != n:
        pad = jnp.full(x.shape[:-1] + (p - n,), NEG_INF, dtype=jnp.float32)
        x = jnp.concatenate([x, pad], axis=-1)
    while x.shape[-1] > 1:
        half = x.shape[-1] // 2
        x = lse_pair(x[..., :half], x[..., half:])
    return x[..., 0]
