"""Scalar float32 oracle of the reference log-space numerics (test-only).

Independent straightforward implementation of the CONTRAfold piecewise-cubic
approximations and the streaming logsumexp with the exact semantics of
`/root/reference/src/utils.rs:579-655`, used to validate the vectorized JAX
numerics and to generate golden DP values. All arithmetic in np.float32.

A **float64 true-math mode** (``f64_mode()``) swaps the cubics for
`np.logaddexp`/`np.exp` and widens every accumulator to float64 — the
ground-truth anchor tier (VERDICT round 1, item 8): with it, the oracle
recurrences are validated against brute-force enumeration free of the cubic
approximation error, so the anchor tolerance drops from 1e-3 to 1e-6.
Scores remain the f32 table values in both modes (shared with brute force).
"""

import contextlib

import numpy as np

_F64 = False


def set_f64(on):
    global _F64
    _F64 = bool(on)


@contextlib.contextmanager
def f64_mode():
    """True-math float64 oracle tier (see module docstring)."""
    global _F64
    prev = _F64
    _F64 = True
    try:
        yield
    finally:
        _F64 = prev


def F(x):
    """Working-precision conversion (f32 reference semantics; f64 in f64_mode)."""
    return np.float64(x) if _F64 else np.float32(x)


def DT():
    """Working dtype for oracle state arrays."""
    return np.float64 if _F64 else np.float32


THRESH = np.float32(11.862479)


def ln_exp_1p(x):
    x = np.float32(x)
    if x < F(3.37925):
        if x < F(1.6320158):
            if x < F(0.66153675):
                return ((F(-0.0065591595) * x + F(0.12764427)) * x + F(0.49965546)) * x + F(0.6931542)
            return ((F(-0.015515756) * x + F(0.14467756)) * x + F(0.48829398)) * x + F(0.6958093)
        if x < F(2.4912589):
            return ((F(-0.012890925) * x + F(0.13010283)) * x + F(0.51503986)) * x + F(0.6795586)
        return ((F(-0.0072142647) * x + F(0.087754086)) * x + F(0.6208708)) * x + F(0.5909676)
    if x < F(5.789071):
        if x < F(4.426169):
            return ((F(-0.0031455354) * x + F(0.046722945)) * x + F(0.7592532)) * x + F(0.43487945)
        return ((F(-0.0010110698) * x + F(0.018594341)) * x + F(0.88317305)) * x + F(0.25236955)
    if x < F(7.8162727):
        return ((F(-0.000196278) * x + F(0.0046084408)) * x + F(0.9634432)) * x + F(0.09831489)
    return ((F(-0.0000113994) * x + F(0.0003734731)) * x + F(0.9959107)) * x + F(0.0149855051)


def expf(x):
    if _F64:
        return np.exp(np.float64(x))
    x = np.float32(x)
    if x < F(-2.4915035):
        if x < F(-5.8622823):
            if x < F(-9.91152):
                return F(0.0)
            return ((F(0.0000803850) * x + F(0.002162743)) * x + F(0.019470856)) * x + F(0.058808003)
        if x < F(-3.839663):
            return ((F(0.0013889414) * x + F(0.024467647)) * x + F(0.14712906)) * x + F(0.30427578)
        return ((F(0.0072335607) * x + F(0.09060027)) * x + F(0.39831114)) * x + F(0.62459594)
    if x < F(-0.6725053):
        if x < F(-1.4805375):
            return ((F(0.023241036) * x + F(0.2085646)) * x + F(0.6906368)) * x + F(0.86823225)
        return ((F(0.057378277) * x + F(0.35802585)) * x + F(0.9121133)) * x + F(0.9793092)
    if x < F(0.0):
        return ((F(0.119917594) * x + F(0.48156682)) * x + F(0.9975992)) * x + F(0.9999505)
    return F(np.exp(x, dtype=np.float32))


def logsumexp(s, x):
    """Streaming accumulate: returns the new sum (reference mutates in place)."""
    s, x = F(s), F(x)
    if not np.isfinite(x):
        return s
    if not np.isfinite(s):
        return x
    if _F64:
        return np.logaddexp(s, x)
    y = min(s, x)
    z = F(max(s, x) - y)
    if z >= THRESH:
        return F(y + z)
    return F(y + ln_exp_1p(z))


def lse_stream(values):
    """Fold a sequence of terms in order, starting from -inf."""
    s = F(-np.inf)
    for v in values:
        s = logsumexp(s, v)
    return s
