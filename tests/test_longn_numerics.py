"""Long-n numerics anchors: the wavefront scan against float64 truth.

Pins, against the committed float64 true-math goldens
(tests/golden/longn_f64.npz, generated by scripts/gen_longn_golden.py from
the vectorized f64 oracle — itself validated cell-for-cell against the
scalar brute-force-anchored oracle by tests/test_oracle.py), how far the
reference cubics drift from the truth at n = 245 and n = 768.
"""

import os

import numpy as np
import pytest

import chip_smoke
from rna_algos_tpu.parallel.runner import FoldEngine

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "longn_f64.npz")

pytestmark = pytest.mark.skipif(
    not os.path.exists(GOLDEN),
    reason="long-n f64 goldens not generated (scripts/gen_longn_golden.py)",
)


def _fold(n, contra):
    g = np.load(GOLDEN)
    ((bpp, _),) = FoldEngine(uses_contra_model=contra).fold_batch(
        [g[f"seq_{n}"].astype(np.int32)]
    )
    ref = g[f"bpp_{n}_{'contra' if contra else 'turner'}"]
    return np.abs(bpp - ref).max()


@pytest.mark.slow
@pytest.mark.parametrize("model,contra", [("turner", False), ("contra", True)])
def test_xla_cubics_drift_bound_n245(model, contra):
    """The reference cubics drift from f64 truth at long n (measured on the
    CPU: 7.8e-4 Turner, 1.8e-4 CONTRA at n = 245)."""
    assert _fold(245, contra) < chip_smoke.LONGN_245_ATOL


@pytest.mark.slow
@pytest.mark.parametrize("model,contra", [("turner", False), ("contra", True)])
def test_cubics_error_n768_as_recorded(model, contra):
    """The n = 768 float64 error that chip_smoke.py holds the GPU to is the
    CPU's own, plus its slack."""
    err = _fold(768, contra)
    assert err <= chip_smoke.LONGN_768_CPU_ERR[model] + \
        chip_smoke.LONGN_768_SLACK, err
