"""Auxiliary subsystems: checkpoint/resume store, tracing, batch engines."""

import numpy as np
import pytest

from rna_algos_tpu.utils.checkpoint import BppStore, cached_fold_batch, fold_key
from rna_algos_tpu.utils.trace import PhaseTimer, dp_cells


class FakeEngine:
    contra = True
    allows_short_hairpins = False

    def __init__(self):
        self.calls = []

    def fold_batch(self, seqs):
        self.calls.append(len(seqs))
        return [
            (np.full((len(s), len(s)), 0.5, np.float32),
             np.ones((len(s), len(s)), bool))
            for s in seqs
        ]


def test_bpp_store_roundtrip(tmp_path):
    store = BppStore(str(tmp_path))
    key = fold_key(np.array([0, 1, 2, 3]), True)
    assert store.get(key) is None
    bpp = np.eye(4, dtype=np.float32)
    store.put(key, bpp, bpp > 0)
    got_bpp, got_pres = store.get(key)
    np.testing.assert_array_equal(got_bpp, bpp)
    assert got_pres.dtype == bool


def test_cached_fold_batch_resumes(tmp_path):
    store = BppStore(str(tmp_path))
    engine = FakeEngine()
    seqs = [np.array([0, 1, 2]), np.array([3, 2, 1, 0])]
    r1 = cached_fold_batch(engine, seqs, store)
    assert engine.calls == [2]
    r2 = cached_fold_batch(engine, seqs, store)
    assert engine.calls == [2]  # second run fully served from the store
    np.testing.assert_array_equal(r1[0][0], r2[0][0])
    # a new sequence only folds the missing one
    seqs.append(np.array([0, 0, 1, 1, 2]))
    cached_fold_batch(engine, seqs, store)
    assert engine.calls == [2, 1]


def test_phase_timer_metrics():
    t = PhaseTimer()
    with t.phase("inside", cells=dp_cells(100), items=4):
        pass
    s = t.summary()["inside"]
    assert s["calls"] == 1 and s["items"] == 4
    assert s["cells"] == dp_cells(100)
    assert "cells_per_s" in s


@pytest.mark.parametrize(
    "stdout,want",
    [
        ("NVIDIA H100 80GB HBM3, 700.00 W\n",
         "NVIDIA H100 80GB HBM3, 700.00 W"),
        ("NVIDIA H100 80GB HBM3, 500.00 W\nNVIDIA H100 80GB HBM3, 700.00 W\n",
         "NVIDIA H100 80GB HBM3, 500.00 W"),
        ("", None),
    ],
)
def test_card_name_and_power_limit_first_card(monkeypatch, stdout, want):
    import subprocess

    from rna_algos_tpu.utils import trace

    def fake_run(cmd, **kw):
        assert cmd[0] == "nvidia-smi"
        return subprocess.CompletedProcess(cmd, 0, stdout=stdout, stderr="")

    monkeypatch.setattr(subprocess, "run", fake_run)
    assert trace.card_name_and_power_limit() == want


def test_card_name_and_power_limit_without_nvidia_smi(monkeypatch):
    import subprocess

    from rna_algos_tpu.utils import trace

    def missing(cmd, **kw):
        raise FileNotFoundError(cmd[0])

    monkeypatch.setattr(subprocess, "run", missing)
    assert trace.card_name_and_power_limit() is None
    fields = trace.device_fields()
    assert fields["card"] is None
    assert fields["platform"] == "cpu" and fields["device_count"] >= 1


def test_debug_nan_checks_env(monkeypatch):
    """RNA_ALGOS_DEBUG=nans activates jax_debug_nans (SURVEY §5 debug config)."""
    import jax

    from rna_algos_tpu.utils import debug

    monkeypatch.setenv("RNA_ALGOS_DEBUG", "nans")
    try:
        active = debug.maybe_enable_from_env()
        assert "nans" in active
        assert jax.config.jax_debug_nans
    finally:
        debug.disable_nan_checks()
    assert not jax.config.jax_debug_nans


def test_check_finite_states_contract():
    import numpy as np
    import pytest

    from rna_algos_tpu.utils.debug import check_finite_states

    ok = {"a": np.array([1.0, -np.inf], dtype=np.float32),
          "ids": np.array([1, 2], dtype=np.int32)}
    check_finite_states(ok)  # finite or -inf: fine
    bad = {"a": np.array([[0.0, np.nan]], dtype=np.float32)}
    with pytest.raises(AssertionError, match="lse_pair operand contract"):
        check_finite_states(bad)
    bad2 = {"a": np.array([np.inf], dtype=np.float32)}
    with pytest.raises(AssertionError):
        check_finite_states(bad2)
