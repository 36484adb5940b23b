"""Batch engines on the plain XLA path: bucket choice, golden BPPs through
``FoldEngine`` at several buckets, and ``AlignEngine`` on uneven pairs."""

import os
import warnings

import numpy as np
import pytest

from rna_algos_tpu.constants import PSEUDO_BASE
from rna_algos_tpu.models import durbin as D
from rna_algos_tpu.models import mccaskill as M
from rna_algos_tpu.params import build_align_scores
from rna_algos_tpu.parallel import runner
from rna_algos_tpu.parallel.runner import AlignEngine, FoldEngine, pick_bucket

from .oracle.durbin_oracle import durbin_oracle

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "trna_bpps.npz")


@pytest.mark.parametrize(
    "n,bucket",
    [(1, 64), (64, 64), (65, 96), (97, 128), (129, 192), (193, 256),
     (257, 384), (385, 512), (513, 640), (768, 768), (1025, 1152),
     (2048, 2048)],
)
def test_pick_bucket_without_power_of_two_promotion(n, bucket):
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert pick_bucket(n) == bucket


def test_pick_bucket_warns_past_2048():
    with pytest.warns(RuntimeWarning, match="2049 exceeds 2048"):
        assert pick_bucket(2049) == 2176


def _record_calls(monkeypatch, module, name):
    """Replace module.name by a stub that records its static sizes and
    returns zeros of the right shape."""
    calls = []

    def fold_stub(seqs, ns, tbl, N, **kw):
        calls.append((seqs.shape[0], N))
        z = np.zeros((seqs.shape[0], N, N), np.float32)
        return z, z > 0

    def align_stub(s1, n1, s2, n2, sc, N1, N2):
        calls.append((s1.shape[0], N1, N2))
        return np.zeros((s1.shape[0], N1, N2), np.float32)

    stub = fold_stub if module is M else align_stub
    monkeypatch.setattr(module, name, stub)
    return calls


def test_fold_engine_buckets_by_length(monkeypatch):
    calls = _record_calls(monkeypatch, M, "mccaskill_bpp_batch")
    rng = np.random.default_rng(0)
    lengths = [70, 90, 100, 150, 600, 80]
    out = FoldEngine().fold_batch(
        [rng.integers(0, 4, size=n).astype(np.int32) for n in lengths]
    )
    assert sorted(calls) == [(1, 128), (1, 192), (1, 640), (3, 96)]
    assert [b.shape for b, _ in out] == [(n, n) for n in lengths]


def test_align_engine_keeps_uneven_buckets(monkeypatch):
    calls = _record_calls(monkeypatch, D, "durbin_match_probs_batch")
    rng = np.random.default_rng(1)
    seqs = [rng.integers(0, 4, size=n).astype(np.int32)
            for n in (60, 150, 90, 300, 180)]
    pairs = [(0, 1), (1, 0), (2, 3), (0, 4)]
    out = AlignEngine().match_probs_pairs(seqs, pairs)
    assert sorted(calls) == [(1, 96, 384), (1, 192, 64), (2, 64, 192)]
    assert out[(2, 3)].shape == (90, 300)


@pytest.mark.parametrize("bucket", [96, 128, 192])
@pytest.mark.parametrize("model,contra", [("turner", False), ("contra", True)])
def test_fold_engine_golden_bpps_at_bucket(monkeypatch, trna_records,
                                           bucket, model, contra):
    monkeypatch.setattr(runner, "BUCKETS", (bucket,))
    seen = []
    real = M.mccaskill_bpp_batch

    def spy(*a, **kw):
        seen.append(kw["N"])
        return real(*a, **kw)

    monkeypatch.setattr(M, "mccaskill_bpp_batch", spy)
    out = FoldEngine(uses_contra_model=contra).fold_batch(
        [r.seq for r in trna_records]
    )
    assert seen == [bucket]
    golden = np.load(GOLDEN)
    for k, (bpp, presence) in enumerate(out):
        ref = golden[f"rec{k}_{model}"]
        assert bpp.shape == ref.shape
        assert np.abs(bpp - ref).max() < 5e-4, (k, np.abs(bpp - ref).max())
        assert presence[bpp > 0].all()


def _wrap(seq):
    return np.concatenate([[PSEUDO_BASE], seq, [PSEUDO_BASE]]).astype(np.int32)


@pytest.mark.parametrize("n1,n2", [(20, 70), (70, 20), (60, 100)])
def test_align_engine_uneven_pairs_vs_oracle(n1, n2):
    rng = np.random.default_rng(n1 * 1000 + n2)
    seqs = [_wrap(rng.integers(0, 4, size=n)) for n in (n1, n2)]
    assert pick_bucket(n1 + 2) != pick_bucket(n2 + 2)
    got = AlignEngine().match_probs_pairs(seqs, [(0, 1)])[(0, 1)]
    ref = durbin_oracle(seqs[0], seqs[1], build_align_scores())
    assert got.shape == ref.shape == (n1 + 2, n2 + 2)
    assert np.abs(got - ref).max() < 2e-4, np.abs(got - ref).max()
