"""End-to-end drill of the real-CONTRAfold-weights drop-in path.

The embedded default CONTRA weights are surrogates (PARAMS.md); the
contract is that when the real learned ``contrafold.params.complementary``
file lands, dropping it in via ``RNA_ALGOS_CONTRA_PARAMS`` feeds EVERY
numerics tier consistently with zero code changes.  This test proves that
end to end: it synthesizes a COMPLETE CONTRAfold-format parameter file —
every feature family the reference transfer consumes
(/root/reference/src/mccaskill_algo.rs:60-211), over the full
alphabet/index ranges, with non-trivial randomized weights — loads it
through the env-var file path, and asserts the three numerics tiers of the
wavefront scan agree on BPPs at the golden budget.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from rna_algos_tpu.constants import (
    MAX_INTERIOR_ASYMMETRIC,
    MAX_INTERIOR_EXPLICIT,
    MAX_INTERIOR_SYMMETRIC,
    MAX_LOOP_LEN,
    PSEUDO_BASE,
)
from rna_algos_tpu.params import build_fold_score_sets

BASES = "ACGU"
CANONICAL = ["AU", "UA", "CG", "GC", "GU", "UG"]


def synth_full_params_text(rng, scale=0.25):
    """Every feature family over its full alphabet/index range.

    Weight magnitudes ~N(0, scale) keep the synthesized ensemble physical
    while being far from any embedded default.  Symmetric feature orbits (base_pair,
    helix_stacking strand reversal, internal_explicit) emit ONE canonical
    representative per orbit, as the real learned file does — a second
    random value for the same orbit would make the file self-inconsistent.
    """
    w = lambda: rng.normal(0.0, scale)
    lines = []
    seen_bp = set()
    for p in CANONICAL:
        key = frozenset((p[0], p[1]))
        if key in seen_bp:
            continue
        seen_bp.add(key)
        lines.append(f"base_pair_{p} {w():.6f}")
    for a in BASES:
        for b in BASES:
            for c in BASES:
                for d in BASES:
                    q = a + b + c + d
                    if q <= q[::-1]:  # strand-reversal orbit representative
                        lines.append(f"helix_stacking_{q} {w():.6f}")
    for a in BASES:
        for b in BASES:
            for x in BASES:
                for y in BASES:
                    lines.append(f"terminal_mismatch_{a}{b}{x}{y} {w():.6f}")
    for i in range(0, MAX_LOOP_LEN + 1):
        lines.append(f"hairpin_length_at_least_{i} {w():.6f}")
    for i in range(1, MAX_LOOP_LEN + 1):
        lines.append(f"bulge_length_at_least_{i} {w():.6f}")
    for i in range(2, MAX_LOOP_LEN + 1):
        lines.append(f"internal_length_at_least_{i} {w():.6f}")
    for i in range(1, MAX_INTERIOR_SYMMETRIC + 1):
        lines.append(f"internal_symmetric_length_at_least_{i} {w():.6f}")
    for i in range(1, MAX_INTERIOR_ASYMMETRIC + 1):
        lines.append(f"internal_asymmetry_at_least_{i} {w():.6f}")
    for i in range(1, MAX_INTERIOR_EXPLICIT + 1):
        for j in range(i, MAX_INTERIOR_EXPLICIT + 1):
            lines.append(f"internal_explicit_{i}_{j} {w():.6f}")
    for x in BASES:
        lines.append(f"bulge_0x1_nucleotides_{x} {w():.6f}")
    for x in BASES:
        for y in BASES:
            lines.append(f"internal_1x1_nucleotides_{x}{y} {w():.6f}")
    for a in BASES:
        for b in BASES:
            lines.append(f"helix_closing_{a}{b} {w():.6f}")
    for a in BASES:
        for b in BASES:
            for x in BASES:
                lines.append(f"dangle_left_{a}{b}{x} {w():.6f}")
                lines.append(f"dangle_right_{a}{b}{x} {w():.6f}")
    for name in (
        "multi_base",
        "multi_paired",
        "multi_unpaired",
        "external_paired",
        "external_unpaired",
    ):
        lines.append(f"{name} {w():.6f}")
    # the learned file also carries features this model family does not
    # consume — the loader must skip them silently
    lines.append("log_score_unknown_feature 0.123")
    return "\n".join(lines) + "\n"


@pytest.fixture()
def random_weights_fss(tmp_path, monkeypatch):
    rng = np.random.default_rng(20260821)
    p = tmp_path / "contrafold.params.complementary"
    p.write_text(synth_full_params_text(rng))
    monkeypatch.setenv("RNA_ALGOS_CONTRA_PARAMS", str(p))
    return build_fold_score_sets()


def _batch(B, N, seed):
    rng = np.random.default_rng(seed)
    seqs = np.full((B, N), PSEUDO_BASE, dtype=np.int32)
    ns = np.zeros(B, dtype=np.int32)
    for k in range(B):
        n = N if k == 0 else int(rng.integers(40, N))
        seqs[k, :n] = rng.integers(0, 4, size=n)
        ns[k] = n
    return jnp.asarray(seqs), jnp.asarray(ns)


def test_every_tier_consumes_the_file(random_weights_fss):
    """exact vs parity vs fast numerics of the scan on the same file."""
    from rna_algos_tpu import numerics
    from rna_algos_tpu.models import mccaskill as M
    from rna_algos_tpu.ops import scores as S

    CT = S.contra_table_pytree(random_weights_fss)
    N = 64
    seqs, ns = _batch(4, N, 7)

    bpp = {}
    for mode in ("exact", "parity", "fast"):
        with numerics.force_mode(mode):
            bpp[mode] = np.asarray(
                M.mccaskill_bpp_batch(seqs, ns, CT, N=N, contra=True)[0]
            )
    # golden budget: every tier within 5e-4
    for mode in ("parity", "fast"):
        d = np.abs(bpp["exact"] - bpp[mode]).max()
        assert d < 5e-4, (mode, d)
    # and the weights are demonstrably NOT the defaults
    from rna_algos_tpu.params.contrafold import default_contra_tables

    bpp_def, _ = M.mccaskill_bpp_batch(
        seqs,
        ns,
        S.contra_table_pytree(
            build_fold_score_sets(raw=default_contra_tables())
        ),
        N=N,
        contra=True,
    )
    assert np.abs(bpp["exact"] - np.asarray(bpp_def)).max() > 1e-3


def test_parse_assembly_spot_values(tmp_path, monkeypatch):
    """The randomized file's raw values land in the assembled tables."""
    from rna_algos_tpu.constants import A as iA, C as iC, G as iG, U as iU
    from rna_algos_tpu.params import parse_contrafold_params

    rng = np.random.default_rng(3)
    text = synth_full_params_text(rng)
    t = parse_contrafold_params(text)
    # recover a few named raw values straight from the text
    vals = dict(
        line.split()[:2] for line in text.splitlines() if line.strip()
    )
    assert t["terminal_mismatch_scores"][iC][iG][iA][iA] == np.float32(
        float(vals["terminal_mismatch_CGAA"])
    )
    assert t["dangling_scores_right"][iG][iC][iU] == np.float32(
        float(vals["dangle_right_GCU"])
    )
    assert t["multibranch_score_basepair"] == np.float32(
        float(vals["multi_paired"])
    )
    # strand-reversal symmetrization of the stacking orbit representative
    q = "ACGU"
    assert (
        t["stack_scores"][iA][iC][iG][iU]
        == t["stack_scores"][iU][iG][iC][iA]
    )
