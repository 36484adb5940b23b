"""Drop-in parity socket for goldens produced by the REAL Rust reference.

This environment has no cargo toolchain, so outputs of the actual
`heartsh/rna-algos` binaries cannot be generated here (SURVEY §7 risks).  The
day someone runs the reference anywhere, parity becomes a file drop: place the
binaries' outputs under ``tests/golden/reference_rust/`` (layout below) and
these tests activate automatically; they are skipped while the files are
absent.

Expected layout (all produced on ``assets/sampled_trnas.fa``):

    tests/golden/reference_rust/
      mccaskill_turner.txt        mccaskill_algo -i sampled_trnas.fa -o ...
      mccaskill_contra.txt        mccaskill_algo -i sampled_trnas.fa -c -o ...
      durbin.txt                  durbin_algo -i sampled_trnas.fa -o ...
      centroid_turner/            centroid_fold -i sampled_trnas.fa -o dir
        centroid_threshold={g}.fa   (full 2^-7..2^10 gamma grid)
      centroid_contra/            centroid_fold -i sampled_trnas.fa -c -o dir

Comparison contract (matching `/root/reference/src/bin/mccaskill_algo.rs:94-113`,
`bin/durbin_algo.rs:76-89`, `bin/centroid_fold.rs:165-207`):

* mccaskill / durbin triples are written from hashmap iteration, i.e. in
  arbitrary order -> parse both sides into {(i, j): p} and compare values at
  1e-6 absolute; the key sets must be equal.
* centroid dot-bracket files are deterministic -> compared byte-for-byte.
"""

import os
import subprocess
import sys

import pytest

from rna_algos_tpu.utils.output import parse_triples, triples_max_diff

HERE = os.path.dirname(__file__)
REF_DIR = os.path.join(HERE, "golden", "reference_rust")
FASTA = os.path.join(HERE, "..", "assets", "sampled_trnas.fa")

BPP_ATOL = 1e-6


def _run_cli(mod, argv):
    """Run one of our CLIs in-process and return its output file text."""
    return subprocess.run(
        [sys.executable, "-m", mod] + argv,
        check=True, capture_output=True, text=True,
        cwd=os.path.join(HERE, ".."),
    )


def _diff_triples(ref, got):
    assert triples_max_diff(ref, got) <= BPP_ATOL


@pytest.mark.parametrize("model,flag", [("turner", []), ("contra", ["-c"])])
def test_reference_mccaskill_bpps(tmp_path, model, flag):
    ref_file = os.path.join(REF_DIR, f"mccaskill_{model}.txt")
    if not os.path.exists(ref_file):
        pytest.skip("reference-Rust golden not present (file drop socket)")
    out = tmp_path / "out.txt"
    _run_cli(
        "rna_algos_tpu.cli.mccaskill",
        ["-i", FASTA, "-o", str(out)] + flag,
    )
    with open(ref_file) as f:
        ref = parse_triples(f.read())
    got = parse_triples(out.read_text())
    _diff_triples(ref, got)


def test_reference_durbin_probs(tmp_path):
    ref_file = os.path.join(REF_DIR, "durbin.txt")
    if not os.path.exists(ref_file):
        pytest.skip("reference-Rust golden not present (file drop socket)")
    out = tmp_path / "out.txt"
    _run_cli("rna_algos_tpu.cli.durbin", ["-i", FASTA, "-o", str(out)])
    with open(ref_file) as f:
        ref = parse_triples(f.read())
    got = parse_triples(out.read_text())
    _diff_triples(ref, got)


C_BASELINE_DIR = os.path.join(HERE, "golden", "c_baseline")

# Two independent cubic-f32 implementations (the C baseline streams in the
# reference's exact loop order; the XLA parity scan re-associates its LSE
# reductions into trees), so the bound is cubic-amplified float
# re-association — NOT the 1e-6 a deterministic same-binary Rust drop would
# get.  Measured worst diff 2.0e-4 at tRNA scale, consistent with the
# cubics' drift from float64 truth at long n (tests/test_longn_numerics.py);
# budget matches the 5e-4 golden budget for the numerics tiers.
C_BASELINE_ATOL = 5e-4


@pytest.mark.slow
@pytest.mark.parametrize("model,flag", [("turner", []), ("contra", ["-c"])])
def test_c_baseline_socket_selftest(tmp_path, model, flag):
    """Exercise the parity-socket plumbing end to end (VERDICT r3, item 9).

    The real Rust goldens cannot be produced here, so the socket above had
    never fired.  This self-test runs the SAME parse/diff helpers against
    goldens produced by the C baseline (scripts/gen_c_golden.py — the
    reference's recurrences + cubic numerics, oracle-validated bit-exact),
    proving the socket is known-good for the day real Rust files land.
    Runs our CLI in-process under parity numerics (the cubic tier the C
    baseline implements).
    """
    ref_file = os.path.join(C_BASELINE_DIR, f"mccaskill_{model}.txt")
    assert os.path.exists(ref_file), "run scripts/gen_c_golden.py"
    from rna_algos_tpu import numerics
    from rna_algos_tpu.cli import mccaskill as mc_cli

    out = tmp_path / "out.txt"
    prev = numerics.get_mode()
    try:
        mc_cli.main(
            ["-i", FASTA, "-o", str(out), "--numerics", "parity"] + flag
        )
    finally:
        numerics.set_mode(prev)
    with open(ref_file) as f:
        ref = parse_triples(f.read())
    got = parse_triples(out.read_text())
    worst = triples_max_diff(ref, got)
    assert worst <= C_BASELINE_ATOL, worst


@pytest.mark.slow
def test_c_baseline_durbin_socket_selftest(tmp_path):
    """Durbin socket plumbing against oracle-produced goldens (VERDICT r4,
    item 7).  Golden: tests/golden/c_baseline/durbin.txt from
    scripts/gen_c_golden_aux.py (the scalar Durbin oracle — the reference's
    recurrences + streaming cubic-f32 logsumexp order).  Our CLI runs the
    parity tier; the bound is cross-implementation cubic reassociation,
    same budget as the McCaskill self-test."""
    ref_file = os.path.join(C_BASELINE_DIR, "durbin.txt")
    assert os.path.exists(ref_file), "run scripts/gen_c_golden_aux.py"
    from rna_algos_tpu import numerics
    from rna_algos_tpu.cli import durbin as durbin_cli

    out = tmp_path / "out.txt"
    prev = numerics.get_mode()
    try:
        durbin_cli.main(["-i", FASTA, "-o", str(out), "--numerics", "parity"])
    finally:
        numerics.set_mode(prev)
    with open(ref_file) as f:
        ref = parse_triples(f.read())
    got = parse_triples(out.read_text())
    worst = triples_max_diff(ref, got)
    assert worst <= C_BASELINE_ATOL, worst


@pytest.mark.slow
@pytest.mark.parametrize("model,flag", [("turner", []), ("contra", ["-c"])])
def test_c_baseline_centroid_socket_selftest(tmp_path, model, flag):
    """Centroid socket plumbing, byte-for-byte (VERDICT r4, item 7 — the
    north-star surface: dot-bracket identity).  Golden: C-baseline BPPs
    through the scalar MEA fill + traceback oracles
    (scripts/gen_c_golden_aux.py), full gamma grid.  Our CLI computes BPPs
    under parity numerics; byte identity holds as long as the <= 5e-4 BPP
    reassociation band never crosses an MEA decision boundary on this
    fixture (verified at generation time; a knife-edge flip would surface
    here as a structure diff)."""
    ref_dir = os.path.join(C_BASELINE_DIR, f"centroid_{model}")
    assert os.path.isdir(ref_dir), "run scripts/gen_c_golden_aux.py"
    from rna_algos_tpu import numerics
    from rna_algos_tpu.cli import centroid_fold as cf_cli

    out_dir = tmp_path / "centroids"
    prev = numerics.get_mode()
    try:
        cf_cli.main(
            ["-i", FASTA, "-o", str(out_dir), "--numerics", "parity"] + flag
        )
    finally:
        numerics.set_mode(prev)
    ref_files = sorted(os.listdir(ref_dir))
    got_files = sorted(os.listdir(str(out_dir)))
    assert ref_files == got_files
    for name in ref_files:
        with open(os.path.join(ref_dir, name), "rb") as f:
            ref_bytes = f.read()
        with open(os.path.join(str(out_dir), name), "rb") as f:
            got_bytes = f.read()
        assert ref_bytes == got_bytes, name


@pytest.mark.parametrize("model,flag", [("turner", []), ("contra", ["-c"])])
def test_reference_centroid_structures(tmp_path, model, flag):
    ref_dir = os.path.join(REF_DIR, f"centroid_{model}")
    if not os.path.isdir(ref_dir):
        pytest.skip("reference-Rust golden not present (file drop socket)")
    out_dir = tmp_path / "centroids"
    _run_cli(
        "rna_algos_tpu.cli.centroid_fold",
        ["-i", FASTA, "-o", str(out_dir)] + flag,
    )
    ref_files = sorted(os.listdir(ref_dir))
    got_files = sorted(os.listdir(str(out_dir)))
    assert ref_files == got_files
    for name in ref_files:
        with open(os.path.join(ref_dir, name), "rb") as f:
            ref_bytes = f.read()
        with open(os.path.join(str(out_dir), name), "rb") as f:
            got_bytes = f.read()
        assert ref_bytes == got_bytes, name
