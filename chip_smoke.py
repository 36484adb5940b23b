#!/usr/bin/env python
"""Smoke run of the main path on one GPU, checked against the repo's goldens.

    python chip_smoke.py                # one card: phases 1-4
    python chip_smoke.py --four-cards   # 4-GPU data mesh vs one card, only

Phases, all float32 (the main path has no matrix product, so it sets no
matmul precision):

1. headline: ``FoldEngine`` on the 6 sampled tRNAs tiled to B = 192, CONTRA
   and Turner in all three numerics tiers, plus CONTRA with short hairpins,
   against ``tests/golden/trna_bpps.npz``;
2. rfam: one N = 256, B = 96 batch (the n = 245 float64-golden sequence and
   seeded 150-200 nt fillers) against float64 truth, and its first
   ``B_CPU`` sequences against the same scan on the CPU;
3. long n: n = 768 through ``FoldEngine`` (bucket 768), both models, against
   float64 truth;
4. the CLIs end to end (parity tier) against ``tests/golden/c_baseline/``.

Each check prints its value beside its limit, each phase its seconds.  The
last line of standard output is one JSON object naming the device, printed
only when every check passed.  Without a GPU the script exits non-zero
before any phase runs.
"""

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

from rna_algos_tpu import numerics
from rna_algos_tpu.parallel.runner import AlignEngine, FoldEngine, pad_seqs

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(REPO, "tests", "golden")
FASTA = os.path.join(REPO, "assets", "sampled_trnas.fa")

B_HEADLINE = 192
B_RFAM = 96
# The whole B = 96 batch took 345 s (CONTRA) and 500 s (Turner) on the
# 16-core CPU of an H100 host, past the smoke run's time limit; the first
# eight sequences (the n = 245 one among them) take about a twelfth of that.
B_CPU = 8
# golden budget of every numerics tier (tests/test_golden.py)
GOLDEN_ATOL = 5e-4
# cubic drift bound against float64 at n = 245 (tests/test_longn_numerics.py)
LONGN_245_ATOL = 5e-3
# float64-truth error of the exact-tier scan at n = 768, measured on the CPU
# (tests/test_longn_numerics.py pins the same numbers).  On an H100 (400 W
# limit) the Turner error came out 1.2e-5 above the CPU's: float32 rounding
# differs between the two compilers, and at n = 768 the cubics amplify it.
LONGN_768_CPU_ERR = {"contra": 2.7368949e-4, "turner": 2.4662072e-2}
LONGN_768_SLACK = 5e-5
# the N = 256 scan on the GPU and on the CPU: float32 rounding differs, and
# the cubic LSE chain amplifies it; the whole B = 96 batch measured 1.01e-4
# (CONTRA) and 5.4e-5 (Turner) on an H100 (400 W limit)
GPU_VS_CPU_ATOL = 2e-4
# CLI outputs against the C baseline (tests/test_reference_golden.py)
CLI_ATOL = 5e-4
# the batch sharded over four cards against one card
MESH_ATOL = 1e-6

MODELS = (("contra", True), ("turner", False))
TIERS = ("exact", "parity", "fast")


def max_abs_diff(a, b):
    """max |a - b|; inf when either side holds a non-finite value."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shapes differ: {a.shape} vs {b.shape}")
    if not (np.isfinite(a).all() and np.isfinite(b).all()):
        return float("inf")
    return float(np.abs(a - b).max()) if a.size else 0.0


def last_line(devices):
    """The JSON object that ends a passing run."""
    return json.dumps({
        "ok": True,
        "device": {
            "platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices),
        },
    })


def require_gpu(count):
    """jax.devices() when it holds at least ``count`` GPUs; exit otherwise."""
    import jax

    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(
            f"chip_smoke: needs a GPU; JAX found {devices[0].platform}"
        )
    if len(devices) < count:
        raise SystemExit(
            f"chip_smoke: needs {count} GPUs; JAX found {len(devices)}"
        )
    return devices


class Checks:
    """Prints every check and phase; remembers what failed."""

    def __init__(self):
        self.failed = []

    def check(self, name, value, limit, what="max|d|"):
        ok = value <= limit
        print(f"  {name}: {what} {value!r} limit {limit!r} "
              f"{'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            self.failed.append(name)
        return ok

    @contextlib.contextmanager
    def phase(self, name):
        print(f"[{name}]", flush=True)
        t0 = time.perf_counter()
        try:
            yield
        except Exception:
            traceback.print_exc()
            print(f"  {name}: raised FAIL", flush=True)
            self.failed.append(f"{name} raised")
        print(f"[{name}] {time.perf_counter() - t0:.2f} s", flush=True)


def first_and_second(label, fn):
    """Call ``fn`` twice; print the seconds of both (the first compiles)."""
    t0 = time.perf_counter()
    fn()
    t1 = time.perf_counter()
    out = fn()
    t2 = time.perf_counter()
    print(f"  {label}: first call {t1 - t0:.3f} s (compile + run), "
          f"second {t2 - t1:.3f} s (run)", flush=True)
    return out


def _trna_batch():
    from rna_algos_tpu.utils import read_fasta

    seqs = [r.seq for r in read_fasta(FASTA)]
    return seqs, (seqs * (B_HEADLINE // len(seqs) + 1))[:B_HEADLINE]


def _headline_memory(batch):
    """Compile the CONTRA exact-tier headline program; print its memory."""
    import jax
    import jax.numpy as jnp

    from rna_algos_tpu.models.mccaskill import mccaskill_bpp_batch
    from rna_algos_tpu.ops import scores as S
    from rna_algos_tpu.params import build_fold_score_sets
    from rna_algos_tpu.parallel.runner import pick_bucket

    N = pick_bucket(max(len(s) for s in batch))
    arr = jnp.asarray(pad_seqs(batch, N))
    ns = jnp.asarray(np.array([len(s) for s in batch], dtype=np.int32))
    tbl = S.contra_table_pytree(build_fold_score_sets())
    t0 = time.perf_counter()
    compiled = jax.jit(
        lambda s, n, t: mccaskill_bpp_batch(s, n, t, N=N, contra=True)
    ).lower(arr, ns, tbl).compile()
    print(f"  headline program (CONTRA exact, N={N}, B={len(batch)}): "
          f"compile {time.perf_counter() - t0:.3f} s", flush=True)
    print(f"  memory_analysis: {compiled.memory_analysis()}", flush=True)


def phase_headline(c):
    recs, batch = _trna_batch()
    golden = np.load(os.path.join(GOLDEN, "trna_bpps.npz"))
    _headline_memory(batch)
    runs = [(key, contra, False, tier)
            for key, contra in MODELS for tier in TIERS]
    runs.append(("contra_ash", True, True, "exact"))
    for key, contra, ash, tier in runs:
        numerics.set_mode(tier)
        eng = FoldEngine(uses_contra_model=contra, allows_short_hairpins=ash)
        out = first_and_second(f"{key} {tier}", lambda: eng.fold_batch(batch))
        err = max(
            max_abs_diff(bpp, golden[f"rec{k % len(recs)}_{key}"])
            for k, (bpp, _) in enumerate(out)
        )
        c.check(f"{key} {tier} B={len(batch)} vs golden", err, GOLDEN_ATOL)
    numerics.set_mode("exact")


def phase_rfam(c):
    import jax

    from rna_algos_tpu.models.mccaskill import mccaskill_bpp_batch
    from rna_algos_tpu.ops import scores as S
    from rna_algos_tpu.params import build_fold_score_sets

    g = np.load(os.path.join(GOLDEN, "longn_f64.npz"))
    rng = np.random.RandomState(0)
    fillers = [
        rng.randint(0, 4, size=rng.randint(150, 201)).astype(np.int32)
        for _ in range(B_RFAM - 1)
    ]
    batch = [g["seq_245"].astype(np.int32)] + fillers
    arr = pad_seqs(batch, 256)
    ns = np.array([len(s) for s in batch], dtype=np.int32)
    cpu = jax.devices("cpu")[0]
    for key, contra in MODELS:
        tbl = (S.contra_table_pytree(build_fold_score_sets()) if contra
               else S.turner_table_pytree())

        def run(dev, b=len(batch)):
            s, n, t = jax.device_put((arr[:b], ns[:b], tbl), dev)
            return np.asarray(
                mccaskill_bpp_batch(s, n, t, N=256, contra=contra)[0]
            )

        bpp = first_and_second(f"{key} N=256 B={len(batch)}",
                               lambda: run(None))
        c.check(f"{key} n=245 vs float64",
                max_abs_diff(bpp[0, :245, :245], g[f"bpp_245_{key}"]),
                LONGN_245_ATOL)
        t0 = time.perf_counter()
        bpp_cpu = run(cpu, B_CPU)
        print(f"  {key} first {B_CPU} on the CPU: "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
        c.check(f"{key} N=256 first {B_CPU} GPU vs CPU",
                max_abs_diff(bpp[:B_CPU], bpp_cpu), GPU_VS_CPU_ATOL)


def phase_longn(c):
    from rna_algos_tpu.parallel.runner import pick_bucket

    g = np.load(os.path.join(GOLDEN, "longn_f64.npz"))
    seq = g["seq_768"].astype(np.int32)
    print(f"  bucket {pick_bucket(len(seq))}", flush=True)
    for key, contra in MODELS:
        eng = FoldEngine(uses_contra_model=contra)
        ((bpp, _),) = first_and_second(f"{key} n=768",
                                       lambda: eng.fold_batch([seq]))
        c.check(f"{key} n=768 vs float64",
                max_abs_diff(bpp, g[f"bpp_768_{key}"]),
                LONGN_768_CPU_ERR[key] + LONGN_768_SLACK)


def _timed(label, fn):
    t0 = time.perf_counter()
    fn()
    print(f"  {label}: {time.perf_counter() - t0:.3f} s", flush=True)


def phase_clis(c):
    from rna_algos_tpu.cli import centroid_fold, durbin, mccaskill
    from rna_algos_tpu.utils.output import parse_triples, triples_max_diff

    ref_dir = os.path.join(GOLDEN, "c_baseline")

    def read(path):
        with open(path) as f:
            return f.read()

    parity = ["-i", FASTA, "--numerics", "parity"]
    with tempfile.TemporaryDirectory() as tmp:
        for key, flag in (("turner", []), ("contra", ["-c"])):
            out = os.path.join(tmp, f"mccaskill_{key}.txt")
            _timed(f"cli.mccaskill {key}",
                   lambda: mccaskill.main(parity + ["-o", out] + flag))
            c.check(f"cli.mccaskill {key} vs c_baseline",
                    triples_max_diff(
                        parse_triples(read(os.path.join(
                            ref_dir, f"mccaskill_{key}.txt"))),
                        parse_triples(read(out))),
                    CLI_ATOL)
        out = os.path.join(tmp, "durbin.txt")
        _timed("cli.durbin", lambda: durbin.main(parity + ["-o", out]))
        c.check("cli.durbin vs c_baseline",
                triples_max_diff(
                    parse_triples(read(os.path.join(ref_dir, "durbin.txt"))),
                    parse_triples(read(out))),
                CLI_ATOL)
        for key, flag in (("turner", []), ("contra", ["-c"])):
            out = os.path.join(tmp, f"centroid_{key}")
            _timed(f"cli.centroid_fold {key}",
                   lambda: centroid_fold.main(parity + ["-o", out] + flag))
            ref = os.path.join(ref_dir, f"centroid_{key}")
            names = sorted(os.listdir(ref))
            if sorted(os.listdir(out)) != names:
                raise ValueError(f"centroid {key}: file names differ")
            differ = sum(
                read(os.path.join(ref, name)) != read(os.path.join(out, name))
                for name in names
            )
            c.check(f"cli.centroid_fold {key}: {len(names)} gamma files",
                    differ, 0, what="files not byte-identical")
    numerics.set_mode("exact")


def phase_four_cards(c, devices):
    from rna_algos_tpu.constants import PSEUDO_BASE
    from rna_algos_tpu.parallel.mesh import data_mesh

    mesh = data_mesh(devices[:4])
    _, batch = _trna_batch()
    for key, contra in MODELS:
        one = first_and_second(
            f"{key} one card",
            lambda: FoldEngine(uses_contra_model=contra).fold_batch(batch))
        eng = FoldEngine(uses_contra_model=contra, mesh=mesh)
        four = first_and_second(f"{key} four cards",
                                lambda: eng.fold_batch(batch))
        c.check(f"FoldEngine {key} four cards vs one",
                max(max_abs_diff(a, b) for (a, _), (b, _) in zip(one, four)),
                MESH_ATOL)
        c.check(f"FoldEngine {key} presence four cards vs one",
                sum(int((pa != pb).sum())
                    for (_, pa), (_, pb) in zip(one, four)),
                0, what="cells differ")
    wrapped = [
        np.concatenate([[PSEUDO_BASE], s, [PSEUDO_BASE]]).astype(np.int32)
        for s in batch
    ]
    pairs = [(k, (k + 1) % len(batch)) for k in range(len(batch))]
    one = first_and_second(
        "AlignEngine one card",
        lambda: AlignEngine().match_probs_pairs(wrapped, pairs))
    eng = AlignEngine(mesh=mesh)
    four = first_and_second("AlignEngine four cards",
                            lambda: eng.match_probs_pairs(wrapped, pairs))
    c.check(f"AlignEngine {len(pairs)} pairs four cards vs one",
            max(max_abs_diff(one[p], four[p]) for p in pairs), MESH_ATOL)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument(
        "--four-cards", action="store_true",
        help="run only the 4-GPU data-mesh phase against one card",
    )
    args = ap.parse_args(argv)
    devices = require_gpu(4 if args.four_cards else 1)

    from rna_algos_tpu.utils.compile_cache import enable_compile_cache
    from rna_algos_tpu.utils.trace import card_name_and_power_limit

    print(f"compile cache: {enable_compile_cache()}", flush=True)
    print(f"devices: {len(devices)} x {devices[0].device_kind}", flush=True)
    c = Checks()
    t0 = time.perf_counter()
    if args.four_cards:
        with c.phase("four cards"):
            phase_four_cards(c, devices)
    else:
        for name, fn in (("headline", phase_headline), ("rfam", phase_rfam),
                         ("long n", phase_longn), ("clis", phase_clis)):
            with c.phase(name):
                fn(c)
    print(f"total {time.perf_counter() - t0:.2f} s", flush=True)
    print(f"card: {card_name_and_power_limit()}", flush=True)
    if c.failed:
        print(f"chip_smoke: FAILED: {c.failed}", file=sys.stderr)
        return 1
    print(last_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
