"""CLI: gamma-centroid structure prediction (reference binary analog).

Mirrors `/root/reference/src/bin/centroid_fold.rs`: ``-i`` FASTA, ``-o``
output *directory*, ``-t`` worker hint, ``-c`` CONTRA model, ``-g`` single
gamma (default: the 2^-7..2^10 grid, bin/centroid_fold.rs:9-10,148-161).
BPPs are computed once per sequence and reused across the whole gamma grid
(bin/centroid_fold.rs:117-132,146) — here as one batched MEA fill per gamma.
Each gamma writes ``centroid_threshold={gamma}.fa`` with ``>{index}`` +
dot-bracket records (bin/centroid_fold.rs:165-207).
"""

import argparse
import os
import sys

import numpy as np

from ..models.centroid import DEFAULT_GAMMAS, mea_fill, traceback
from ..parallel.runner import FoldEngine, pick_bucket
from ..utils import read_fasta
from ..utils.output import fold_str, _fmt


def build_parser():
    p = argparse.ArgumentParser(
        prog="centroid_fold", description="gamma-centroid folding"
    )
    p.add_argument("-i", required=True, help="input FASTA file path")
    p.add_argument("-o", required=True, help="output directory path")
    p.add_argument("-t", type=int, default=None, help="worker hint (compat)")
    p.add_argument("-c", action="store_true", help="use the CONTRAfold model")
    p.add_argument("-g", type=float, default=None, help="single gamma")
    p.add_argument(
        "--bpp-cache",
        default=None,
        help="directory for BPP checkpoint/resume (skips the partition "
        "function for already-folded sequences)",
    )
    p.add_argument(
        "--numerics", choices=("exact", "parity", "fast"), default=None,
        help="reference cubics (exact, the default, and parity) or hardware-fast",
    )
    return p


def write_gamma_file(path, results, gamma):
    """One ``centroid_threshold={gamma}.fa``: device fill + host traceback."""
    import jax.numpy as jnp

    lines = []
    n_records = len(results)
    for rna_id, (bpp, _presence, n) in enumerate(results):
        N = pick_bucket(n)
        padded = np.zeros((N, N), dtype=np.float32)
        padded[:n, :n] = bpp
        M = np.asarray(mea_fill(jnp.asarray(padded), gamma, N=N))
        pairs, _ = traceback(M, padded, gamma, n)
        tail = "\n" if rna_id < n_records - 1 else ""
        lines.append(f">{rna_id}\n" + fold_str(pairs, n) + tail)
    with open(path, "w") as f:
        f.write("".join(lines))


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.numerics:
        from .. import numerics

        numerics.set_mode(args.numerics)
    records = read_fasta(args.i)
    engine = FoldEngine(uses_contra_model=args.c)
    if args.bpp_cache:
        from ..utils.checkpoint import BppStore, cached_fold_batch

        folded = cached_fold_batch(
            engine, [r.seq for r in records], BppStore(args.bpp_cache)
        )
    else:
        folded = engine.fold_batch([r.seq for r in records])
    results = [
        (bpp, presence, len(records[k].seq))
        for k, (bpp, presence) in enumerate(folded)
    ]
    os.makedirs(args.o, exist_ok=True)
    gammas = [args.g] if args.g is not None else list(DEFAULT_GAMMAS)
    for gamma in gammas:
        path = os.path.join(args.o, f"centroid_threshold={_fmt(gamma)}.fa")
        write_gamma_file(path, results, gamma)
    return 0


if __name__ == "__main__":
    sys.exit(main())
