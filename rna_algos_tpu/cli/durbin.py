"""CLI: pairwise posterior match probabilities (reference binary analog).

Mirrors `/root/reference/src/bin/durbin_algo.rs`: ``-i`` FASTA, ``-o`` text
out, ``-t`` worker hint.  Every unordered record pair (i < j) is scored
(bin/durbin_algo.rs:58-63); sequences get PSEUDO_BASE sentinels at both ends
(:49-50); output triples subtract the sentinel offset and keep only p > 0
(:76-89), iterated row-major exactly like the reference's dense matrix walk.
"""

import argparse
import sys

import numpy as np

from ..constants import PSEUDO_BASE
from ..parallel.runner import AlignEngine
from ..utils import read_fasta
from ..utils.output import probs2str_arrays

HEADER = (
    "# Format = >{RNA sequence id 1},{RNA sequence id 2} {line break} "
    "{nucleotide 1}, {nucleotide 2}, {nucletide matching probability} ..."
)


def build_parser():
    p = argparse.ArgumentParser(
        prog="durbin", description="pair-HMM match probabilities"
    )
    p.add_argument("-i", required=True, help="input FASTA file path")
    p.add_argument("-o", required=True, help="output file path")
    p.add_argument("-t", type=int, default=None, help="worker hint (compat)")
    p.add_argument(
        "--numerics", choices=("exact", "parity", "fast"), default=None,
        help="reference cubics (exact, the default, and parity) or hardware-fast",
    )
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.numerics:
        from .. import numerics

        numerics.set_mode(args.numerics)
    records = read_fasta(args.i)
    wrapped = [
        np.concatenate([[PSEUDO_BASE], r.seq, [PSEUDO_BASE]]).astype(np.int32)
        for r in records
    ]
    pairs = [
        (i, j) for i in range(len(records)) for j in range(i + 1, len(records))
    ]
    engine = AlignEngine()
    probs = engine.match_probs_pairs(wrapped, pairs)
    parts = [HEADER]
    for (a, b) in pairs:
        mat = probs[(a, b)]
        iv, jv = np.nonzero(mat > 0.0)  # row-major, like the reference walk
        parts.append(
            f"\n\n>{a},{b}\n"
            + probs2str_arrays(iv - 1, jv - 1, mat[iv, jv])
        )
    with open(args.o, "w") as f:
        f.write("".join(parts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
