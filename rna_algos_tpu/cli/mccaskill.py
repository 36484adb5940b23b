"""CLI: basepair probabilities (drop-in analog of the reference binary).

Mirrors `/root/reference/src/bin/mccaskill_algo.rs` flags and output layout:
``-i`` FASTA in, ``-o`` text out, ``-t`` worker hint (accepted for
compatibility; parallelism is the device batch), ``-c`` CONTRA model.  Output:
the same header comment, then ``>{record index}`` blocks of ``i,j,p `` triples
(bin/mccaskill_algo.rs:94-113) — emitted in deterministic (i, j) order where
the reference iterates a hashmap.
"""

import argparse
import sys

import numpy as np

from ..parallel.runner import FoldEngine
from ..utils import read_fasta
from ..utils.output import probs2str_arrays

HEADER = (
    "# Format = >{RNA sequence id} {line break} {basepairing left nucleotide}, "
    "{basepairing right nucleotide}, {basepairing probability} ..."
)


def build_parser():
    p = argparse.ArgumentParser(
        prog="mccaskill", description="McCaskill basepair probabilities"
    )
    p.add_argument("-i", required=True, help="input FASTA file path")
    p.add_argument("-o", required=True, help="output file path")
    p.add_argument("-t", type=int, default=None, help="worker hint (compat)")
    p.add_argument("-c", action="store_true", help="use the CONTRAfold model")
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
    engine = FoldEngine(uses_contra_model=args.c)
    results = engine.fold_batch([r.seq for r in records])
    parts = [HEADER]
    for rna_id, (bpp, presence) in enumerate(results):
        iv, jv = np.nonzero(presence)  # row-major, deterministic
        parts.append(
            f"\n\n>{rna_id}\n" + probs2str_arrays(iv, jv, bpp[iv, jv])
        )
    with open(args.o, "w") as f:
        f.write("".join(parts))
    return 0


if __name__ == "__main__":
    sys.exit(main())
