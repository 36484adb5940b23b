#!/usr/bin/env python
"""Run the full accuracy-evaluation pipeline end-to-end (run_all.py analog).

Mirrors `/root/reference/scripts/run_all.py`: dataset -> estimation (both
models x both programs x 18 gammas) -> stats -> figure.  The Rfam 14.3 seed
blob is missing upstream, so the committed dataset is the synthetic seed set
(rna_algos_tpu/eval/synth.py) at assets/synth_rfam_seed.sth — regenerated
here if absent (deterministic).

Artifacts (committed under eval_artifacts/):
  eval_report.json   per-gamma PPV/sens/FPR/F1/MCC for every program column
  fig_1.png          PR/ROC/F1/MCC curve panel (fig_1 analog)

Usage: python scripts/run_eval.py [--sth PATH] [--out DIR] [--families N]
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--sth", default=os.path.join(ROOT, "assets/synth_rfam_seed.sth"))
    ap.add_argument("--out", default=os.path.join(ROOT, "eval_artifacts"))
    ap.add_argument("--work", default=os.path.join(tempfile.gettempdir(), "rna_algos_eval"))
    ap.add_argument("--families", type=int, default=20)
    args = ap.parse_args()

    from rna_algos_tpu.eval import synth
    from rna_algos_tpu.eval.pipeline import run_all

    if not os.path.exists(args.sth):
        n = synth.generate_seed_set(args.sth, n_families=args.families)
        print(f"generated {args.sth}: {n} valid families")

    os.makedirs(args.work, exist_ok=True)
    report = run_all(args.sth, args.work)

    os.makedirs(args.out, exist_ok=True)
    shutil.copy(os.path.join(args.work, "eval_report.json"), args.out)
    fig = os.path.join(args.work, "fig_1.png")
    if os.path.exists(fig):
        shutil.copy(fig, args.out)

    # headline summary: best F1/MCC per program column
    for key, rows in sorted(report["curves"].items()):
        if "_" not in key:
            continue
        best_f1 = max((r["f1"] for r in rows if r["f1"] == r["f1"]), default=float("nan"))
        best_mcc = max((r["mcc"] for r in rows if r["mcc"] == r["mcc"]), default=float("nan"))
        print(json.dumps({
            "column": key, "best_f1": round(best_f1, 4),
            "best_mcc": round(best_mcc, 4),
            "time_s": round(report["timings_s"].get(key, float("nan")), 1),
        }))


if __name__ == "__main__":
    main()
