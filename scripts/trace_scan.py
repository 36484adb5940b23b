"""Trace the headline McCaskill batch on the GPU and reduce the trace.

    python scripts/trace_scan.py [--out DIR] [--runs 3]

Runs the CONTRA and Turner exact-tier programs on the 6 sampled tRNAs tiled
to B = 192 (bucket 96), warms each up, then records ``--runs`` calls under
``jax.profiler``.  From the trace it prints, per model, one JSON line with:

* ``wall_s``: host seconds of the traced calls (each ends in
  ``block_until_ready``);
* ``busy_s`` and ``busy_share``: the union of GPU kernel intervals, and that
  over ``wall_s`` (1 - busy_share is the device idle share);
* ``kernels_per_run`` and ``kernels_per_span_step``: kernel launches per call,
  and that over the 2N scan steps of the inside and outside passes;
* ``top``: the kernels with the most device time.

Needs a GPU.  The raw trace stays under ``--out`` for a closer look.
"""

import argparse
import glob
import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _union_ns(intervals):
    total, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def reduce_trace(path):
    """Kernel events of the GPU planes of one .xplane.pb trace.

    Returns (intervals, names, lines): the (start, end) ns of every kernel
    on a stream line, their names, and {plane/line: event count} for all
    device lines (so an unexpected layout shows in the output)."""
    from jax.profiler import ProfileData

    intervals, names, lines = [], [], {}
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines[f"{plane.name}/{line.name}"] = len(evs)
            if not line.name.startswith("Stream"):
                continue
            for e in evs:
                intervals.append((e.start_ns, e.end_ns))
                names.append(e.name)
    return intervals, names, lines


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=os.path.join(REPO, "chiprun_out",
                                                  "trace_scan"))
    ap.add_argument("--runs", type=int, default=3)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"trace_scan: needs a GPU; JAX found "
                 f"{jax.devices()[0].platform}")
    from rna_algos_tpu.models.mccaskill import mccaskill_bpp_batch
    from rna_algos_tpu.ops import scores as S
    from rna_algos_tpu.params import build_fold_score_sets
    from rna_algos_tpu.parallel.runner import pad_seqs, pick_bucket
    from rna_algos_tpu.utils import read_fasta
    from rna_algos_tpu.utils.compile_cache import enable_compile_cache
    from rna_algos_tpu.utils.trace import device_fields

    enable_compile_cache()
    seqs = [r.seq for r in read_fasta(
        os.path.join(REPO, "assets", "sampled_trnas.fa"))]
    batch = (seqs * 32)[:192]
    N = pick_bucket(max(len(s) for s in batch))
    arr = jnp.asarray(pad_seqs(batch, N))
    ns = jnp.asarray(np.array([len(s) for s in batch], dtype=np.int32))
    for model, contra in (("contra", True), ("turner", False)):
        tbl = (S.contra_table_pytree(build_fold_score_sets()) if contra
               else S.turner_table_pytree())

        def call():
            return jax.block_until_ready(
                mccaskill_bpp_batch(arr, ns, tbl, N=N, contra=contra))

        call()
        out = os.path.join(args.out, model)
        jax.profiler.start_trace(out)
        t0 = time.perf_counter()
        for _ in range(args.runs):
            call()
        wall = time.perf_counter() - t0
        jax.profiler.stop_trace()
        path = sorted(glob.glob(os.path.join(out, "**", "*.xplane.pb"),
                                recursive=True))[-1]
        intervals, names, lines = reduce_trace(path)
        busy = _union_ns(intervals) * 1e-9
        per_name = {}
        for (s, e), name in zip(intervals, names):
            per_name[name] = per_name.get(name, 0) + (e - s)
        top = sorted(per_name.items(), key=lambda kv: -kv[1])[:12]
        print(json.dumps({
            "model": model, "numerics": "exact", "bucket_N": N,
            "batch": len(batch), "runs": args.runs, "wall_s": wall,
            "busy_s": busy, "busy_share": busy / wall,
            "kernels_per_run": len(intervals) / args.runs,
            "kernels_per_span_step": len(intervals) / args.runs / (2 * N),
            "distinct_kernels": len(per_name),
            "top": [[n[:80], t * 1e-9 / args.runs] for n, t in top],
            "lines": lines, **device_fields(),
        }), flush=True)


if __name__ == "__main__":
    main()
