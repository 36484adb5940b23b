"""One-line McCaskill throughput bench on the GPU.

Criterion-equivalent of `/root/reference/benches/benches.rs:28-55` (whole-batch
McCaskill wall time on the 6 sampled tRNAs): the 6 tRNAs are tiled to a
padded batch of ``BENCH_BATCH`` (default 192), each model runs the full
inside+outside wavefront per sequence, and one JSON line per model reports
sequences/second, timed with ``jax.block_until_ready``.  Every line names the
device it ran on (platform, device_kind, count) and the card's name and power
limit.  The bench refuses to run on the CPU: a CPU number is not a device
metric.

Numerics: ``BENCH_NUMERICS`` (default ``exact``) picks the tier.

Run: python bench.py
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

BATCH = int(os.environ.get("BENCH_BATCH", "192"))
REPS = int(os.environ.get("BENCH_REPS", "20"))
TRIALS = int(os.environ.get("BENCH_TRIALS", "10"))
MODE = os.environ.get("BENCH_NUMERICS", "exact")


def measure(batch, N, contra):
    """Best-of-trials seconds per batch for one (batch, bucket, model)."""
    import jax
    import jax.numpy as jnp

    from rna_algos_tpu.models.mccaskill import mccaskill_bpp_batch
    from rna_algos_tpu.ops import scores as S
    from rna_algos_tpu.params import build_fold_score_sets
    from rna_algos_tpu.parallel.runner import pad_seqs

    arr = jnp.asarray(pad_seqs(batch, N))
    ns = jnp.asarray(np.array([len(s) for s in batch], dtype=np.int32))
    tbl = (
        S.contra_table_pytree(build_fold_score_sets())
        if contra
        else S.turner_table_pytree()
    )
    jax.block_until_ready(mccaskill_bpp_batch(arr, ns, tbl, N=N, contra=contra))

    # enqueue all reps, then wait once: dispatch overlaps device compute as
    # in a serving loop; the min over trials rejects host jitter
    times = []
    for _ in range(TRIALS):
        t0 = time.perf_counter()
        outs = [
            mccaskill_bpp_batch(arr, ns, tbl, N=N, contra=contra)
            for _ in range(REPS)
        ]
        jax.block_until_ready(outs)
        times.append((time.perf_counter() - t0) / REPS)
    return min(times)


def main():
    import jax

    from rna_algos_tpu import numerics
    from rna_algos_tpu.parallel.runner import pick_bucket
    from rna_algos_tpu.utils import read_fasta
    from rna_algos_tpu.utils.compile_cache import enable_compile_cache
    from rna_algos_tpu.utils.trace import device_fields

    if jax.devices()[0].platform != "gpu":
        sys.exit(f"bench.py: no GPU (JAX found {jax.devices()[0].platform})")
    enable_compile_cache()
    numerics.set_mode(MODE)
    dev = device_fields()

    recs = read_fasta(
        os.path.join(os.path.dirname(__file__), "assets/sampled_trnas.fa")
    )
    seqs = [r.seq for r in recs]
    batch = (seqs * (BATCH // len(seqs) + 1))[:BATCH]
    N = pick_bucket(max(len(s) for s in batch))
    for model, contra in (("contra", True), ("turner", False)):
        dt = measure(batch, N, contra)
        print(json.dumps({
            "metric": f"mccaskill_{model}_trna_batch_throughput",
            "value": BATCH / dt,
            "unit": "seqs/s",
            "numerics": MODE,
            "bucket_N": N,
            "batch": BATCH,
            **dev,
        }), flush=True)


if __name__ == "__main__":
    main()
