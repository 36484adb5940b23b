"""Batch execution: length bucketing + padded device batches (+ mesh sharding).

Replacement for the reference's L3 batch layer: where the Rust CLIs
spawn one thread-pool task per sequence (bin/mccaskill_algo.rs:64-93) and pick
u8/u16 index width per max length (bin/mccaskill_algo.rs:70-90, SURVEY C17),
we group sequences into static length buckets (one compiled XLA program per
bucket — the index-width specialization analog), pad to the bucket, vmap the
wavefront over the batch, and optionally shard the batch axis over a 1-D
device mesh (parallel/mesh.py).
"""

from functools import partial

import numpy as np
import jax.numpy as jnp

from ..constants import PSEUDO_BASE
from ..models import mccaskill as M
from ..models import durbin as D
from ..ops import scores as S
from ..params import build_fold_score_sets, build_align_scores
from ..utils.compile_cache import enable_compile_cache
from . import mesh as mesh_lib

# Static length buckets (compiled once each); the u8/u16 dispatch analog.
BUCKETS = (64, 96, 128, 192, 256, 384, 512)
# Lengths past this get a warning: the scan still runs, but slowly.
LONG_WARN_LEN = 2048


def pick_bucket(n):
    for b in BUCKETS:
        if n <= b:
            return b
    if n > LONG_WARN_LEN:
        import warnings

        warnings.warn(
            f"sequence length {n} exceeds {LONG_WARN_LEN}: the wavefront "
            "scan is O(n^3) in time and holds about ten dense (N, N) float32 "
            "state tables per sequence in device memory",
            RuntimeWarning,
            stacklevel=2,
        )
    return ((n + 127) // 128) * 128


def pad_seqs(seqs, N):
    out = np.full((len(seqs), N), PSEUDO_BASE, dtype=np.int32)
    for k, s in enumerate(seqs):
        out[k, : len(s)] = s
    return out


class FoldEngine:
    """Cached-table, bucket-compiled McCaskill batch runner."""

    def __init__(self, uses_contra_model=False, allows_short_hairpins=False,
                 fss=None, mesh=None):
        from ..utils.debug import maybe_enable_from_env

        maybe_enable_from_env()
        enable_compile_cache()
        self.contra = bool(uses_contra_model)
        self.allows_short_hairpins = bool(allows_short_hairpins)
        if self.contra:
            self.tbl = S.contra_table_pytree(
                fss if fss is not None else build_fold_score_sets()
            )
        else:
            self.tbl = S.turner_table_pytree()
        self.mesh = mesh
        self._sharded_cache = {}

    def fold_batch(self, seqs):
        """BPPs for a list of int sequences.

        Returns a list of (bpp, presence) numpy arrays cropped to each true
        length, in input order.
        """
        order = sorted(range(len(seqs)), key=lambda k: len(seqs[k]))
        results = [None] * len(seqs)
        by_bucket = {}
        for k in order:
            N = pick_bucket(len(seqs[k]))
            by_bucket.setdefault(N, []).append(k)
        for N, idxs in by_bucket.items():
            arr = pad_seqs([seqs[k] for k in idxs], N)
            ns = np.array([len(seqs[k]) for k in idxs], dtype=np.int32)
            if self.mesh is not None:
                ndev = self.mesh.devices.size
                (arr, ns), true_b = mesh_lib.pad_to_multiple(
                    (arr, ns),
                    ndev,
                    (np.full((N,), PSEUDO_BASE, dtype=np.int32), np.int32(1)),
                )
                arr, ns = mesh_lib.shard_batch(self.mesh, arr, ns)
            else:
                true_b = len(idxs)
            if self.mesh is None:
                bpp, presence = M.mccaskill_bpp_batch(
                    jnp.asarray(arr), jnp.asarray(ns), self.tbl, N=N,
                    contra=self.contra,
                    allows_short_hairpins=self.allows_short_hairpins,
                )
            else:
                # each device runs the scan on its shard; the wrapped
                # callable is cached per bucket to avoid re-tracing
                sharded = self._sharded_cache.get(N)
                if sharded is None:
                    fn = partial(
                        M.mccaskill_bpp_batch, tbl=self.tbl, N=N,
                        contra=self.contra,
                        allows_short_hairpins=self.allows_short_hairpins,
                    )
                    sharded = mesh_lib.shard_map_batch(fn, self.mesh)
                    self._sharded_cache[N] = sharded
                bpp, presence = sharded(jnp.asarray(arr), jnp.asarray(ns))
            bpp = np.asarray(bpp)[:true_b]
            presence = np.asarray(presence)[:true_b]
            for slot, k in enumerate(idxs):
                n = len(seqs[k])
                results[k] = (bpp[slot, :n, :n], presence[slot, :n, :n])
        return results


class AlignEngine:
    """Bucket-compiled Durbin batch runner over sequence pairs."""

    def __init__(self, align_scores=None, mesh=None):
        enable_compile_cache()
        sc = align_scores if align_scores is not None else build_align_scores()
        self.sc = {k: jnp.asarray(v) for k, v in sc.items()}
        self.mesh = mesh

    def match_probs_pairs(self, seqs, pairs):
        """Posterior match probs for (i, j) index pairs of sentinel-wrapped seqs.

        ``seqs`` must already include the PSEUDO_BASE sentinels
        (bin/durbin_algo.rs:49-50). Returns {pair: probs[n1, n2]}.
        """
        results = {}
        by_bucket = {}
        for (a, b) in pairs:
            key = (pick_bucket(len(seqs[a])), pick_bucket(len(seqs[b])))
            by_bucket.setdefault(key, []).append((a, b))
        for (N1, N2), plist in by_bucket.items():
            s1 = pad_seqs([seqs[a] for a, _ in plist], N1)
            n1 = np.array([len(seqs[a]) for a, _ in plist], dtype=np.int32)
            s2 = pad_seqs([seqs[b] for _, b in plist], N2)
            n2 = np.array([len(seqs[b]) for _, b in plist], dtype=np.int32)
            true_b = len(plist)
            if self.mesh is not None:
                ndev = self.mesh.devices.size
                (s1, n1, s2, n2), true_b = mesh_lib.pad_to_multiple(
                    (s1, n1, s2, n2),
                    ndev,
                    (
                        np.full((N1,), PSEUDO_BASE, dtype=np.int32),
                        np.int32(3),
                        np.full((N2,), PSEUDO_BASE, dtype=np.int32),
                        np.int32(3),
                    ),
                )
                s1, n1, s2, n2 = mesh_lib.shard_batch(self.mesh, s1, n1, s2, n2)
            probs = np.asarray(
                D.durbin_match_probs_batch(
                    jnp.asarray(s1), jnp.asarray(n1), jnp.asarray(s2),
                    jnp.asarray(n2), self.sc, N1=N1, N2=N2,
                )
            )[:true_b]
            for slot, (a, b) in enumerate(plist):
                results[(a, b)] = probs[slot, : len(seqs[a]), : len(seqs[b])]
        return results
