"""Tracing / profiling / metrics.

The reference has only whole-batch criterion timing (benches/benches.rs) and
eval-script time deltas (SURVEY §5).  Here: per-phase wall timers with DP
cells/s throughput counters, structured JSONL run logs, and an optional
`jax.profiler` trace context for device timeline capture.
"""

import contextlib
import json
import os
import sys
import time


class PhaseTimer:
    """Named phase timing + derived throughput metrics."""

    def __init__(self):
        self.phases = {}

    @contextlib.contextmanager
    def phase(self, name, cells=None, items=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            rec = self.phases.setdefault(
                name, {"seconds": 0.0, "cells": 0, "items": 0, "calls": 0}
            )
            rec["seconds"] += dt
            rec["calls"] += 1
            if cells:
                rec["cells"] += int(cells)
            if items:
                rec["items"] += int(items)

    def summary(self):
        out = {}
        for name, rec in self.phases.items():
            s = dict(rec)
            if rec["seconds"] > 0:
                if rec["cells"]:
                    s["cells_per_s"] = rec["cells"] / rec["seconds"]
                if rec["items"]:
                    s["items_per_s"] = rec["items"] / rec["seconds"]
            out[name] = s
        return out


def card_name_and_power_limit():
    """``name, power.limit`` of the first GPU as nvidia-smi prints them.

    None where nvidia-smi is missing or fails (no NVIDIA card)."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[0].strip() if lines else None


def device_fields():
    """What every measured line names: the device JAX ran on and its card."""
    import jax

    d = jax.devices()[0]
    return {
        "platform": d.platform,
        "device_kind": d.device_kind,
        "device_count": len(jax.devices()),
        "card": card_name_and_power_limit(),
    }


def dp_cells(n, window=31):
    """DP cell-update count of one McCaskill run: inside + outside wavefronts,
    counting the bounded 2-loop window per pair cell."""
    n = int(n)
    return 2 * (n * n * (window * window) // 2 + n**3 // 6)


@contextlib.contextmanager
def device_trace(log_dir):
    """jax.profiler trace context (TensorBoard-compatible)."""
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


class RunLog:
    """Structured JSONL event log (metrics/observability; SURVEY §5)."""

    def __init__(self, path=None):
        self.path = path or os.environ.get("RNA_ALGOS_RUNLOG")
        self._f = open(self.path, "a") if self.path else None

    def event(self, kind, **fields):
        rec = {"ts": time.time(), "event": kind, **fields}
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        elif os.environ.get("RNA_ALGOS_VERBOSE"):
            print(json.dumps(rec), file=sys.stderr)

    def close(self):
        if self._f:
            self._f.close()
