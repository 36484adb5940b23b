"""Device-mesh data parallelism for batch folding.

The reference's only parallelism is a scoped thread pool with one task per
sequence (`/root/reference/src/bin/mccaskill_algo.rs:58,64-93`; SURVEY C16).
Here it is a 1-D ``data`` mesh over all devices: padded batches are
sharded along the batch axis with `NamedSharding`, every chip runs the same
compiled wavefront program on its shard, score tables are replicated, and the
only collective is the implicit result gather — nothing inside the DP loop.

Multi-host: `initialize_distributed()` wires `jax.distributed` when driver
env vars are present; the mesh then spans all processes' devices and each
host feeds its local shard (see parallel/runner.py).
"""

import os

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_distributed():
    """Call jax.distributed.initialize() when running under a multi-host driver.

    The decision is made from environment variables ONLY — touching the jax
    backend (e.g. `jax.process_count()`) before `jax.distributed.initialize()`
    would initialize a single-process backend and make the subsequent
    multi-host initialize ineffective.  The driver contract mirrors jax's own:
    a coordinator address plus process count/id (either the JAX_* spellings or
    an explicit RNA_ALGOS_DISTRIBUTED=1).  No-op in single-process runs.
    """
    coord = os.environ.get("JAX_COORDINATOR_ADDRESS")
    explicit = os.environ.get("RNA_ALGOS_DISTRIBUTED") == "1"
    if not coord and not explicit:
        return False
    nprocs = os.environ.get("JAX_NUM_PROCESSES")
    if nprocs is not None and int(nprocs) <= 1 and not explicit:
        return False
    kwargs = {}
    if coord:
        kwargs["coordinator_address"] = coord
    if nprocs is not None:
        kwargs["num_processes"] = int(nprocs)
    pid = os.environ.get("JAX_PROCESS_ID")
    if pid is not None:
        kwargs["process_id"] = int(pid)
    jax.distributed.initialize(**kwargs)
    return True


def data_mesh(devices=None):
    """1-D mesh over all (or the given) devices with a single 'data' axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.array(devices), ("data",))


def batch_sharding(mesh, ndim):
    """Shard axis 0 over 'data', replicate the rest."""
    return NamedSharding(mesh, P("data", *([None] * (ndim - 1))))


def shard_batch(mesh, *arrays):
    """Place each array with its batch axis sharded over the mesh."""
    return tuple(
        jax.device_put(a, batch_sharding(mesh, a.ndim)) for a in arrays
    )


def shard_map_batch(fn, mesh):
    """Wrap a batch function so each device runs it on its batch shard.

    shard_map hands each device a local batch; the only collective is the
    output gather (off the DP critical path, SURVEY §5).  The result is
    jitted: called bare, shard_map retraces ``fn`` on every call.
    """
    return jax.jit(jax.shard_map(
        fn,
        mesh=mesh,
        in_specs=(P("data"), P("data")),
        out_specs=(P("data"), P("data")),
        check_vma=False,
    ))


def pad_to_multiple(arrays, multiple, pad_rows):
    """Pad axis 0 of each array to a multiple (dummy rows from ``pad_rows``)."""
    b = arrays[0].shape[0]
    rem = (-b) % multiple
    if rem == 0:
        return arrays, b
    out = []
    for a, pad_row in zip(arrays, pad_rows):
        pad = np.broadcast_to(pad_row, (rem,) + a.shape[1:])
        out.append(np.concatenate([a, pad], axis=0))
    return tuple(out), b
