"""Data-mesh sharded execution matches unsharded (virtual 8-device CPU mesh)."""

import numpy as np
import jax
import pytest

from rna_algos_tpu.constants import PSEUDO_BASE
from rna_algos_tpu.parallel import mesh as mesh_lib
from rna_algos_tpu.parallel.runner import AlignEngine, FoldEngine
from rna_algos_tpu.utils import read_fasta


@pytest.fixture(scope="module")
def cpu_mesh():
    devices = jax.devices("cpu")
    if len(devices) < 2:
        pytest.skip("needs multiple virtual devices")
    return mesh_lib.data_mesh(devices)


def test_fold_batch_sharded_matches_unsharded(cpu_mesh):
    recs = read_fasta("assets/sampled_trnas.fa")
    seqs = [r.seq for r in recs]
    plain = FoldEngine(uses_contra_model=True).fold_batch(seqs)
    sharded = FoldEngine(uses_contra_model=True, mesh=cpu_mesh).fold_batch(seqs)
    for (a, _), (b, _) in zip(plain, sharded):
        # different XLA program (sharded) -> fusion-order noise only
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_align_engine_sharded_matches_unsharded(cpu_mesh):
    recs = read_fasta("assets/sampled_trnas.fa")
    seqs = [
        np.concatenate([[PSEUDO_BASE], r.seq, [PSEUDO_BASE]]).astype(np.int32)
        for r in recs
    ]
    pairs = [(i, j) for i in range(len(seqs)) for j in range(i + 1, len(seqs))]
    plain = AlignEngine().match_probs_pairs(seqs, pairs)
    sharded = AlignEngine(mesh=cpu_mesh).match_probs_pairs(seqs, pairs)
    assert set(plain) == set(sharded) == set(pairs)
    for p in pairs:
        assert plain[p].shape == sharded[p].shape
        np.testing.assert_allclose(plain[p], sharded[p], atol=1e-6)


def test_shard_map_batch_traces_once(cpu_mesh):
    traced = []

    def fn(s, n):
        traced.append(s.shape)
        return s * 2.0, n + 1

    f = mesh_lib.shard_map_batch(fn, cpu_mesh)
    s = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    n = np.arange(16, dtype=np.int32)
    for _ in range(3):
        out_s, out_n = f(s, n)
    np.testing.assert_array_equal(np.asarray(out_s), s * 2.0)
    np.testing.assert_array_equal(np.asarray(out_n), n + 1)
    ndev = cpu_mesh.devices.size
    assert traced == [(16 // ndev, 3)]


def test_shard_batch_layout(cpu_mesh):
    arr = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)
    (sharded,) = mesh_lib.shard_batch(cpu_mesh, arr)
    assert sharded.sharding.spec[0] == "data"
    np.testing.assert_array_equal(np.asarray(sharded), arr)


def test_initialize_distributed_single_process_noop():
    """Env-var-only decision; a plain single-process run must be a no-op.

    Run in a subprocess so the check happens before ANY jax backend
    initialization — calling jax.process_count() first is exactly the
    ordering bug this guards against (parallel/mesh.py docstring).
    """
    import subprocess
    import sys
    import os

    code = (
        "import os, sys\n"
        "for k in ('JAX_COORDINATOR_ADDRESS', 'JAX_NUM_PROCESSES',"
        " 'JAX_PROCESS_ID', 'RNA_ALGOS_DISTRIBUTED'):\n"
        "    os.environ.pop(k, None)\n"
        "from rna_algos_tpu.parallel.mesh import initialize_distributed\n"
        "assert initialize_distributed() is False\n"
        "import jax\n"
        "assert jax.process_count() == 1\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [sys.executable, "-c", code],
        capture_output=True, text=True, env=env,
        cwd=os.path.join(os.path.dirname(__file__), ".."),
    )
    assert out.returncode == 0, out.stderr
    assert "ok" in out.stdout


def test_initialize_distributed_count_one_declines(monkeypatch):
    """Explicit JAX_NUM_PROCESSES=1 (without the explicit opt-in) is a no-op."""
    monkeypatch.setenv("JAX_COORDINATOR_ADDRESS", "127.0.0.1:12345")
    monkeypatch.setenv("JAX_NUM_PROCESSES", "1")
    monkeypatch.delenv("RNA_ALGOS_DISTRIBUTED", raising=False)
    assert mesh_lib.initialize_distributed() is False


def test_dryrun_multichip_refuses_too_few_devices():
    import __graft_entry__ as g

    n = len(jax.devices()) + 1
    with pytest.raises(RuntimeError, match=f"only {n - 1} cpu device"):
        g.dryrun_multichip(n)
