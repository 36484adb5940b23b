"""Test environment: an 8-device virtual CPU platform.

Multi-device sharding is validated on a virtual CPU mesh (and
``__graft_entry__.dryrun_multichip``).  Tests marked ``gpu`` need a GPU: the
``_gpu_marker`` fixture skips them when JAX finds none, which it always does
under the ``JAX_PLATFORMS=cpu`` default set here.  Run them on a GPU host with
``JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu``.
Must run before jax is imported anywhere.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import pathlib
import sys

REPO_ROOT = pathlib.Path(__file__).resolve().parent.parent
if str(REPO_ROOT) not in sys.path:
    sys.path.insert(0, str(REPO_ROOT))

import pytest


@pytest.fixture(autouse=True)
def _gpu_marker(request):
    if request.node.get_closest_marker("gpu") is None:
        return
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX found {jax.devices()[0].platform}")


@pytest.fixture(scope="session")
def trna_records():
    from rna_algos_tpu.utils import read_fasta

    return read_fasta(REPO_ROOT / "assets" / "sampled_trnas.fa")
