"""The CPU-runnable parts of chip_smoke.py: its comparators, its last line,
and its refusal to run without a GPU; plus the CLI-text comparators it
shares with tests/test_reference_golden.py."""

import json
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs
from rna_algos_tpu.utils.output import (
    parse_triples,
    probs2str,
    triples_max_diff,
)

from .conftest import REPO_ROOT


@pytest.mark.parametrize(
    "a,b,want",
    [
        ([0.25, 0.5], [0.25, 0.5], 0.0),
        ([0.25, 0.5], [0.25, 0.0], 0.5),
        ([0.25, np.nan], [0.25, 0.5], float("inf")),
        ([0.25, 0.5], [np.inf, 0.5], float("inf")),
        ([], [], 0.0),
    ],
)
def test_max_abs_diff(a, b, want):
    assert cs.max_abs_diff(np.float32(a), np.float32(b)) == want


def test_max_abs_diff_rejects_shape_mismatch():
    with pytest.raises(ValueError, match="shapes differ"):
        cs.max_abs_diff(np.zeros((2, 3)), np.zeros((3, 2)))


def test_checks_remember_failures(capsys):
    c = cs.Checks()
    assert c.check("inside", 1e-5, 5e-4)
    assert not c.check("outside", 1e-3, 5e-4)
    with c.phase("boom"):
        raise RuntimeError("x")
    assert c.failed == ["outside", "boom raised"]
    out = capsys.readouterr().out
    assert "inside: max|d| 1e-05 limit 0.0005 ok" in out
    assert "outside: max|d| 0.001 limit 0.0005 FAIL" in out


class _Dev:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("count", [1, 4])
def test_last_line(count):
    line = cs.last_line([_Dev()] * count)
    assert line == (
        '{"ok": true, "device": {"platform": "gpu", '
        f'"kind": "NVIDIA H100 80GB HBM3", "count": {count}}}}}'
    )
    assert json.loads(line)["device"]["count"] == count


def _run(cwd, args=()):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, "chip_smoke.py", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


@pytest.mark.parametrize("args", [(), ("--four-cards",)])
def test_refuses_without_gpu(args):
    r = _run(REPO_ROOT, args)
    assert r.returncode != 0
    assert "needs a GPU; JAX found cpu" in r.stderr
    assert '"ok"' not in r.stdout


def test_refuses_without_the_repo(tmp_path):
    shutil.copy(REPO_ROOT / "chip_smoke.py", tmp_path)
    r = _run(tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_require_gpu_exits_on_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        cs.require_gpu(1)


def test_parse_triples_round_trip():
    text = (
        "# header\n\n>0\n" + probs2str([(0, 5, 0.25), (1, 4, 1e-7)])
        + "\n\n>1\n" + probs2str([(2, 9, 0.5)])
    )
    assert parse_triples(text) == {
        "0": {(0, 5): 0.25, (1, 4): 1e-7},
        "1": {(2, 9): 0.5},
    }


def test_triples_max_diff():
    ref = {"0": {(0, 5): 0.25, (1, 4): 0.5}}
    assert triples_max_diff(ref, {"0": {(0, 5): 0.25, (1, 4): 0.4}}) == \
        pytest.approx(0.1)
    with pytest.raises(ValueError, match="pair sets differ"):
        triples_max_diff(ref, {"0": {(0, 5): 0.25}})
    with pytest.raises(ValueError, match="record ids differ"):
        triples_max_diff(ref, {"1": {(0, 5): 0.25, (1, 4): 0.5}})


@pytest.mark.gpu
def test_headline_on_gpu():
    """Phase 1 of chip_smoke.py, on the GPU."""
    c = cs.Checks()
    cs.phase_headline(c)
    assert c.failed == []
