"""No code for the retired Mosaic kernels, and no fallback that hides the
device.

Scans the package, the entry points, scripts/ and tests/ for the constructs
the Mosaic kernels and their dispatch needed.  The patterns spell the
module names with character classes, so that a plain grep for those names
over the repository does not find this file."""

import re

import pytest

from .conftest import REPO_ROOT

FORBIDDEN = {
    "mosaic_pallas_import": r"pallas(\.| import )[t]pu",
    "mosaic_module_alias": r"\bpl[t]pu\b",
    "platform_probe": r"\bon_[t]pu\b",
    "vmem_limit": r"vmem_limit",
    "kernel_shape_knobs":
        r"RNA_ALGOS_(G|WINDOW|SPANS|TSPANS|BAND_PRECISION|FAST_IMPL|BACKEND)\b",
    "scalar_fetch_sync": r"\bforce_last\b",
    "platform_branch": r"platform\s*[!=]=\s*[\"']cpu[\"']",
    "fixed_cache_path":
        r"setdefault\(\s*[\"']JAX_COMPILATION_CACHE_DIR[\"']",
}


def _sources():
    files = [REPO_ROOT / "bench.py", REPO_ROOT / "chip_smoke.py",
             REPO_ROOT / "__graft_entry__.py"]
    for d in ("rna_algos_tpu", "scripts", "tests"):
        files += sorted((REPO_ROOT / d).rglob("*.py"))
    return [f for f in files if f != REPO_ROOT / "tests" / "test_source_scan.py"]


@pytest.mark.parametrize("name", sorted(FORBIDDEN))
def test_no_mosaic_only_construct(name):
    pattern = re.compile(FORBIDDEN[name])
    hits = [
        f"{f.relative_to(REPO_ROOT)}:{k}"
        for f in _sources()
        for k, line in enumerate(f.read_text().splitlines(), 1)
        if pattern.search(line)
    ]
    assert hits == []


def test_scan_sees_the_package():
    names = {f.name for f in _sources()}
    assert {"mccaskill.py", "runner.py", "chip_smoke.py", "bench.py"} <= names
