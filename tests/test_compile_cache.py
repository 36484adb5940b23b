"""One persistent compilation cache: JAX_COMPILATION_CACHE_DIR when set,
else ``.jax_cache`` at the root of the checkout."""

import os
import subprocess
import sys

import jax
import pytest

from rna_algos_tpu.utils import compile_cache
from rna_algos_tpu.utils.compile_cache import enable_compile_cache

from .conftest import REPO_ROOT


@pytest.fixture
def restore_cache_dir():
    prev = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", prev)


def test_env_var_wins(monkeypatch, tmp_path, restore_cache_dir):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == str(tmp_path)


def test_unset_uses_checkout_dir(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = str(REPO_ROOT / ".jax_cache")
    assert compile_cache.REPO_CACHE_DIR == REPO_ROOT / ".jax_cache"
    assert enable_compile_cache() == want
    assert jax.config.jax_compilation_cache_dir == want


def test_same_path_from_two_processes(tmp_path):
    code = (
        "from rna_algos_tpu.utils.compile_cache import enable_compile_cache;"
        "print(enable_compile_cache())"
    )
    env = {k: v for k, v in os.environ.items()
           if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO_ROOT)
    paths = [
        subprocess.run(
            [sys.executable, "-c", code], cwd=cwd, env=env, check=True,
            capture_output=True, text=True, timeout=120,
        ).stdout.strip().splitlines()[-1]
        for cwd in (tmp_path, REPO_ROOT)
    ]
    assert paths == [str(REPO_ROOT / ".jax_cache")] * 2
