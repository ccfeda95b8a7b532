"""The GPU-side scripts' host logic: the compile-cache helper and the device
check of chip_smoke.py (which must refuse to run without a GPU)."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_compile_cache_uses_env_dir(monkeypatch, tmp_path):
    from linops_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: the helper sets nothing
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_repo_dir(monkeypatch):
    from linops_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = compile_cache.enable_compile_cache()
        assert got == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_device_check_refuses_cpu():
    sys.path.insert(0, REPO)
    import chip_smoke

    with pytest.raises(SystemExit) as exc:
        chip_smoke.device_info()
    assert "no GPU" in str(exc.value.code)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_gpu(where, tmp_path):
    """Run as a script on the CPU — from the repo, and from a directory
    holding nothing but the script — it exits non-zero and prints no
    result line."""
    cwd = REPO
    if where == "alone":
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
