"""The compile-cache helper: env var wins, otherwise a fixed in-repo dir."""

import os
import subprocess
import sys

import jax

from cice4_tpu import compile_cache as cc

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_env_var_is_honoured_and_nothing_set(monkeypatch, tmp_path):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(cc.ENV_VAR, str(tmp_path))
    assert cc.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_fixed_dir_inside_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv(cc.ENV_VAR, raising=False)
    try:
        assert cc.enable_compile_cache() == os.path.join(ROOT, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == cc.DEFAULT_DIR
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_fresh_process_uses_env_dir(tmp_path):
    """In a new process JAX itself reads the variable and the helper
    leaves it alone."""
    code = ("import jax; from cice4_tpu.compile_cache import "
            "enable_compile_cache as e; d = e(); "
            "print(d, jax.config.jax_compilation_cache_dir)")
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path),
               JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(tmp_path), str(tmp_path)]

