"""runtime/compile_cache.py: where the entry points keep JAX's persistent
compilation cache."""

import os
import re

import jax

from vofod_tpu.runtime import compile_cache


def _restore(prev):
    jax.config.update("jax_compilation_cache_dir", prev)


def test_env_var_wins_and_nothing_else_is_set(monkeypatch, tmp_path):
    prev = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    try:
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        # JAX reads the variable itself; the helper sets no config
        assert jax.config.jax_compilation_cache_dir == prev
    finally:
        _restore(prev)


def test_default_is_fixed_in_repo_path(monkeypatch):
    prev = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        first = compile_cache.enable_compile_cache()
        second = compile_cache.enable_compile_cache()
        assert first == second == jax.config.jax_compilation_cache_dir
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert first == os.path.join(repo, ".jax_cache")
        # no pid, no time: nothing that changes from one process to the next
        assert str(os.getpid()) not in first
        assert not re.search(r"\d{4,}", os.path.basename(first))
    finally:
        _restore(prev)


def test_cache_dir_is_gitignored():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
