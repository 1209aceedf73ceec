"""vdn.core.compile_cache: JAX_COMPILATION_CACHE_DIR wins and nothing is
set; otherwise the cache is the repo's fixed .jax_cache directory."""

import os

import jax
import pytest

from vdn.core import compile_cache


@pytest.fixture
def restore_config():
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    saved = {k: getattr(jax.config, k) for k in keys}
    yield
    for k, v in saved.items():
        jax.config.update(k, v)


def test_env_var_wins_and_nothing_is_set(monkeypatch, restore_config,
                                         tmp_path):
    jax.config.update("jax_compilation_cache_dir", "/sentinel")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == "/sentinel"


def test_default_is_the_repo_cache(monkeypatch, restore_config):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert path == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path


def test_repo_cache_is_ignored_by_git():
    repo = os.path.dirname(compile_cache.DEFAULT_CACHE_DIR)
    with open(os.path.join(repo, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
