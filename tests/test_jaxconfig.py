"""Where the persistent compilation cache lives (mumemto_tpu/jaxconfig)."""

import os

from mumemto_tpu import jaxconfig


def test_env_dir_used_exactly(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert jaxconfig.cache_dir(cpu_forced=False) == str(tmp_path)
    assert jaxconfig.cache_dir(cpu_forced=True) == str(tmp_path)


def test_default_dir_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    want = os.path.join(root, ".jax_cache")
    assert jaxconfig.cache_dir(cpu_forced=False) == want
    cpu = jaxconfig.cache_dir(cpu_forced=True)
    assert os.path.dirname(cpu) == want
    assert os.path.basename(cpu).startswith("cpu_")
    # fixed: the same path on every call (never pid/time/tmp based)
    assert jaxconfig.cache_dir(cpu_forced=True) == cpu


def test_default_dir_is_git_ignored():
    root = os.path.dirname(jaxconfig.DEFAULT_DIR)
    with open(os.path.join(root, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()
