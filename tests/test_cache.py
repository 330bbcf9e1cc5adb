"""utils/cache.py: the persistent XLA compilation cache gate and placement.

The suite runs on the CPU backend, where enable_compilation_cache() bails
before the enable path. These tests drive every branch with the backend
probe monkeypatched to "gpu" — no real card (or real cache writes)
involved.
"""

import os

import jax
import pytest

from spectral_tpu.utils import cache


@pytest.fixture(autouse=True)
def reset_cache_state(monkeypatch):
    """Each test starts from the not-yet-enabled state and leaves the
    process-global jax config untouched."""
    monkeypatch.setattr(cache, "_enabled", False)
    monkeypatch.delenv(cache.ENV_DIR, raising=False)
    orig_dir = jax.config.jax_compilation_cache_dir
    orig_min = jax.config.jax_persistent_cache_min_compile_time_secs
    orig_size = jax.config.jax_persistent_cache_min_entry_size_bytes
    yield
    jax.config.update("jax_compilation_cache_dir", orig_dir)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", orig_min)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", orig_size)


@pytest.fixture
def gpu_backend(monkeypatch, tmp_path):
    """Pretend the default backend is a GPU and point the checkout-relative
    default directory at tmp_path (so no test writes into the repo)."""
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(cache, "default_cache_dir",
                        lambda: str(tmp_path / ".jax_cache"))
    return tmp_path


def test_cpu_backend_declines():
    # the suite's real backend IS cpu: caching XLA:CPU AOT blobs across
    # processes risks machine-feature mismatches, so the gate declines
    assert cache.enable_compilation_cache() is False
    assert cache.compilation_cache_dir() is None


def test_opt_out_env(monkeypatch):
    monkeypatch.setenv("SPECTRAL_TPU_NO_CACHE", "1")
    assert cache.enable_compilation_cache() is False


def test_enables_on_accelerator_backend(gpu_backend, monkeypatch):
    assert cache.enable_compilation_cache() is True
    want = str(gpu_backend / ".jax_cache")
    assert os.path.isdir(want)
    assert jax.config.jax_compilation_cache_dir == want
    # every accelerator program persists: most compile in under a second
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0
    assert cache.compilation_cache_dir() == want
    # idempotent: the second call short-circuits on _enabled
    monkeypatch.setattr(jax, "default_backend",
                        lambda: pytest.fail("probed twice"))
    assert cache.enable_compilation_cache() is True


def test_backend_probe_failure_is_contained(monkeypatch):
    # backend init can raise — the cache gate must decline, not propagate
    def boom():
        raise RuntimeError("backend init failed")
    monkeypatch.setattr(jax, "default_backend", boom)
    assert cache.enable_compilation_cache() is False
    assert cache.compilation_cache_dir() is None


def test_default_dir_is_checkout_relative_and_fixed():
    """<checkout>/.jax_cache: the repository root holding the package —
    never ~, a temporary name, a process id or the time."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert cache.default_cache_dir() == os.path.join(repo, ".jax_cache")
    assert cache.default_cache_dir() == cache.default_cache_dir()
    assert str(os.getpid()) not in cache.default_cache_dir()
    assert not cache.default_cache_dir().startswith(
        os.path.expanduser("~") + os.sep + ".cache")


def test_env_dir_wins_and_is_not_overridden(gpu_backend, monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, JAX's own setting stands: the
    gate enables the cache but sets no directory of its own."""
    env_dir = str(gpu_backend / "from_env")
    monkeypatch.setenv(cache.ENV_DIR, env_dir)
    jax.config.update("jax_compilation_cache_dir", env_dir)  # as JAX reads it
    assert cache.enable_compilation_cache() is True
    assert jax.config.jax_compilation_cache_dir == env_dir
    assert not os.path.exists(gpu_backend / ".jax_cache")
    assert cache.compilation_cache_dir() == env_dir


def test_env_dir_empty_string_means_unset(gpu_backend, monkeypatch):
    monkeypatch.setenv(cache.ENV_DIR, "")
    assert cache.enable_compilation_cache() is True
    assert jax.config.jax_compilation_cache_dir == str(
        gpu_backend / ".jax_cache")


def test_gitignore_lists_the_default_dir():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(repo, ".gitignore")) as fh:
        assert ".jax_cache/" in fh.read().split()
