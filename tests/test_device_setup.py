"""Device set-up helpers: ``__graft_entry__._ensure_devices`` never falls
back to virtual CPU devices unless the CPU was asked for, and
``lynx_tpu.compile_cache`` defers to ``JAX_COMPILATION_CACHE_DIR``."""

import pathlib
import sys

import jax
import pytest

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent))

import __graft_entry__ as graft  # noqa: E402
from lynx_tpu import compile_cache  # noqa: E402


@pytest.mark.parametrize("n_devices", [1, 4, 8])
def test_ensure_devices_accepts_available_devices(monkeypatch, n_devices):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    graft._ensure_devices(n_devices)


@pytest.mark.parametrize("platforms", [None, "cuda", "cpu"])
def test_ensure_devices_refuses_too_few(monkeypatch, platforms):
    """Asking for more devices than exist fails with a clear message, and
    an accelerator request never turns into a silent CPU run."""
    if platforms is None:
        monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    else:
        monkeypatch.setenv("JAX_PLATFORMS", platforms)
    monkeypatch.setenv("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    n = len(jax.devices()) + 8
    with pytest.raises(RuntimeError, match=f"needs {n} devices"):
        graft._ensure_devices(n)


def test_compile_cache_defers_to_the_environment(monkeypatch):
    updates = []
    monkeypatch.setattr(
        compile_cache.jax.config, "update", lambda *a: updates.append(a)
    )
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert compile_cache.enable_compile_cache() == "/elsewhere/cache"
    assert updates == []


def test_compile_cache_defaults_to_the_checkout(monkeypatch):
    updates = []
    monkeypatch.setattr(
        compile_cache.jax.config, "update", lambda *a: updates.append(a)
    )
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_compile_cache()
    repo = pathlib.Path(__file__).resolve().parent.parent
    assert pathlib.Path(path) == repo / ".jax_cache"
    assert updates == [("jax_compilation_cache_dir", path)]
