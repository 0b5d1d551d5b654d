"""Profiling-subsystem tests (SURVEY §5: tracing/profiling, new work)."""

import pathlib

import jax
import jax.numpy as jnp

from lynx_tpu.profiling import benchmark, trace


def test_benchmark_returns_positive_seconds():
    f = jax.jit(lambda x: (x * 2).sum())
    x = jnp.arange(1024.0)
    seconds = benchmark(f, x, iters=5, warmup=1)
    assert seconds > 0
    assert seconds < 10


def test_trace_writes_profile(tmp_path):
    with trace(str(tmp_path)):
        jax.block_until_ready(jnp.arange(16.0).sum())
    produced = list(pathlib.Path(tmp_path).rglob("*"))
    assert produced, "profiler trace produced no files"


def test_device_op_profile_returns_attributed_rows():
    """device_op_profile must return per-op rows with time attribution
    (on CPU the rows are host-side HLO events — still named and timed)."""
    from lynx_tpu.profiling import device_op_profile

    rows = device_op_profile(
        lambda x: jnp.sin(x) @ x.T, jnp.ones((128, 128)), iters=3, top=8
    )
    assert rows, "no trace events collected"
    assert all(
        {"name", "us_per_iter", "count_per_iter", "long_name"} <= set(r)
        for r in rows
    )
    assert all(r["us_per_iter"] >= 0 for r in rows)
    # Sorted by descending time.
    times = [r["us_per_iter"] for r in rows]
    assert times == sorted(times, reverse=True)


def test_device_busy_seconds_is_positive_and_bounded():
    """The union of device intervals per call: positive, and no more than
    the host-clock time of the traced calls."""
    import time

    from lynx_tpu.profiling import device_busy_seconds

    x = jnp.ones((256, 256))
    f = jax.jit(lambda x: jnp.sin(x) @ x.T)
    jax.block_until_ready(f(x))
    start = time.perf_counter()
    busy = device_busy_seconds(lambda x: jnp.sin(x) @ x.T, x, iters=3)
    elapsed = time.perf_counter() - start
    assert 0 < busy < elapsed
