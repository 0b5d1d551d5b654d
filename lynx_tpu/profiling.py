"""Profiling hooks (SURVEY.md §5: the tracing/profiling subsystem the
reference lacks).

Two ways to time device work.  :func:`benchmark` times whole calls on the
host clock, each ending in a value fetch.  :func:`marginal_seconds_per_iter`
chains K loop-carried iterations inside ONE jitted program and differences
two K values, so the fixed dispatch and fetch cost of a call cancels — the
tool for steps that take microseconds, where that fixed cost would swamp
the step.  :func:`device_op_profile` and :func:`device_busy_seconds` read
the device's own clock from a ``jax.profiler`` trace.
"""

from __future__ import annotations

import statistics
import subprocess
import time
from contextlib import contextmanager

import jax
import jax.numpy as jnp


@contextmanager
def trace(log_dir: str):
    """Capture a ``jax.profiler`` trace viewable in TensorBoard/Perfetto."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def benchmark(fn, *args, iters: int = 30, warmup: int = 2) -> float:
    """Steady-state seconds-per-call of ``fn``, timed by fetching each
    result to the host (safe on async-dispatch backends; includes the
    per-call dispatch/fetch overhead — use
    :func:`marginal_seconds_per_iter` for device-compute time)."""
    for _ in range(warmup):
        out = fn(*args)
    _fetch(out)
    start = time.perf_counter()
    for _ in range(iters):
        _fetch(fn(*args))
    return (time.perf_counter() - start) / iters


def compile_and_time(fn, *args, repeats: int = 5):
    """``(compile_s, steady_s, out)`` of jitted ``fn``: compile seconds from
    lowering and compiling, steady seconds the median of ``repeats`` calls
    on the host clock, each ending in ``block_until_ready``."""
    start = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - start
    out = jax.block_until_ready(compiled(*args))
    times = []
    for _ in range(repeats):
        start = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        times.append(time.perf_counter() - start)
    return compile_s, statistics.median(times), out


def card() -> str:
    """Each GPU's name and power limit as ``nvidia-smi`` reports them,
    joined by `` | `` (a card below its maximum limit runs slower under
    load, so every measurement carries this line)."""
    try:
        proc = subprocess.run(
            [
                "nvidia-smi",
                "--query-gpu=name,power.limit",
                "--format=csv,noheader",
            ],
            capture_output=True,
            text=True,
            timeout=30,
        )
    except (OSError, subprocess.TimeoutExpired) as error:
        return f"nvidia-smi unavailable ({error})"
    return " | ".join(proc.stdout.strip().splitlines()) or "nvidia-smi: no output"


def _fetch(out) -> float:
    """Force completion: reduce every output leaf to one scalar and pull it
    to the host."""
    leaves = [x for x in jax.tree.leaves(out) if hasattr(x, "dtype")]
    total = 0.0
    for leaf in leaves:
        # jnp.sum of a potentially non-finite array is fine — we only need
        # the bytes to exist on the host.
        total += float(jnp.sum(jnp.asarray(leaf, dtype=jnp.float32)))
    return total


def marginal_seconds_per_iter(
    step_fn,
    init_carry,
    k_small: int = 16,
    k_large: int = 256,
    repeats: int = 3,
) -> float:
    """True device seconds per iteration of ``step_fn``.

    ``step_fn(carry) -> carry`` must be a pure function whose output
    data-depends on its input (the harness chains it ``K`` times inside one
    jitted ``fori_loop``, so the compiler cannot hoist, CSE, or overlap
    iterations).  The measured quantity is::

        (t_fetch(k_large) - t_fetch(k_small)) / (k_large - k_small)

    which cancels the fixed dispatch + fetch latency of a call.  The
    minimum over ``repeats`` trials is returned (timing noise is strictly
    additive).

    Pick ``k_large`` so that ``k_large * t_iter`` comfortably exceeds the
    fixed latency's trial-to-trial noise.  Loop carries that fit in the
    device's caches stay resident across iterations — the measured figure
    is then the jit-production rate for loop workloads (RL envs, tuners),
    not a cold-memory streaming rate.
    """

    def run(K: int) -> float:
        @jax.jit
        def chained(carry):
            return jax.lax.fori_loop(0, K, lambda i, c: step_fn(c), carry)

        out = chained(init_carry)  # compile + warm
        _fetch(out)
        best = float("inf")
        for _ in range(repeats):
            start = time.perf_counter()
            _fetch(chained(init_carry))
            best = min(best, time.perf_counter() - start)
        return best

    t_small = run(k_small)
    t_large = run(k_large)
    return max((t_large - t_small) / (k_large - k_small), 1e-12)


def chain_with_scalar(fn, perturb, out_to_scalar=None):
    """Adapt ``fn(*args) -> out`` into a loop-carried ``step(carry)`` for
    :func:`marginal_seconds_per_iter`.

    ``carry = (args, eps)`` where ``eps`` is an f32 scalar derived from the
    previous output; ``perturb(args, eps) -> args`` must inject ``eps``
    into the inputs in a numerically negligible way (e.g. ``x + eps``
    with ``eps ~ out_sum * 1e-30``) so every iteration genuinely depends
    on the previous one without changing the workload.
    """
    out_to_scalar = out_to_scalar or (
        lambda out: sum(
            jnp.sum(leaf).astype(jnp.float32)
            for leaf in jax.tree.leaves(out)
            if hasattr(leaf, "dtype")
        )
    )

    def step(carry):
        args, eps = carry
        args = perturb(args, eps)
        out = fn(*args)
        return args, out_to_scalar(out) * jnp.float32(1e-30)

    return step


def _device_trace(fn, args, iters: int):
    """Trace ``iters`` calls of jitted ``fn`` (after a warm-up call) and
    return ``(events, names)``: the complete events (``ph == "X"``) of the
    device processes, and those processes' names.

    Device processes are those whose name starts with ``/device`` (the
    GPU's streams appear as ``/device:GPU:<n>``); on the CPU, which has no
    device process, every process counts.
    """
    import glob
    import gzip
    import json
    import tempfile

    jitted = jax.jit(fn)
    jax.block_until_ready(jitted(*args))

    with tempfile.TemporaryDirectory() as log_dir:
        with trace(log_dir):
            for _ in range(iters):
                out = jitted(*args)
            jax.block_until_ready(out)

        files = sorted(
            glob.glob(f"{log_dir}/plugins/profile/*/*.trace.json.gz")
        )
        if not files:  # pragma: no cover - backend without trace support
            return [], []
        with gzip.open(files[-1]) as f:
            data = json.load(f)

    pids = {
        e["pid"]: e["args"].get("name", "")
        for e in data.get("traceEvents", [])
        if e.get("ph") == "M" and e.get("name") == "process_name"
    }
    device_pids = {
        pid for pid, name in pids.items() if name.startswith("/device")
    } or set(pids)
    events = [
        e
        for e in data.get("traceEvents", [])
        if e.get("ph") == "X" and "dur" in e and e.get("pid") in device_pids
    ]
    return events, sorted(pids[pid] for pid in device_pids)


def device_busy_seconds(fn, *args, iters: int = 10) -> float:
    """Device-busy seconds per call of jitted ``fn``: the union of the
    device events' intervals in a trace of ``iters`` calls, over
    ``iters``.  Overlapping events (streams, nested module/op events)
    count once."""
    intervals = sorted(
        (e["ts"], e["ts"] + e["dur"])
        for e in _device_trace(fn, args, iters)[0]
    )
    busy_us, end = 0.0, float("-inf")
    for start, stop in intervals:
        if stop <= end:
            continue
        busy_us += stop - max(start, end)
        end = stop
    return busy_us * 1e-6 / iters


def device_op_profile(fn, *args, iters: int = 10, top: int = 20):
    """Per-HLO-op device-time attribution of one jitted function.

    Runs ``fn(*args)`` ``iters`` times under ``jax.profiler.trace`` and
    aggregates the device-side events from the trace into a sorted
    table (on CPU the "device" rows are the host-side HLO events).

    :param fn: a jittable callable; it is jitted and warmed up here.
    :param iters: trace iterations (each op's time is averaged over them).
    :param top: number of rows to return.
    :return: list of ``{"name", "us_per_iter", "count_per_iter",
        "long_name"}`` dicts, sorted by descending time.  The first row
        may be the whole-program event (named ``jit_...``).
    """
    import collections

    durations = collections.Counter()
    counts = collections.Counter()
    long_names = {}
    for e in _device_trace(fn, args, iters)[0]:
        durations[e["name"]] += e["dur"]
        counts[e["name"]] += 1
        ln = e.get("args", {}).get("long_name")
        if ln:
            long_names.setdefault(e["name"], ln)

    rows = []
    for name, total in durations.most_common(top):
        rows.append(
            {
                "name": name,
                "us_per_iter": round(total / iters, 2),
                "count_per_iter": counts[name] / iters,
                "long_name": long_names.get(name, ""),
            }
        )
    return rows
