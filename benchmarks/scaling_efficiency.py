"""Weak-scaling efficiency of the batch-sharded env sweep over a device mesh.

BASELINE.md:28 demands >= 85% multi-host scaling efficiency at >= 2 hosts.
Real multi-host hardware does not exist in this environment, so this harness
measures the SAME metric two ways:

* ``--virtual`` (default): 1 -> N virtual CPU devices in one process
  (``--xla_force_host_platform_device_count``), exactly the fake backend
  the sharding tests use.  IMPORTANT measurement caveat: virtual devices
  share the host's physical cores, so weak-scaling *throughput* cannot
  exceed the single-"device" number (XLA:CPU already uses every core at
  n=1) — the wall-clock weak-scaling column is recorded for the journal
  but is NOT the efficiency signal.  The meaningful virtual metric is the
  **partition overhead ratio**: time(unsharded, total batch B) /
  time(sharded over N, same B).  Perfect partitioning with negligible
  collective cost gives ~1.0; a sweep that silently stops partitioning
  (replicates the whole batch per device) collapses toward 1/N.  This
  ratio is what transfers to real devices, where per-device compute
  scaling is physical and only the partitioning overhead is at stake.  Reported as
  ``scaling_efficiency_virtual``.
* ``--distributed``: run under ``jax.distributed`` across real processes /
  hosts (see ``docs/distributed.md`` for the launch command); emits
  true weak-scaling efficiency from process 0 (distinct physical devices).

Prints one JSON line per measurement plus a final summary line.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib as _pathlib
import sys as _sys

_REPO = _pathlib.Path(__file__).resolve().parent.parent
_sys.path.insert(0, str(_REPO))


def _measure_throughput(mesh, per_device: int) -> float:
    """Env-steps/s of the batch-sharded ParameterBeam settings sweep on the
    given mesh (weak workload: ``per_device * mesh size`` settings).

    Multi-host-safe variant of the delta-K harness: global sharded arrays
    are passed as jit ARGUMENTS (closing over them is illegal across
    processes) and the loop carry / fetched value is one fully-replicated
    scalar, which every process can read locally."""
    import time

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from lynx_tpu.envs import make_env
    from lynx_tpu.envs.ares_ea import default_params

    n = mesh.devices.size
    batch = per_device * n
    env = make_env()
    params = jax.vmap(default_params)(
        jax.random.split(jax.random.PRNGKey(1), batch)
    )
    magnets = jnp.zeros((batch, env.num_actions))

    magnets = jax.device_put(magnets, NamedSharding(mesh, P("batch", None)))
    params = jax.tree.map(
        lambda x: jax.device_put(
            x, NamedSharding(mesh, P("batch", *([None] * (x.ndim - 1))))
        ),
        params,
    )

    def run(K: int) -> float:
        @jax.jit
        def chained(magnets, params, eps):
            def body(i, e):
                out = env.batched_beam_parameters(magnets + e, params)
                return jnp.sum(out).astype(jnp.float32) * jnp.float32(1e-30)

            return jax.lax.fori_loop(0, K, body, eps)

        float(chained(magnets, params, jnp.float32(0.0)))  # compile + warm
        best = float("inf")
        for _ in range(3):
            start = time.perf_counter()
            float(chained(magnets, params, jnp.float32(0.0)))
            best = min(best, time.perf_counter() - start)
        return best

    t_small, t_large = run(8), run(64)
    return batch / max((t_large - t_small) / 56, 1e-12)


def run_virtual(per_device: int, max_devices: int) -> dict:
    import jax
    from jax.sharding import Mesh

    devices = jax.devices()
    counts = [n for n in (1, 2, 4, 8) if n <= min(max_devices, len(devices))]
    top = counts[-1]

    # Weak-scaling wall clock (journal column; core-bound on virtual
    # devices — see module docstring).
    throughputs = {}
    for n in counts:
        mesh = Mesh(devices[:n], ("batch",))
        throughputs[n] = _measure_throughput(mesh, per_device)
        print(
            json.dumps(
                {
                    "measure": "weak_scaling_wall_clock",
                    "devices": n,
                    "per_device_batch": per_device,
                    "env_steps_per_s": round(throughputs[n], 1),
                }
            ),
            flush=True,
        )

    # Partition overhead at fixed TOTAL batch: the transferable signal.
    total = per_device * top
    t_sharded = throughputs[top]
    mesh_one = Mesh(devices[:1], ("batch",))
    t_unsharded = _measure_throughput(mesh_one, total)
    overhead_ratio = t_sharded / t_unsharded
    print(
        json.dumps(
            {
                "measure": "partition_overhead",
                "devices": top,
                "total_batch": total,
                "sharded_env_steps_per_s": round(t_sharded, 1),
                "unsharded_env_steps_per_s": round(t_unsharded, 1),
                "ratio": round(overhead_ratio, 4),
            }
        ),
        flush=True,
    )
    return {
        "scaling_efficiency_virtual": round(overhead_ratio, 4),
        "devices": top,
        "total_batch": total,
        "note": (
            "virtual CPU devices share host cores; this is the"
            " sharded/unsharded partition-overhead ratio at fixed total"
            " batch (1.0 = partitioning adds no cost), not physical"
            " weak scaling"
        ),
        "mode": "virtual",
    }


def run_distributed(per_device: int) -> dict:
    """Same metric across real processes (one per host): launch this script
    with ``--distributed`` on every host (see docs/distributed.md).  SLURM
    and Open MPI clusters auto-discover the coordinator; other launches
    export ``COORDINATOR`` (host:port), ``NPROC`` and ``PROC_ID``."""
    import jax
    from jax.sharding import Mesh

    from lynx_tpu.parallel.distributed import initialize

    coordinator = os.environ.get("COORDINATOR")
    if coordinator:
        initialize(
            coordinator_address=coordinator,
            num_processes=int(os.environ["NPROC"]),
            process_id=int(os.environ["PROC_ID"]),
        )
    else:
        initialize()
    devices = jax.devices()
    mesh_full = Mesh(devices, ("batch",))
    t_full = _measure_throughput(mesh_full, per_device)
    # Single-device reference measured on each process's OWN first card (a
    # remote process cannot address another host's device; this is pure
    # local compute, so processes cannot deadlock on it).
    mesh_one = Mesh(jax.local_devices()[:1], ("batch",))
    t_one = _measure_throughput(mesh_one, per_device)
    summary = {
        "scaling_efficiency": round(t_full / (len(devices) * t_one), 4),
        "devices": len(devices),
        "hosts": jax.process_count(),
        "per_device_batch": per_device,
        "env_steps_per_s": round(t_full, 1),
        "mode": "distributed",
    }
    return summary


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--per-device", type=int, default=8192)
    parser.add_argument("--max-devices", type=int, default=8)
    parser.add_argument(
        "--distributed",
        action="store_true",
        help="multi-process mode (jax.distributed); default is the"
        " single-process virtual CPU mesh",
    )
    args = parser.parse_args()

    if args.distributed:
        summary = run_distributed(args.per_device)
        import jax

        if jax.process_index() == 0:
            print(json.dumps(summary), flush=True)
        return

    summary = run_virtual(args.per_device, args.max_devices)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    from lynx_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    # Virtual mode needs the fake-device flag BEFORE jax initializes.
    if "--distributed" not in _sys.argv:
        flags = os.environ.get("XLA_FLAGS", "")
        if "host_platform_device_count" not in flags:
            os.environ["XLA_FLAGS"] = (
                flags + " --xla_force_host_platform_device_count=8"
            ).strip()
        import jax

        jax.config.update("jax_platforms", "cpu")
    elif os.environ.get("SCALING_FORCE_CPU"):
        # CPU multi-process smoke runs (tests/test_scaling_harness.py).
        import jax

        jax.config.update("jax_platforms", "cpu")
    main()
