"""Worker program for the multi-process distributed test.

Launched N times by ``tests/test_distributed.py`` (one subprocess per
simulated host).  Each worker initializes the JAX distributed runtime over
CPU, assembles a globally-sharded beam from its host-local batch slice,
and runs a few sharded gradient-tuning train steps.  The final loss and
tuned ``k1`` (both replicated) are written to a JSON file per process so
the parent test can check cross-process agreement and parity with a
single-process run.

This is the CI stand-in for a real multi-host launch
(SURVEY.md §2.4 communication-backend row; see docs/distributed.md).
"""

import json
import os
import sys


def main() -> None:
    port, pid, nproc, outdir = (
        sys.argv[1],
        int(sys.argv[2]),
        int(sys.argv[3]),
        sys.argv[4],
    )
    # Two virtual CPU devices per process: the global mesh then has a
    # cross-process "batch" axis AND a within-process "particles" axis.
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp
    import optax

    import lynx_tpu as lt
    from lynx_tpu.functional import track
    from lynx_tpu.parallel import (
        global_mesh,
        host_local_beam_to_global,
        initialize,
        make_tuning_train_step,
        replicate_to_global,
    )

    initialize(f"localhost:{port}", num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc
    mesh = global_mesh()  # (batch=nproc, particles=2)

    local = BATCH // nproc
    sigma_x = SIGMA_X_GLOBAL[pid * local : (pid + 1) * local]
    beam_local = lt.ParameterBeam.from_parameters(
        sigma_x=jnp.asarray(sigma_x),
        sigma_y=jnp.full((local,), 2e-4),
        energy=jnp.full((local,), 1.073e8),
    )
    segment = make_segment(lt, jnp)

    with mesh:
        beam = host_local_beam_to_global(beam_local, mesh)
        segment = replicate_to_global(segment, mesh)
        optimizer = optax.adam(1e-1)
        opt_state = jax.jit(optimizer.init)(segment)

        def loss_fn(seg, b):
            out, _ = track(seg, b)
            return jnp.mean((out.sigma_x - 5e-5) ** 2) * 1e8

        train_step = make_tuning_train_step(optimizer, loss_fn)
        for _ in range(STEPS):
            segment, opt_state, loss = train_step(segment, opt_state, beam)

    result = {
        "loss": float(loss),
        "k1": float(jnp.reshape(segment.elements[1].k1, ())),
    }
    with open(os.path.join(outdir, f"result_{pid}.json"), "w") as f:
        json.dump(result, f)


# Shared constants/builders, imported by the parent test for the
# single-process reference run.
BATCH = 4
STEPS = 5
SIGMA_X_GLOBAL = [1.0e-4, 1.5e-4, 2.0e-4, 2.5e-4]


def make_segment(lt, jnp):
    return lt.Segment(
        [
            lt.Drift(length=jnp.asarray(0.5)),
            lt.Quadrupole(length=jnp.asarray(0.2), k1=jnp.asarray(4.0)),
            lt.Drift(length=jnp.asarray(0.5)),
        ]
    )


if __name__ == "__main__":
    main()
