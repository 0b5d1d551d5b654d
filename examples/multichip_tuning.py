"""Multi-chip gradient-based tuning over a (batch, particles) device mesh.

The reference framework is single-process (SURVEY.md §2.4); lynx-tpu scales
the same workload over several GPUs with ``jax.sharding``: lattice-settings
batches ride the ``batch`` mesh axis, the macro-particle axis of the
``ParticleBeam`` is sharded over ``particles``, and XLA inserts every
collective (moment reductions over the particle axis, gradient reductions
over batch), which NCCL carries over NVLink.

Runs anywhere: on a machine without accelerators it uses 8 virtual CPU
devices, which is also exactly how ``tests/test_parallel.py`` validates the
sharding — the program is identical on a multi-GPU host.

Run: python examples/multichip_tuning.py [--steps 30]
"""

from __future__ import annotations

import argparse
import os


def main(steps: int = 30) -> None:
    # Virtual-device fallback must be configured before jax initializes.
    os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    import jax
    import jax.numpy as jnp
    import optax

    if len(jax.devices()) < 2:  # pragma: no cover - single-accelerator host
        raise SystemExit("need >= 2 devices (or the virtual-CPU fallback)")

    import lynx_tpu as lt
    from lynx_tpu.functional import track
    from lynx_tpu.models import ares_ea_segment
    from lynx_tpu.parallel import (
        make_mesh,
        make_tuning_train_step,
        shard_beam,
        shard_segment,
    )

    mesh = make_mesh()
    batch = 4 * mesh.shape["batch"]
    num_particles = 2048 * mesh.shape["particles"]
    print(f"mesh {dict(mesh.shape)}, batch={batch}, particles={num_particles}")

    segment = ares_ea_segment().broadcast((batch,))
    segment.AREABSCR1.is_active = False
    segment.AREAMQZM1.k1 = jnp.linspace(-1.0, 1.0, batch)
    beam = lt.ParticleBeam.from_parameters(
        num_particles=num_particles,
        sigma_x=jnp.full((batch,), 1.75e-4),
        sigma_y=jnp.full((batch,), 1.75e-4),
        energy=jnp.full((batch,), 1.073e8),
        key=jax.random.PRNGKey(0),
    )

    target = jnp.full((batch,), 5e-5)

    def loss_fn(seg, beam):
        outgoing, _ = track(seg, beam)
        # Millimetre units keep gradient magnitudes well above adam's eps.
        return jnp.mean(
            ((outgoing.sigma_x - target) * 1e3) ** 2
            + ((outgoing.sigma_y - target) * 1e3) ** 2
        )

    optimizer = optax.adam(5e-2)
    with mesh:
        segment = shard_segment(segment, mesh)
        beam = shard_beam(beam, mesh)
        opt_state = optimizer.init(segment)
        train_step = make_tuning_train_step(optimizer, loss_fn)

        for i in range(steps):
            segment, opt_state, loss = train_step(segment, opt_state, beam)
            if i % 5 == 0 or i == steps - 1:
                print(f"step {i:3d}  loss {float(loss):.3e}")

        # Same optimization, one dispatch: the scanned tuner composes with
        # the mesh shardings (inputs keep their NamedShardings through the
        # lax.scan), so a whole training run is a single host round trip.
        from lynx_tpu.tuning import make_tuner

        tuner = make_tuner(optimizer, loss_fn)
        segment2 = ares_ea_segment().broadcast((batch,))
        segment2.AREABSCR1.is_active = False
        segment2.AREAMQZM1.k1 = jnp.linspace(-1.0, 1.0, batch)
        segment2 = shard_segment(segment2, mesh)
        _, _, losses = tuner(segment2, optimizer.init(segment2), steps, beam)
        print(
            f"scanned tuner ({steps} steps, one dispatch): "
            f"loss {float(losses[0]):.3e} -> {float(losses[-1]):.3e}"
        )


if __name__ == "__main__":
    from lynx_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=30)
    main(parser.parse_args().steps)
