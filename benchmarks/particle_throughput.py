"""Batched ParticleBeam tracking throughput (the reference's N=100k
``tests/test_speed.py`` workload, scaled across a settings batch).

Tracks a (B,)-batched ARES EA subcell with B different quadrupole settings,
each with an N-particle beam, and reports particle-pushes/s (one push = one
particle through the whole segment's composed map).

Prints one JSON line:
    {"metric": "particle_pushes_per_s", "value": N, "unit": "pushes/s",
     "batch": B, "num_particles": N}

Usage: python benchmarks/particle_throughput.py [--batch 256] [--particles 100000]
"""

from __future__ import annotations

# Make the repo root importable no matter where this script is launched
# from (round-2 on-device runs died on `ModuleNotFoundError: lynx_tpu`).
import pathlib as _pathlib
import sys as _sys

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))

import argparse
import json
import time

import jax
import jax.numpy as jnp


def main(batch: int, num_particles: int, iters: int) -> None:
    import lynx_tpu as lt
    from lynx_tpu.models import ares_ea_segment

    segment = ares_ea_segment().broadcast((batch,))
    segment.AREABSCR1.is_active = False
    segment.AREAMQZM1.k1 = jnp.linspace(-5.0, 5.0, batch)
    segment.AREAMQZM2.k1 = jnp.linspace(5.0, -5.0, batch)

    @jax.jit
    def make(key):
        return lt.ParticleBeam.from_parameters(
            num_particles=num_particles,
            sigma_x=jnp.full((batch,), 1.75e-4),
            sigma_y=jnp.full((batch,), 1.75e-4),
            energy=jnp.full((batch,), 1.073e8),
            key=key,
        )

    beam = make(jax.random.PRNGKey(0))

    # Loop-carried delta-K harness (cancels the fixed per-call cost; see
    # lynx_tpu.profiling).
    from lynx_tpu.profiling import marginal_seconds_per_iter

    def step(carry):
        p, eps = carry
        b = lt.ParticleBeam(
            p + eps, beam.energy,
            particle_charges=beam.particle_charges, survival=beam.survival,
        )
        return p, segment.track(b).sigma_x.sum().astype(jnp.float32) * 1e-30

    per_iter = marginal_seconds_per_iter(
        step, (beam.particles, jnp.float32(0)), 16, 256
    )
    pushes_per_s = batch * num_particles / per_iter
    print(
        json.dumps(
            {
                "metric": "particle_pushes_per_s",
                "value": round(pushes_per_s),
                "unit": "pushes/s",
                "batch": batch,
                "num_particles": num_particles,
            }
        )
    )


if __name__ == "__main__":
    from lynx_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    parser = argparse.ArgumentParser()
    parser.add_argument("--batch", type=int, default=256)
    parser.add_argument("--particles", type=int, default=100_000)
    parser.add_argument("--iters", type=int, default=10)
    args = parser.parse_args()
    main(args.batch, args.particles, args.iters)
