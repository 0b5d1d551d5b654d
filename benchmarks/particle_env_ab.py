"""On-device A/B of the 100k-ParticleBeam env observation across batch
sizes and observation methods:

  * ``moments``   — exact moment-sufficiency route
    (``beam.as_parameter_beam()`` + the moment sweep; algebraically
    identical observations for the EA's purely linear lattice).
  * ``kernel``    — settings-amortized moment sweep over the shared cloud
    (``ops/sweep.py``; per-particle fidelity path, required once
    apertures interleave).
  * ``particles`` — dense per-setting push (the bandwidth-bound baseline).

Each (method, B) cell is timed with the loop-carried delta-K harness
(``lynx_tpu.profiling.marginal_seconds_per_iter``).  Prints one JSON line
per cell.

Usage: python benchmarks/particle_env_ab.py [--batches 32,128,256,512]
       [--methods moments,kernel,particles] [--particles 100000]
"""

from __future__ import annotations

import pathlib as _pathlib
import sys as _sys

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))

import argparse
import json

import jax
import jax.numpy as jnp


def measure(method: str, batch: int, num_particles: int) -> float:
    """Env-steps/s for one (method, batch) cell."""
    import lynx_tpu as lt
    from lynx_tpu.envs import make_env
    from lynx_tpu.profiling import marginal_seconds_per_iter

    env = make_env()
    beam = lt.ParticleBeam.from_parameters(
        num_particles=num_particles,
        sigma_x=jnp.array([1.75e-4]),
        sigma_y=jnp.array([1.75e-4]),
        energy=jnp.array([1.073e8]),
        key=jax.random.PRNGKey(3),
    )
    magnets = jax.random.uniform(
        jax.random.PRNGKey(4),
        (batch, env.num_actions),
        minval=-0.5,
        maxval=0.5,
    )

    def step(carry):
        m, eps = carry
        out = env.batched_particle_beam_parameters(
            m + eps, beam, method=method
        )
        return m, jnp.sum(out) * jnp.float32(1e-30)

    k_large = 512 if method == "moments" else 256
    per_call = marginal_seconds_per_iter(
        step, (magnets, jnp.float32(0.0)), 16, k_large
    )
    return batch / per_call


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--batches", default="32,128,256,512")
    parser.add_argument("--methods", default="moments,kernel,particles")
    parser.add_argument("--particles", type=int, default=100_000)
    args = parser.parse_args()

    for method in args.methods.split(","):
        for batch in (int(b) for b in args.batches.split(",")):
            try:
                steps_per_s = measure(method, batch, args.particles)
                record = {
                    "method": method,
                    "batch": batch,
                    "num_particles": args.particles,
                    "env_steps_per_s": round(steps_per_s, 1),
                }
            except Exception as error:  # pragma: no cover - device-dependent
                record = {
                    "method": method,
                    "batch": batch,
                    "num_particles": args.particles,
                    "error": repr(error)[:300],
                }
            print(json.dumps(record), flush=True)


if __name__ == "__main__":
    from lynx_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
