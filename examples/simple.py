"""First steps with lynx-tpu (the reference's ``simple.ipynb`` analog).

Build a small lattice, track a particle beam through it, read a BPM, mutate a
magnet and observe the change.

Run: python examples/simple.py
"""

import jax.numpy as jnp

import lynx_tpu as lt


def main() -> None:
    segment = lt.Segment(
        elements=[
            lt.BPM(name="BPM1SMATCH"),
            lt.Drift(length=jnp.array([1.0])),
            lt.BPM(name="BPM6SMATCH"),
            lt.Drift(length=jnp.array([1.0])),
            lt.VerticalCorrector(length=jnp.array([0.3]), name="V7SMATCH"),
            lt.Drift(length=jnp.array([0.2])),
            lt.HorizontalCorrector(length=jnp.array([0.3]), name="H10SMATCH"),
            lt.Drift(length=jnp.array([7.0])),
            lt.HorizontalCorrector(length=jnp.array([0.3]), name="H12SMATCH"),
            lt.Drift(length=jnp.array([0.05])),
            lt.BPM(name="BPM13SMATCH", is_active=True),
        ]
    )

    beam = lt.ParticleBeam.from_parameters(
        num_particles=100_000,
        sigma_x=jnp.array([1.75e-4]),
        sigma_y=jnp.array([1.75e-4]),
        energy=jnp.array([1e8]),
    )

    outgoing = segment.track(beam)
    print("outgoing sigma_x:", float(outgoing.sigma_x[0]))
    print("BPM13 reading:", segment.BPM13SMATCH.reading.ravel())

    # Kick the beam with a corrector and watch the BPM move.
    segment.H10SMATCH.angle = jnp.array([2e-4])
    segment.track(beam)
    print("BPM13 after kick:", segment.BPM13SMATCH.reading.ravel())


if __name__ == "__main__":
    from lynx_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
