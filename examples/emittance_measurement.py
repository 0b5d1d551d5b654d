"""Quad-scan emittance measurement by differentiable fitting.

The canonical accelerator-physics measurement: sweep a quadrupole's
strength, record the beam size on a downstream screen at every setting, and
reconstruct the *incoming* beam's transverse phase-space (sigma_11,
sigma_12, sigma_22 — hence the geometric emittance) from the curve.

Classically this is a linear least-squares fit through hand-derived
transfer-matrix algebra.  Here it falls out of the framework directly: the
measured curve is a vmapped forward simulation, and the reconstruction is
``lynx_tpu.tune`` running gradient descent on the incoming beam's moments
through the same differentiable tracking — all settings fitted in parallel,
entirely on device.

Run: python examples/emittance_measurement.py
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import optax

import lynx_tpu as lt
from lynx_tpu.functional import track
from lynx_tpu.tuning import tune


def make_beamline(k1: jax.Array) -> lt.Segment:
    """Quadrupole (scanned) + drift to the observation screen."""
    return lt.Segment(
        [
            lt.Quadrupole(length=jnp.array([0.15]), k1=k1, name="scan_quad"),
            lt.Drift(length=jnp.array([1.2]), name="to_screen"),
        ]
    )


def simulated_sigma_x(k1: jax.Array, beam: lt.ParameterBeam) -> jax.Array:
    """Beam size at the screen for one quad setting."""
    outgoing, _ = track(make_beamline(k1[None]), beam)
    return outgoing.sigma_x[0]


def main() -> None:
    # --- the machine: an incoming beam we pretend not to know -------------
    true_beam = lt.ParameterBeam.from_twiss(
        beta_x=jnp.array([8.0]),
        alpha_x=jnp.array([-1.5]),
        emittance_x=jnp.array([2.2e-9]),
        beta_y=jnp.array([5.0]),
        alpha_y=jnp.array([0.7]),
        emittance_y=jnp.array([1.8e-9]),
        energy=jnp.array([1.5e8]),
    )
    true_emittance = float(true_beam.emittance_x[0])

    # --- the measurement: sigma_x(k1) over the scan ------------------------
    k1_scan = jnp.linspace(-14.0, 14.0, 17)
    measure = jax.jit(jax.vmap(simulated_sigma_x, in_axes=(0, None)))
    measured = measure(k1_scan, true_beam)
    print(f"scan: {len(k1_scan)} settings, sigma_x "
          f"{float(measured.min()) * 1e6:.1f}-{float(measured.max()) * 1e6:.1f} um")

    # --- the reconstruction: fit (sigma_11, sigma_12, sigma_22) -----------
    # Parametrize in log/scaled space so Adam is well-conditioned; start from
    # a deliberately wrong guess (2x emittance, no correlation).
    def beam_from_params(params: jax.Array) -> lt.ParameterBeam:
        s11 = jnp.exp(params[0]) * 1e-8   # [m^2]
        s22 = jnp.exp(params[1]) * 1e-10  # [rad^2]
        # Correlation through a bounded parameter keeps the matrix PSD.
        s12 = jnp.tanh(params[2]) * jnp.sqrt(s11 * s22)
        mu = jnp.zeros((1, 7)).at[..., 6].set(1.0)
        cov = jnp.zeros((1, 7, 7))
        cov = cov.at[..., 0, 0].set(s11)
        cov = cov.at[..., 0, 1].set(s12)
        cov = cov.at[..., 1, 0].set(s12)
        cov = cov.at[..., 1, 1].set(s22)
        return lt.ParameterBeam(
            mu, cov, energy=jnp.array([1.5e8]), total_charge=jnp.array([0.0])
        )

    def loss_fn(params, k1_scan, measured):
        predicted = jax.vmap(simulated_sigma_x, in_axes=(0, None))(
            k1_scan, beam_from_params(params)
        )
        return jnp.mean((predicted / measured - 1.0) ** 2)

    params0 = jnp.array([jnp.log(2.0), jnp.log(2.0), 0.0])
    params, losses = tune(
        loss_fn,
        params0,
        k1_scan,
        measured,
        optimizer=optax.adam(5e-2),
        steps=600,
    )

    fitted = beam_from_params(params)
    s11 = float(fitted._cov[0, 0, 0])
    s12 = float(fitted._cov[0, 0, 1])
    s22 = float(fitted._cov[0, 1, 1])
    emittance = float(jnp.sqrt(s11 * s22 - s12**2))
    print(f"fit loss: {float(losses[0]):.3e} -> {float(losses[-1]):.3e}")
    print(f"true  emittance_x: {true_emittance:.4e} m rad")
    print(f"fitted emittance_x: {emittance:.4e} m rad "
          f"({100 * abs(emittance / true_emittance - 1):.2f}% error)")
    print(f"fitted sigma_11={s11:.3e}, sigma_12={s12:.3e}, sigma_22={s22:.3e}")


if __name__ == "__main__":
    from lynx_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
