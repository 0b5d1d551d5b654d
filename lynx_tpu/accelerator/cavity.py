"""Accelerating RF cavity — the one nonlinear, energy-changing element.

Tracking performs (reference ``lynx/accelerator/cavity.py:81-246``):

1. linear propagation through the Rosenzweig–Serafini-style cavity R-matrix,
2. reference-energy update ``E -> E + V cos(phi)``,
3. a phase-dependent nonlinear update of the energy deviation ``p`` per
   particle: ``p' = p Ei b0/(Ef b1) + V b0/(Ef b1) (cos(-s b0 k + phi) - cos(phi))``,
4. second-order longitudinal terms T566/T556/T555 applied to ``s``.

All conditionals are per-batch-entry ``jnp.where`` so that mixed on/off
voltages within one vectorized batch work (the reference's Python-level
``if jnp.any(...)`` guards NaN for such batches; contract from reference
``tests/test_vectorized.py:423-439``).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from lynx_tpu.accelerator.element import Element, matmul
from lynx_tpu.constants import ELECTRON_MASS_EV, SPEED_OF_LIGHT
from lynx_tpu.ops.rmatrix import cavity_rmatrix, cavity_rmatrix_entries
from lynx_tpu.particles import Beam, ParameterBeam, ParticleBeam

Array = jax.Array


class Cavity(Element):
    """Accelerating cavity.

    :param length: Length in meters.
    :param voltage: Voltage of the cavity in volts.
    :param phase: Phase of the cavity in degrees.
    :param frequency: Frequency of the cavity in Hz.
    :param name: Unique identifier of the element.
    """

    _data_fields = ("voltage", "phase", "frequency")

    def __init__(
        self,
        length: Array,
        voltage: Optional[Array] = None,
        phase: Optional[Array] = None,
        frequency: Optional[Array] = None,
        name: Optional[str] = None,
        dtype=jnp.float32,
    ) -> None:
        super().__init__(name=name, length=length, dtype=dtype)

        def param(value):
            return (
                jnp.asarray(value, dtype=dtype)
                if value is not None
                else jnp.zeros_like(self.length)
            )

        self.voltage = param(voltage)
        self.phase = param(phase)
        self.frequency = param(frequency)

    @property
    def is_active(self) -> bool:
        # Under a transformation that traces the voltage (jit-arg segments,
        # lax.switch over pipeline stages) activity cannot be decided at
        # trace time: conservatively take the active path, whose per-entry
        # ``where`` masking is exact for zero-voltage entries anyway.
        if isinstance(self.voltage, jax.core.Tracer):
            return True
        return bool(jnp.any(self.voltage != 0))

    @property
    def is_skippable(self) -> bool:
        return not self.is_active

    def transfer_map(self, energy: Array) -> Array:
        return cavity_rmatrix(
            self.length, self.voltage, self.phase, self.frequency, energy
        )

    def transfer_map_batch_last(self, energy: Array) -> Array:
        return cavity_rmatrix(
            self.length, self.voltage, self.phase, self.frequency, energy,
            batch_last=True,
        )

    def transfer_map_table(self, energy: Array):
        from lynx_tpu.ops.table import entries_to_table

        entries, _, _ = cavity_rmatrix_entries(
            self.length, self.voltage, self.phase, self.frequency, energy
        )
        return entries_to_table(entries)

    def track(self, incoming: Beam) -> Beam:
        if incoming is Beam.empty:
            return incoming
        if isinstance(incoming, (ParameterBeam, ParticleBeam)):
            return self._track_beam(incoming)
        raise TypeError(f"Parameter incoming is of invalid type {type(incoming)}")

    def _track_beam(self, incoming: Beam) -> Beam:
        dtype = self.length.dtype
        energy = jnp.asarray(incoming.energy, dtype=dtype)

        has_energy = energy != 0
        g0 = jnp.where(has_energy, energy / ELECTRON_MASS_EV, 1e10)
        igamma2 = jnp.where(has_energy, 1.0 / g0**2, 0.0)
        beta0 = jnp.where(has_energy, jnp.sqrt(1.0 - igamma2), 1.0)

        phi = jnp.deg2rad(self.phase)
        cos_phi = jnp.cos(phi)
        delta_energy = self.voltage * cos_phi
        outgoing_energy = energy + delta_energy

        # 1. Linear part (table path above 512 flat batch instead of many
        # tiny batched matmuls; see ops/table.py).
        batch_shape = jnp.broadcast_shapes(self.length.shape, energy.shape)
        flat_batch = 1
        for dim in batch_shape:
            flat_batch *= dim
        if isinstance(incoming, ParameterBeam):
            if flat_batch >= 512:
                from lynx_tpu.accelerator.element import apply_table

                linear = apply_table(self.transfer_map_table(energy), incoming)
                outgoing_mu = linear._mu
                outgoing_cov = linear._cov
            else:
                tm = self.transfer_map(energy)
                outgoing_mu = matmul(tm, incoming._mu[..., None])[..., 0]
                outgoing_cov = matmul(
                    tm, matmul(incoming._cov, jnp.swapaxes(tm, -2, -1))
                )
        else:
            tm = self.transfer_map(energy)
            outgoing_particles = matmul(
                incoming.particles, jnp.swapaxes(tm, -2, -1)
            )

        # 2./3. Energy gain + nonlinear p update (guarded per entry).
        # NOTE: gated on delta_energy != 0, not only outgoing_energy > 0 as in
        # the reference (``cavity.py:128``) — the reference's gate overwrites
        # the longitudinal covariance even for V == 0 cavities, breaking the
        # "inactive cavity == drift" contract its own skippable path implies.
        k = 2.0 * jnp.pi * self.frequency / SPEED_OF_LIGHT
        accelerated = (outgoing_energy > 0) & (delta_energy != 0)
        out_E_safe = jnp.where(accelerated, outgoing_energy, 1.0)
        g1 = out_E_safe / ELECTRON_MASS_EV
        g1 = jnp.where(g1 > 1.0, g1, 2.0)  # keep beta1 well-defined
        beta1 = jnp.sqrt(1.0 - 1.0 / g1**2)

        # Second-order longitudinal coefficients: drift-like defaults,
        # refined where the cavity actually accelerates (delta_energy > 0).
        T566_default = 1.5 * self.length * igamma2 / beta0**3
        accel = delta_energy > 0
        dg = jnp.where(accel, g0 - g1, 1.0)
        dgamma = self.voltage / ELECTRON_MASS_EV
        sin_phi = jnp.sin(phi)
        T566 = jnp.where(
            accel,
            self.length
            * (beta0**3 * g0**3 - beta1**3 * g1**3)
            / (2 * beta0 * beta1**3 * g0 * dg * g1**3),
            T566_default,
        )
        T556 = jnp.where(
            accel,
            beta0
            * k
            * self.length
            * dgamma
            * g0
            * (beta1**3 * g1**3 + beta0 * (g0 - g1**3))
            * sin_phi
            / (beta1**3 * g1**3 * dg**2),
            0.0,
        )
        T555 = jnp.where(
            accel,
            beta0**2
            * k**2
            * self.length
            * dgamma
            / 2.0
            * (
                dgamma
                * (
                    2 * g0 * g1**3 * (beta0 * beta1**3 - 1)
                    + g0**2
                    + 3 * g1**2
                    - 2
                )
                / (beta1**3 * g1**3 * dg**3)
                * sin_phi**2
                - (g1 * g0 * (beta1 * beta0 - 1) + 1)
                / (beta1 * g1 * dg**2)
                * cos_phi
            ),
            0.0,
        )

        if isinstance(incoming, ParameterBeam):
            # Mean: apply the same nonlinear refinements as per-particle.
            # Covariance: keep the LINEAR propagation through the cavity map
            # (which already carries r65/r66/r56/r55_cor).  The reference
            # instead *overwrites* cov[5,5] with the incoming value and
            # cov[4,4]/[4,5] with second-order expressions
            # (``cavity.py:140,208-218``) — which contradicts its own
            # ParameterBeam-vs-ParticleBeam consistency contract
            # (``tests/test_compare_beam_type.py``); linear moment transport
            # is the consistent Gaussian treatment and matches the sampled
            # beam to first order.  Adjudicated by Monte Carlo against the
            # Bmad-validated particle path in
            # ``tests/test_cavity_covariance_adjudication.py``: our cov
            # matches the sampled moments to ~0.5%, the reference's
            # overwrite is ~16x off on sigma_p^2 and ~1000x on sigma_s^2.
            mu_in = incoming._mu
            p_updated = mu_in[..., 5] * energy * beta0 / (
                out_E_safe * beta1
            ) + self.voltage * beta0 / (out_E_safe * beta1) * (
                jnp.cos(-mu_in[..., 4] * beta0 * k + phi) - cos_phi
            )
            outgoing_mu = outgoing_mu.at[..., 5].set(
                jnp.where(accelerated, p_updated, outgoing_mu[..., 5])
            )
            s_second_order = outgoing_mu[..., 4] + (
                T566 * mu_in[..., 5] ** 2
                + T556 * mu_in[..., 4] * mu_in[..., 5]
                + T555 * mu_in[..., 4] ** 2
            )
            outgoing_mu = outgoing_mu.at[..., 4].set(
                jnp.where(accelerated, s_second_order, outgoing_mu[..., 4])
            )
            return ParameterBeam(
                outgoing_mu,
                outgoing_cov,
                outgoing_energy,
                total_charge=incoming.total_charge,
            )

        # ParticleBeam branch (per-particle; leading dims broadcast).
        def per_particle(x):
            return x[..., None]

        s_in = incoming.particles[..., 4]
        p_in = incoming.particles[..., 5]
        p_updated = p_in * per_particle(energy * beta0 / (out_E_safe * beta1)) + (
            per_particle(self.voltage * beta0 / (out_E_safe * beta1))
            * (
                jnp.cos(-s_in * per_particle(beta0 * k) + per_particle(phi))
                - per_particle(cos_phi)
            )
        )
        acc_mask = per_particle(accelerated)
        outgoing_particles = outgoing_particles.at[..., 5].set(
            jnp.where(acc_mask, p_updated, outgoing_particles[..., 5])
        )
        s_second_order = outgoing_particles[..., 4] + (
            per_particle(T566) * p_in**2
            + per_particle(T556) * s_in * p_in
            + per_particle(T555) * s_in**2
        )
        outgoing_particles = outgoing_particles.at[..., 4].set(
            jnp.where(acc_mask, s_second_order, outgoing_particles[..., 4])
        )
        return ParticleBeam(
            outgoing_particles,
            outgoing_energy,
            particle_charges=incoming.particle_charges,
            survival=incoming.survival,
        )

    def broadcast(self, shape: tuple) -> Element:
        return self.__class__(
            length=jnp.broadcast_to(self.length, shape),
            voltage=jnp.broadcast_to(self.voltage, shape),
            phase=jnp.broadcast_to(self.phase, shape),
            frequency=jnp.broadcast_to(self.frequency, shape),
            name=self.name,
        )

    def split(self, resolution: float) -> list[Element]:
        """Split into slices carrying a length-proportional share of the
        voltage (same phase/frequency).  The composition converges to the
        unsplit Rosenzweig-Serafini map as the slices shrink (O(1/n^2)) —
        it is an approximation, not exact like the pure-linear elements.
        Unimplemented in the reference (``cavity.py``)."""
        total = float(jnp.max(self.length))
        if total <= 1e-6:
            return [self]
        split_elements: list[Element] = []
        remaining = total
        while remaining > 1e-6:  # ignore sub-micron float residue
            piece = min(float(resolution), remaining)
            split_elements.append(
                Cavity(
                    jnp.full_like(self.length, piece),
                    voltage=self.voltage * (piece / total),
                    phase=self.phase,
                    frequency=self.frequency,
                )
            )
            remaining -= piece
        return split_elements

    def plot(self, ax, s: float) -> None:
        from matplotlib.patches import Rectangle

        alpha = 1 if self.is_active else 0.2
        patch = Rectangle(
            (s, 0),
            float(self.length.ravel()[0]),
            0.4,
            color="gold",
            alpha=alpha,
            zorder=2,
        )
        ax.add_patch(patch)

    @property
    def defining_features(self) -> list[str]:
        return super().defining_features + ["length", "voltage", "phase", "frequency"]

    def __repr__(self) -> str:
        return (
            f"{self.__class__.__name__}(length={self.length!r}, "
            f"voltage={self.voltage!r}, phase={self.phase!r}, "
            f"frequency={self.frequency!r}, name={self.name!r})"
        )
