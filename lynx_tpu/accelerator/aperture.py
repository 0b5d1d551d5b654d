"""Physical aperture (collimator).

JAX-native redesign: the reference culls lost particles with boolean indexing,
changing the particle count at runtime (``lynx/accelerator/aperture.py:89``) —
incompatible with XLA static shapes.  Here lost particles get survival weight 0
and zeroed charge; the array shapes never change.  Observable semantics
(survivor counts, downstream statistics, screen images, the ``Beam.empty``
sentinel when everything is lost) are preserved.
"""

from __future__ import annotations

from typing import Literal, Optional

import jax
import jax.numpy as jnp

from lynx_tpu.accelerator.element import Element
from lynx_tpu.particles import Beam, ParticleBeam

Array = jax.Array


def aperture_survival_mask(
    xs: Array, ys: Array, x_max: Array, y_max: Array, shape: str
) -> Array:
    """Boolean mask of particles that survive the aperture.

    Reference semantics ``aperture.py:80-88``: rectangular uses strict
    inequalities; elliptical is inclusive.
    """
    if shape == "rectangular":
        return (xs > -x_max) & (xs < x_max) & (ys > -y_max) & (ys < y_max)
    elif shape == "elliptical":
        return (xs**2 / x_max**2 + ys**2 / y_max**2) <= 1.0
    raise ValueError(f"Unknown aperture shape {shape!r}")


class Aperture(Element):
    """Particle-culling aperture.

    :param x_max: Horizontal half-aperture in meters.
    :param y_max: Vertical half-aperture in meters.
    :param shape: "rectangular" or "elliptical".
    :param is_active: Whether the aperture blocks particles.
    :param name: Unique identifier of the element.
    """

    _data_fields = ("x_max", "y_max")
    _static_fields = ("shape", "is_active")

    # Non-pytree diagnostic state (class-level default for unflattened copies).
    lost_mask = None
    _last_incoming = None

    def __init__(
        self,
        x_max: Optional[Array] = None,
        y_max: Optional[Array] = None,
        shape: Literal["rectangular", "elliptical"] = "rectangular",
        is_active: bool = True,
        name: Optional[str] = None,
        dtype=jnp.float32,
    ) -> None:
        super().__init__(name=name, dtype=dtype)
        self.x_max = jnp.asarray(
            x_max if x_max is not None else jnp.inf, dtype=dtype
        )
        self.y_max = jnp.asarray(
            y_max if y_max is not None else jnp.inf, dtype=dtype
        )
        self.shape = shape
        self.is_active = is_active
        #: survival mask of the last non-traced track (diagnostics only)
        self.lost_mask = None

    @property
    def is_skippable(self) -> bool:
        return not self.is_active

    def transfer_map(self, energy: Array) -> Array:
        energy = jnp.asarray(energy)
        return jnp.broadcast_to(
            jnp.eye(7, dtype=self.x_max.dtype), (*energy.shape, 7, 7)
        )


    def transfer_map_table(self, energy: Array):
        from lynx_tpu.ops.table import identity_table

        return identity_table()

    def track(self, incoming: Beam) -> Beam:
        # Only applies to particle beams, and only when active
        # (reference ``aperture.py:69-72``).
        if not (isinstance(incoming, ParticleBeam) and self.is_active):
            return incoming

        x_max = self.x_max[..., None] if self.x_max.ndim else self.x_max
        y_max = self.y_max[..., None] if self.y_max.ndim else self.y_max
        mask = aperture_survival_mask(
            incoming.xs, incoming.ys, x_max, y_max, self.shape
        ).astype(incoming.particles.dtype)

        survival = (
            mask if incoming.survival is None else incoming.survival * mask
        )
        outgoing = ParticleBeam(
            incoming.particles,
            incoming.energy,
            particle_charges=incoming.particle_charges * mask,
            survival=survival,
        )

        if not isinstance(survival, jax.core.Tracer):
            self.lost_mask = survival == 0
            self._last_incoming = incoming
            if bool(jnp.all(survival == 0)):
                return Beam.empty  # all particles lost (reference ``:107-109``)
        return outgoing

    @property
    def lost_particles(self) -> Optional[Array]:
        """Particles lost in the last non-traced track (reference
        ``aperture.py:93``). Host-side boolean indexing — shapes are dynamic
        here by design, which is exactly why it lives OUTSIDE the jit path."""
        if self.lost_mask is None or self._last_incoming is None:
            return None
        return self._last_incoming.particles[self.lost_mask]

    @property
    def lost_particle_charges(self) -> Optional[Array]:
        """Charges of the particles lost in the last non-traced track."""
        if self.lost_mask is None or self._last_incoming is None:
            return None
        return self._last_incoming.particle_charges[self.lost_mask]

    def broadcast(self, shape: tuple) -> Element:
        new_aperture = self.__class__(
            x_max=jnp.broadcast_to(self.x_max, shape),
            y_max=jnp.broadcast_to(self.y_max, shape),
            shape=self.shape,
            is_active=self.is_active,
            name=self.name,
        )
        new_aperture.length = jnp.broadcast_to(self.length, shape)
        return new_aperture

    def split(self, resolution: float) -> list[Element]:
        return [self]

    def plot(self, ax, s: float) -> None:
        from matplotlib.patches import Rectangle

        alpha = 1 if self.is_active else 0.2
        patch = Rectangle(
            (s, 0), 0.0, 0.4, color="tab:pink", alpha=alpha, zorder=2
        )
        ax.add_patch(patch)

    @property
    def defining_features(self) -> list[str]:
        return super().defining_features + ["x_max", "y_max", "shape", "is_active"]

    def __repr__(self) -> str:
        return (
            f"{self.__class__.__name__}(x_max={self.x_max!r}, "
            f"y_max={self.y_max!r}, shape={self.shape!r}, "
            f"is_active={self.is_active!r}, name={self.name!r})"
        )
