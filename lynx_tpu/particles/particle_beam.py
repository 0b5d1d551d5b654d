"""Macro-particle beam representation.

``ParticleBeam`` carries ``(..., N, 7)`` particle vectors. Propagation through
a linear map R is ``P' = P @ R^T`` — the dominant FLOPs of tracking.

JAX-native redesign vs the reference (``lynx/particles/particle_beam.py``):

* **Survival masks instead of dynamic culling.** The reference's ``Aperture``
  drops lost particles with boolean indexing, changing ``N`` at runtime —
  incompatible with XLA's static shapes. Here a beam optionally carries a
  ``survival (..., N)`` weight array; dead particles keep flowing through the
  matmuls with weight 0 and all statistics/histograms are weighted. This
  preserves observable semantics (survivor counts, screen images, moments)
  while keeping every shape static under ``jit``/``vmap``/sharding.
* **Explicit PRNG keys.** Random constructors take ``key=``; omitted keys fall
  back to a seeded global (see ``lynx_tpu.random``).
* **Rejection-free ellipsoid sampling.** ``uniform_3d_ellipsoid`` uses the
  direction/radius decomposition (normalized Gaussian direction, cube-root
  radius) instead of the reference's unbounded rejection loop
  (``particle_beam.py:338-364``) — identical distribution, fixed cost, jittable.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from lynx_tpu import random as lynx_random
from lynx_tpu.particles.beam import Beam
from lynx_tpu.particles.parameter_beam import _common_shape, _resolve

Array = jax.Array


def _weighted_mean(values: Array, weights: Optional[Array]) -> Array:
    if weights is None:
        return values.mean(axis=-1)
    total = weights.sum(axis=-1)
    total = jnp.where(total == 0, 1.0, total)
    return (values * weights).sum(axis=-1) / total


def _weighted_std(values: Array, weights: Optional[Array]) -> Array:
    """Std with Bessel correction, matching ``torch.std`` (ddof=1) for
    uniform weights (reference uses ``.std()`` throughout)."""
    if weights is None:
        return values.std(axis=-1, ddof=1)
    mean = _weighted_mean(values, weights)[..., None]
    total = weights.sum(axis=-1)
    denom = jnp.maximum(total - 1.0, 1.0)
    var = (weights * (values - mean) ** 2).sum(axis=-1) / denom
    return jnp.sqrt(var)


def _weighted_cov(a: Array, b: Array, weights: Optional[Array]) -> Array:
    """Cross-covariance with ddof=0, matching the reference's plain mean
    (``particle_beam.py:824-836``)."""
    mu_a = _weighted_mean(a, weights)[..., None]
    mu_b = _weighted_mean(b, weights)[..., None]
    if weights is None:
        return ((a - mu_a) * (b - mu_b)).mean(axis=-1)
    total = weights.sum(axis=-1)
    total = jnp.where(total == 0, 1.0, total)
    return (weights * (a - mu_a) * (b - mu_b)).sum(axis=-1) / total


class ParticleBeam(Beam):
    """Beam of macro-particles.

    :param particles: ``(..., N, 7)`` particle vectors (7th component == 1).
    :param energy: ``(...)`` reference energy in eV.
    :param particle_charges: ``(..., N)`` per-particle charge in C.
    :param survival: optional ``(..., N)`` survival weights in [0, 1]; ``None``
        means all particles are alive.
    """

    _data_fields = ("particles", "energy", "particle_charges", "survival")
    _static_fields = ()

    def __init__(
        self,
        particles: Array,
        energy: Array,
        particle_charges: Optional[Array] = None,
        survival: Optional[Array] = None,
        dtype=None,
    ) -> None:
        particles = jnp.asarray(particles, dtype=dtype)
        assert particles.shape[-2] > 0 and particles.shape[-1] == 7, (
            "Particle vectors must be 7-dimensional."
        )
        dtype = particles.dtype
        self.particles = particles
        self.energy = jnp.asarray(energy, dtype=dtype)
        self.particle_charges = (
            jnp.asarray(particle_charges, dtype=dtype)
            if particle_charges is not None
            else jnp.zeros(particles.shape[:-1], dtype=dtype)
        )
        self.survival = (
            jnp.asarray(survival, dtype=dtype) if survival is not None else None
        )

    # -- constructors ------------------------------------------------------
    @classmethod
    def from_parameters(
        cls,
        num_particles: Optional[int] = None,
        mu_x: Optional[Array] = None,
        mu_y: Optional[Array] = None,
        mu_xp: Optional[Array] = None,
        mu_yp: Optional[Array] = None,
        sigma_x: Optional[Array] = None,
        sigma_y: Optional[Array] = None,
        sigma_xp: Optional[Array] = None,
        sigma_yp: Optional[Array] = None,
        sigma_s: Optional[Array] = None,
        sigma_p: Optional[Array] = None,
        cor_x: Optional[Array] = None,
        cor_y: Optional[Array] = None,
        cor_s: Optional[Array] = None,
        energy: Optional[Array] = None,
        total_charge: Optional[Array] = None,
        key: Optional[Array] = None,
        dtype=jnp.float32,
    ) -> "ParticleBeam":
        """Sample a Gaussian beam from the 15 scalar parameters.

        Defaults match reference ``particle_beam.py:119-137`` (N=100,000).
        """
        shape = _common_shape(
            [mu_x, mu_xp, mu_y, mu_yp, sigma_x, sigma_xp, sigma_y, sigma_yp,
             sigma_s, sigma_p, cor_x, cor_y, cor_s, energy, total_charge]
        )
        num_particles = num_particles if num_particles is not None else 100_000
        mu_x = _resolve(mu_x, 0.0, shape, dtype)
        mu_xp = _resolve(mu_xp, 0.0, shape, dtype)
        mu_y = _resolve(mu_y, 0.0, shape, dtype)
        mu_yp = _resolve(mu_yp, 0.0, shape, dtype)
        sigma_x = _resolve(sigma_x, 175e-9, shape, dtype)
        sigma_xp = _resolve(sigma_xp, 2e-7, shape, dtype)
        sigma_y = _resolve(sigma_y, 175e-9, shape, dtype)
        sigma_yp = _resolve(sigma_yp, 2e-7, shape, dtype)
        sigma_s = _resolve(sigma_s, 1e-6, shape, dtype)
        sigma_p = _resolve(sigma_p, 1e-6, shape, dtype)
        cor_x = _resolve(cor_x, 0.0, shape, dtype)
        cor_y = _resolve(cor_y, 0.0, shape, dtype)
        cor_s = _resolve(cor_s, 0.0, shape, dtype)
        energy = _resolve(energy, 1e8, shape, dtype)
        total_charge = _resolve(total_charge, 0.0, shape, dtype)

        particle_charges = (
            jnp.ones((*shape, num_particles), dtype=dtype)
            * total_charge[..., None]
            / num_particles
        )

        zeros = jnp.zeros(shape, dtype=dtype)
        mean = jnp.stack([mu_x, mu_xp, mu_y, mu_yp, zeros, zeros], axis=-1)

        cov = jnp.zeros((*shape, 6, 6), dtype=dtype)
        cov = cov.at[..., 0, 0].set(sigma_x**2)
        cov = cov.at[..., 0, 1].set(cor_x)
        cov = cov.at[..., 1, 0].set(cor_x)
        cov = cov.at[..., 1, 1].set(sigma_xp**2)
        cov = cov.at[..., 2, 2].set(sigma_y**2)
        cov = cov.at[..., 2, 3].set(cor_y)
        cov = cov.at[..., 3, 2].set(cor_y)
        cov = cov.at[..., 3, 3].set(sigma_yp**2)
        cov = cov.at[..., 4, 4].set(sigma_s**2)
        cov = cov.at[..., 4, 5].set(cor_s)
        cov = cov.at[..., 5, 4].set(cor_s)
        cov = cov.at[..., 5, 5].set(sigma_p**2)

        key = lynx_random.next_key(key)
        z = jax.random.normal(key, (*shape, num_particles, 6), dtype=dtype)
        # Sample x = mean + L z with L the (regularized) Cholesky factor.
        eps = jnp.finfo(dtype).tiny
        chol = jnp.linalg.cholesky(
            cov + eps * jnp.eye(6, dtype=dtype)
        )
        chol = jnp.nan_to_num(chol, nan=0.0)  # degenerate dims (zero variance)
        phase_space = mean[..., None, :] + jnp.einsum(
            "...ij,...nj->...ni",
            chol,
            z,
            precision=jax.lax.Precision.HIGHEST,
        )

        particles = jnp.concatenate(
            [phase_space, jnp.ones((*shape, num_particles, 1), dtype=dtype)], axis=-1
        )
        return cls(
            particles, energy, particle_charges=particle_charges, dtype=dtype
        )

    @classmethod
    def from_twiss(
        cls,
        num_particles: Optional[int] = None,
        beta_x: Optional[Array] = None,
        alpha_x: Optional[Array] = None,
        emittance_x: Optional[Array] = None,
        beta_y: Optional[Array] = None,
        alpha_y: Optional[Array] = None,
        emittance_y: Optional[Array] = None,
        energy: Optional[Array] = None,
        sigma_s: Optional[Array] = None,
        sigma_p: Optional[Array] = None,
        cor_s: Optional[Array] = None,
        total_charge: Optional[Array] = None,
        key: Optional[Array] = None,
        dtype=jnp.float32,
    ) -> "ParticleBeam":
        """Sample from twiss parameters (reference ``particle_beam.py:180-264``)."""
        shape = _common_shape(
            [beta_x, alpha_x, emittance_x, beta_y, alpha_y, emittance_y,
             energy, sigma_s, sigma_p, cor_s, total_charge]
        )
        num_particles = num_particles if num_particles is not None else 1_000_000
        beta_x = _resolve(beta_x, 0.0, shape, dtype)
        alpha_x = _resolve(alpha_x, 0.0, shape, dtype)
        emittance_x = _resolve(emittance_x, 0.0, shape, dtype)
        beta_y = _resolve(beta_y, 0.0, shape, dtype)
        alpha_y = _resolve(alpha_y, 0.0, shape, dtype)
        emittance_y = _resolve(emittance_y, 0.0, shape, dtype)
        energy = _resolve(energy, 1e8, shape, dtype)
        sigma_s = _resolve(sigma_s, 1e-6, shape, dtype)
        sigma_p = _resolve(sigma_p, 1e-6, shape, dtype)
        cor_s = _resolve(cor_s, 0.0, shape, dtype)
        total_charge = _resolve(total_charge, 0.0, shape, dtype)

        beta_x_safe = jnp.where(beta_x == 0, 1.0, beta_x)
        beta_y_safe = jnp.where(beta_y == 0, 1.0, beta_y)
        sigma_x = jnp.sqrt(beta_x * emittance_x)
        sigma_xp = jnp.sqrt(emittance_x * (1 + alpha_x**2) / beta_x_safe)
        sigma_y = jnp.sqrt(beta_y * emittance_y)
        sigma_yp = jnp.sqrt(emittance_y * (1 + alpha_y**2) / beta_y_safe)
        cor_x = -emittance_x * alpha_x
        cor_y = -emittance_y * alpha_y
        zeros = jnp.zeros(shape, dtype=dtype)
        return cls.from_parameters(
            num_particles=num_particles,
            mu_x=zeros,
            mu_xp=zeros,
            mu_y=zeros,
            mu_yp=zeros,
            sigma_x=sigma_x,
            sigma_xp=sigma_xp,
            sigma_y=sigma_y,
            sigma_yp=sigma_yp,
            sigma_s=sigma_s,
            sigma_p=sigma_p,
            energy=energy,
            cor_s=cor_s,
            cor_x=cor_x,
            cor_y=cor_y,
            total_charge=total_charge,
            key=key,
            dtype=dtype,
        )

    @classmethod
    def uniform_3d_ellipsoid(
        cls,
        num_particles: Optional[int] = None,
        radius_x: Optional[Array] = None,
        radius_y: Optional[Array] = None,
        radius_s: Optional[Array] = None,
        sigma_xp: Optional[Array] = None,
        sigma_yp: Optional[Array] = None,
        sigma_p: Optional[Array] = None,
        energy: Optional[Array] = None,
        total_charge: Optional[Array] = None,
        key: Optional[Array] = None,
        dtype=jnp.float32,
    ) -> "ParticleBeam":
        """Waterbag beam: spatial coordinates uniform inside an ellipsoid.

        Reference behavior ``particle_beam.py:266-385``; sampled here
        rejection-free via uniform-ball sampling (Gaussian direction +
        cube-root radius), which has the identical distribution.
        """
        shape = _common_shape(
            [radius_x, radius_y, radius_s, sigma_xp, sigma_yp, sigma_p,
             energy, total_charge]
        )
        num_particles = num_particles if num_particles is not None else 1_000_000
        radius_x = _resolve(radius_x, 1e-3, shape, dtype)
        radius_y = _resolve(radius_y, 1e-3, shape, dtype)
        radius_s = _resolve(radius_s, 1e-3, shape, dtype)

        key = lynx_random.next_key(key)
        key_beam, key_dir, key_r = jax.random.split(key, 3)

        # Momentum plane: an uncorrelated Gaussian beam.
        zeros = jnp.zeros(shape, dtype=dtype)
        beam = cls.from_parameters(
            num_particles=num_particles,
            mu_xp=zeros,
            mu_yp=zeros,
            sigma_xp=sigma_xp,
            sigma_yp=sigma_yp,
            sigma_p=sigma_p,
            energy=energy,
            total_charge=total_charge,
            key=key_beam,
            dtype=dtype,
        )

        # Uniform point in the unit ball, scaled per-axis to the ellipsoid.
        direction = jax.random.normal(key_dir, (*shape, num_particles, 3), dtype=dtype)
        norm = jnp.linalg.norm(direction, axis=-1, keepdims=True)
        norm = jnp.where(norm == 0, 1.0, norm)
        u = jax.random.uniform(key_r, (*shape, num_particles, 1), dtype=dtype)
        ball = direction / norm * u ** (1.0 / 3.0)

        particles = beam.particles
        particles = particles.at[..., 0].set(ball[..., 0] * radius_x[..., None])
        particles = particles.at[..., 2].set(ball[..., 1] * radius_y[..., None])
        particles = particles.at[..., 4].set(ball[..., 2] * radius_s[..., None])
        beam.particles = particles
        return beam

    @classmethod
    def make_linspaced(
        cls,
        num_particles: Optional[int] = None,
        mu_x: Optional[Array] = None,
        mu_y: Optional[Array] = None,
        mu_xp: Optional[Array] = None,
        mu_yp: Optional[Array] = None,
        sigma_x: Optional[Array] = None,
        sigma_y: Optional[Array] = None,
        sigma_xp: Optional[Array] = None,
        sigma_yp: Optional[Array] = None,
        sigma_s: Optional[Array] = None,
        sigma_p: Optional[Array] = None,
        energy: Optional[Array] = None,
        total_charge: Optional[Array] = None,
        dtype=jnp.float32,
    ) -> "ParticleBeam":
        """Deterministic beam of ``n`` particles linspaced in every dimension.

        Reference ``particle_beam.py:387-543`` (default N=10).
        """
        shape = _common_shape(
            [mu_x, mu_xp, mu_y, mu_yp, sigma_x, sigma_xp, sigma_y, sigma_yp,
             sigma_s, sigma_p, energy, total_charge]
        )
        num_particles = num_particles if num_particles is not None else 10
        mu_x = _resolve(mu_x, 0.0, shape, dtype)
        mu_xp = _resolve(mu_xp, 0.0, shape, dtype)
        mu_y = _resolve(mu_y, 0.0, shape, dtype)
        mu_yp = _resolve(mu_yp, 0.0, shape, dtype)
        sigma_x = _resolve(sigma_x, 175e-9, shape, dtype)
        sigma_xp = _resolve(sigma_xp, 2e-7, shape, dtype)
        sigma_y = _resolve(sigma_y, 175e-9, shape, dtype)
        sigma_yp = _resolve(sigma_yp, 2e-7, shape, dtype)
        sigma_s = _resolve(sigma_s, 0.0, shape, dtype)
        sigma_p = _resolve(sigma_p, 0.0, shape, dtype)
        energy = _resolve(energy, 1e8, shape, dtype)
        total_charge = _resolve(total_charge, 0.0, shape, dtype)

        particle_charges = (
            jnp.ones((*shape, num_particles), dtype=dtype)
            * total_charge[..., None]
            / num_particles
        )

        t = jnp.linspace(0.0, 1.0, num_particles, dtype=dtype)

        def linspaced(mu, sigma):
            lo = (mu - sigma)[..., None]
            hi = (mu + sigma)[..., None]
            return lo + (hi - lo) * t

        zeros = jnp.zeros(shape, dtype=dtype)
        columns = [
            linspaced(mu_x, sigma_x),
            linspaced(mu_xp, sigma_xp),
            linspaced(mu_y, sigma_y),
            linspaced(mu_yp, sigma_yp),
            linspaced(zeros, sigma_s),
            linspaced(zeros, sigma_p),
            jnp.ones((*shape, num_particles), dtype=dtype),
        ]
        particles = jnp.stack(columns, axis=-1)
        return cls(
            particles=particles,
            energy=energy,
            particle_charges=particle_charges,
            dtype=dtype,
        )

    @classmethod
    def from_ocelot(cls, parray, dtype=jnp.float32) -> "ParticleBeam":
        """From an Ocelot ParticleArray (duck-typed).

        Reference ``particle_beam.py:545-561``.
        """
        import numpy as np

        num_particles = parray.rparticles.shape[1]
        particles = np.ones((num_particles, 7))
        particles[:, :6] = parray.rparticles.transpose()
        return cls(
            particles=jnp.asarray(particles[None], dtype=dtype),
            energy=jnp.asarray([1e9 * parray.E], dtype=dtype),
            particle_charges=jnp.asarray(np.asarray(parray.q_array)[None], dtype=dtype),
            dtype=dtype,
        )

    @classmethod
    def from_astra(cls, path: str, dtype=jnp.float32) -> "ParticleBeam":
        """Load an Astra particle distribution (reference ``particle_beam.py:563-578``)."""
        import numpy as np

        from lynx_tpu.converters.astra import from_astrabeam

        particles, energy, particle_charges = from_astrabeam(path)
        particles_7d = np.ones((particles.shape[0], 7))
        particles_7d[:, :6] = particles
        return cls(
            particles=jnp.asarray(particles_7d[None], dtype=dtype),
            energy=jnp.asarray([energy], dtype=dtype),
            particle_charges=jnp.asarray(particle_charges[None], dtype=dtype),
            dtype=dtype,
        )

    def transformed_to(
        self,
        mu_x: Optional[Array] = None,
        mu_y: Optional[Array] = None,
        mu_xp: Optional[Array] = None,
        mu_yp: Optional[Array] = None,
        sigma_x: Optional[Array] = None,
        sigma_y: Optional[Array] = None,
        sigma_xp: Optional[Array] = None,
        sigma_yp: Optional[Array] = None,
        sigma_s: Optional[Array] = None,
        sigma_p: Optional[Array] = None,
        energy: Optional[Array] = None,
        total_charge: Optional[Array] = None,
    ) -> "ParticleBeam":
        """Affine renormalization of the particle cloud to new parameters.

        Reference ``particle_beam.py:580-715``.
        """
        shape = self.mu_x.shape
        dtype = self.particles.dtype

        mu_x = mu_x if mu_x is not None else self.mu_x
        mu_y = mu_y if mu_y is not None else self.mu_y
        mu_xp = mu_xp if mu_xp is not None else self.mu_xp
        mu_yp = mu_yp if mu_yp is not None else self.mu_yp
        sigma_x = sigma_x if sigma_x is not None else self.sigma_x
        sigma_y = sigma_y if sigma_y is not None else self.sigma_y
        sigma_xp = sigma_xp if sigma_xp is not None else self.sigma_xp
        sigma_yp = sigma_yp if sigma_yp is not None else self.sigma_yp
        sigma_s = sigma_s if sigma_s is not None else self.sigma_s
        sigma_p = sigma_p if sigma_p is not None else self.sigma_p
        energy = energy if energy is not None else self.energy
        if total_charge is None:
            particle_charges = self.particle_charges
        else:
            total_charge = jnp.broadcast_to(jnp.asarray(total_charge, dtype), shape)
            particle_charges = (
                jnp.ones_like(self.particle_charges)
                * total_charge[..., None]
                / self.particle_charges.shape[-1]
            )

        zeros = jnp.zeros(shape, dtype=dtype)
        new_mu = jnp.stack([mu_x, mu_xp, mu_y, mu_yp, zeros, zeros], axis=-1)
        new_sigma = jnp.stack(
            [sigma_x, sigma_xp, sigma_y, sigma_yp, sigma_s, sigma_p], axis=-1
        )
        old_mu = jnp.stack(
            [self.mu_x, self.mu_xp, self.mu_y, self.mu_yp, zeros, zeros], axis=-1
        )
        old_sigma = jnp.stack(
            [self.sigma_x, self.sigma_xp, self.sigma_y, self.sigma_yp,
             self.sigma_s, self.sigma_p],
            axis=-1,
        )
        old_sigma = jnp.where(old_sigma == 0, 1.0, old_sigma)

        phase_space = self.particles[..., :6]
        phase_space = (
            (phase_space - old_mu[..., None, :])
            / old_sigma[..., None, :]
            * new_sigma[..., None, :]
            + new_mu[..., None, :]
        )
        particles = jnp.concatenate(
            [phase_space, jnp.ones((*phase_space.shape[:-1], 1), dtype=dtype)],
            axis=-1,
        )
        return self.__class__(
            particles=particles,
            energy=energy,
            particle_charges=particle_charges,
            survival=self.survival,
            dtype=dtype,
        )

    def __len__(self) -> int:
        return int(self.num_particles)

    # -- charge / counts ---------------------------------------------------
    @property
    def total_charge(self) -> Array:
        return jnp.sum(self.particle_charges, axis=-1)

    @property
    def num_particles(self) -> int:
        """Static macro-particle count (array dimension)."""
        return self.particles.shape[-2]

    @property
    def num_particles_survived(self) -> Array:
        """Number of alive particles (sum of survival weights)."""
        if self.survival is None:
            return jnp.full(
                self.particles.shape[:-2],
                self.num_particles,
                dtype=self.particles.dtype,
            )
        return self.survival.sum(axis=-1)

    # -- coordinate accessors ----------------------------------------------
    @property
    def xs(self) -> Array:
        return self.particles[..., 0]

    @xs.setter
    def xs(self, value: Array) -> None:
        self.particles = self.particles.at[..., 0].set(value)

    @property
    def xps(self) -> Array:
        return self.particles[..., 1]

    @xps.setter
    def xps(self, value: Array) -> None:
        self.particles = self.particles.at[..., 1].set(value)

    @property
    def ys(self) -> Array:
        return self.particles[..., 2]

    @ys.setter
    def ys(self, value: Array) -> None:
        self.particles = self.particles.at[..., 2].set(value)

    @property
    def yps(self) -> Array:
        return self.particles[..., 3]

    @yps.setter
    def yps(self, value: Array) -> None:
        self.particles = self.particles.at[..., 3].set(value)

    @property
    def ss(self) -> Array:
        return self.particles[..., 4]

    @ss.setter
    def ss(self, value: Array) -> None:
        self.particles = self.particles.at[..., 4].set(value)

    @property
    def ps(self) -> Array:
        return self.particles[..., 5]

    @ps.setter
    def ps(self, value: Array) -> None:
        self.particles = self.particles.at[..., 5].set(value)

    # -- statistics (survival-weighted) ------------------------------------
    @property
    def mu_x(self) -> Array:
        return _weighted_mean(self.xs, self.survival)

    @property
    def sigma_x(self) -> Array:
        return _weighted_std(self.xs, self.survival)

    @property
    def mu_xp(self) -> Array:
        return _weighted_mean(self.xps, self.survival)

    @property
    def sigma_xp(self) -> Array:
        return _weighted_std(self.xps, self.survival)

    @property
    def mu_y(self) -> Array:
        return _weighted_mean(self.ys, self.survival)

    @property
    def sigma_y(self) -> Array:
        return _weighted_std(self.ys, self.survival)

    @property
    def mu_yp(self) -> Array:
        return _weighted_mean(self.yps, self.survival)

    @property
    def sigma_yp(self) -> Array:
        return _weighted_std(self.yps, self.survival)

    @property
    def mu_s(self) -> Array:
        return _weighted_mean(self.ss, self.survival)

    @property
    def sigma_s(self) -> Array:
        return _weighted_std(self.ss, self.survival)

    @property
    def mu_p(self) -> Array:
        return _weighted_mean(self.ps, self.survival)

    @property
    def sigma_p(self) -> Array:
        return _weighted_std(self.ps, self.survival)

    @property
    def sigma_xxp(self) -> Array:
        return _weighted_cov(self.xs, self.xps, self.survival)

    @property
    def sigma_yyp(self) -> Array:
        return _weighted_cov(self.ys, self.yps, self.survival)

    def as_parameter_beam(self) -> "ParameterBeam":
        """The beam's survival-weighted *sample* moments as a
        :class:`ParameterBeam` — the moment-sufficiency fast path.

        For any purely linear (affine 7x7) lattice section, tracked sample
        moments obey exactly the same algebra as Gaussian moments:
        ``mu' = R mu`` and ``Sigma' = R Sigma R^T`` (the affine offsets
        cancel in the centered second moments).  Tracking the returned
        ``ParameterBeam`` therefore yields *ParticleBeam-exact* downstream
        ``mu_*``/``sigma_*`` statistics at moment cost — one O(N) moment
        reduction up front instead of an O(N) matmul per setting (the 7-8x
        HBM-bound gap identified in the round-3 roofline,
        ``docs/performance.md``).

        Conventions: the covariance carries the same Bessel (ddof=1)
        scaling as :attr:`sigma_x` etc., so downstream ``sigma_*`` match
        the particle path's values exactly.  (The reference's mixed-moment
        properties ``sigma_xxp``/``sigma_yyp`` use ddof=0 — reference
        ``particle_beam.py:824-836`` — so those differ by the constant
        factor ``(sum w - 1) / sum w``; the env observations use only
        means and stds.)  Invalid whenever per-particle information is
        consumed downstream (apertures, particle-histogram screens, active
        cavities' nonlinear phase update) — see
        ``lynx_tpu.functional.moment_sufficient``.
        """
        from lynx_tpu.particles.parameter_beam import ParameterBeam

        particles = self.particles
        weights = self.survival
        if weights is None:
            total = jnp.full(
                particles.shape[:-2], self.num_particles, particles.dtype
            )
            mu = particles.mean(axis=-2)
            weighted = particles
        else:
            total_raw = weights.sum(axis=-1)
            total = jnp.where(total_raw == 0, 1.0, total_raw)
            weighted = particles * weights[..., None]
            mu = weighted.sum(axis=-2) / total[..., None]
        centered = particles - mu[..., None, :]
        denom = jnp.maximum(total - 1.0, 1.0)
        # HIGHEST: at default precision the GPU may contract f32 in TF32
        # (10 mantissa bits) — sample second moments would silently lose
        # ~13 bits.
        if weights is None:
            cov = jnp.einsum(
                "...ni,...nj->...ij",
                centered,
                centered,
                precision=jax.lax.Precision.HIGHEST,
            )
        else:
            cov = jnp.einsum(
                "...ni,...nj->...ij",
                centered * weights[..., None],
                centered,
                precision=jax.lax.Precision.HIGHEST,
            )
        cov = cov / denom[..., None, None]
        return ParameterBeam(
            mu, cov, energy=self.energy, total_charge=self.total_charge
        )

    def broadcast(self, shape: tuple) -> "ParticleBeam":
        """Tile the beam to a larger batch shape (reference
        ``particle_beam.py:838-843``)."""
        n = self.num_particles
        return self.__class__(
            particles=jnp.broadcast_to(self.particles, (*shape, n, 7)),
            energy=jnp.broadcast_to(self.energy, shape),
            particle_charges=jnp.broadcast_to(self.particle_charges, (*shape, n)),
            survival=(
                jnp.broadcast_to(self.survival, (*shape, n))
                if self.survival is not None
                else None
            ),
        )

    def __repr__(self) -> str:
        return (
            f"{self.__class__.__name__}(n={self.num_particles!r},"
            f" mu_x={self.mu_x!r}, mu_xp={self.mu_xp!r},"
            f" mu_y={self.mu_y!r}, mu_yp={self.mu_yp!r},"
            f" sigma_x={self.sigma_x!r}, sigma_xp={self.sigma_xp!r},"
            f" sigma_y={self.sigma_y!r}, sigma_yp={self.sigma_yp!r},"
            f" sigma_s={self.sigma_s!r}, sigma_p={self.sigma_p!r},"
            f" energy={self.energy!r},"
            f" total_charge={self.total_charge!r})"
        )
