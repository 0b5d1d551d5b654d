"""Settings-amortized particle moment sweep.

Workload: ONE shared ``(N, 7)`` particle cloud observed under B different
magnet settings (the RL/tuning sweep, BASELINE.md:27), where the observation
is the survival-weighted first and second moments after the lattice.

For a *purely affine* run with moments-only observation this is
algebraically redundant — sample moments propagate exactly as
``mu' = R mu``, ``Sigma' = R Sigma R^T``, so
``ParticleBeam.as_parameter_beam()`` plus the moment sweep is the cheaper
route (the env's ``"moments"`` method).  This module is the *fidelity* path
for runs where per-particle information is irreducible: interleaved ACTIVE
APERTURES make the per-setting survival weights position-dependent, which no
moment algebra can express.

The plan format comes from ``accelerator.fused.particle_moment_plan``:
``("map", layout)`` entries apply a composed sparse affine map whose dynamic
cells index into a flat tuple of ``(B,)`` per-setting scalars, and
``("aperture", ...)`` entries multiply the survival weights by the aperture
mask at the current coordinates.  The walk is plain ``jnp``: it materializes
a ``(B, 7, N)`` coordinate array per map entry, so it is bound by device
memory bandwidth.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp

Array = jax.Array


def _aperture_mask(xs, ys, x_max, y_max, shape):
    """Survival mask matching ``accelerator.aperture.aperture_survival_mask``
    (rectangular strict, elliptical inclusive)."""
    if shape == "rectangular":
        return (
            (xs > -x_max) & (xs < x_max) & (ys > -y_max) & (ys < y_max)
        )
    return (xs**2 / x_max**2 + ys**2 / y_max**2) <= 1.0


def _apply_layout(layout, coords, scalars):
    """Push per-setting coordinates ``(B, 7, ...)`` through a sparse 7x7
    layout: float cells are structural literals, int cells index the
    ``(B,)`` scalars."""
    lead = (-1,) + (1,) * (coords.ndim - 2)
    rows = []
    for r in range(7):
        acc = None
        for j in range(7):
            cell = layout[r][j]
            if isinstance(cell, float):
                if cell == 0.0:
                    continue
                term = coords[:, j] if cell == 1.0 else cell * coords[:, j]
            else:
                term = scalars[cell].reshape(lead) * coords[:, j]
            acc = term if acc is None else acc + term
        rows.append(acc if acc is not None else jnp.zeros_like(coords[:, 0]))
    return jnp.stack(rows, axis=1)


def moment_sums(entries, scalars, particles, weights):
    """Survival-weighted moment sums of ``particles`` after the plan.

    :param entries: ``("map", layout)`` or ``("aperture", x_idx, y_idx,
        cx_idx, cy_idx, shape)``; the aperture mask is evaluated at the
        current coordinates offset by the ``(cx, cy)`` plane centers.
    :param scalars: non-empty tuple of ``(B,)`` per-setting scalars.
    :param particles: ``(N, 7)`` shared cloud.
    :param weights: ``(N,)`` initial survival weights.
    :return: ``(s1, s2, w_sum)`` — ``(B, 7)`` weighted coordinate sums,
        ``(B, 7, 7)`` weighted second-moment sums and ``(B,)`` weight sums.
    """
    B = scalars[0].shape[0]
    coords = jnp.broadcast_to(
        jnp.moveaxis(particles, -1, -2)[None], (B, 7, particles.shape[0])
    )
    w = jnp.broadcast_to(weights[None], (B, particles.shape[0]))
    for entry in entries:
        if entry[0] == "map":
            coords = _apply_layout(entry[1], coords, scalars)
        else:
            _, x_idx, y_idx, cx_idx, cy_idx, shape = entry
            mask = _aperture_mask(
                coords[:, 0] + scalars[cx_idx][:, None],
                coords[:, 2] + scalars[cy_idx][:, None],
                scalars[x_idx][:, None],
                scalars[y_idx][:, None],
                shape,
            )
            w = w * mask.astype(w.dtype)
    weighted = w[:, None, :] * coords
    s1 = jnp.sum(weighted, axis=-1)
    # HIGHEST: an f32 contraction may otherwise run in TF32 on the GPU
    # (10 mantissa bits), which would cost second moments ~3 digits.
    s2 = jnp.einsum(
        "bin,bjn->bij",
        weighted,
        coords,
        precision=jax.lax.Precision.HIGHEST,
    )
    return s1, s2, jnp.sum(w, axis=-1)


def particle_moments_from_sums(
    s1: Array, s2: Array, w_sum: Array
) -> Tuple[Array, Array]:
    """Convert weighted moment sums into ``(mu, cov)`` with the package's
    statistics conventions (``_weighted_mean`` / ``_weighted_std``:
    weight-sum normalization for means, Bessel ``max(W - 1, 1)`` for the
    covariance) — so ``sqrt(cov[r, r])`` equals ``sigma_*`` exactly."""
    total = jnp.where(w_sum == 0, 1.0, w_sum)
    mu = s1 / total[..., None]
    centered = s2 - w_sum[..., None, None] * (
        mu[..., :, None] * mu[..., None, :]
    )
    denom = jnp.maximum(w_sum - 1.0, 1.0)
    return mu, centered / denom[..., None, None]


def sweep_particle_moments(
    entries: tuple,
    scalars: tuple,
    particles: Array,
    weights: Array,
    batch_size: "int | None" = None,
) -> Tuple[Array, Array, Array]:
    """Numerically-hardened moment sweep: returns per-setting
    ``(mu (B, 7), cov (B, 7, 7), w_sum (B,))`` of the shared cloud after
    the plan (``accelerator.fused.particle_moment_plan`` format, i.e.
    4-field ``("aperture", x_idx, y_idx, shape)`` entries).

    Raw second moments give ``sigma^2 = E[x^2] - mu^2``, which in f32 loses
    ~|mu|/sigma digits to cancellation (a beam focused to a 1e-6 m spot at a
    6e-4 m offset leaves ~1 significant digit).  This applies the standard
    shifted-moments cure: it sweeps the *deviation* cloud
    ``delta = x - mean(x)`` — exactly linear, because ``delta``'s
    homogeneous 7th component is 0, which switches every affine column
    off — and reconstructs absolute positions at each aperture plane from
    the mean's per-plane image ``R_prefix @ c`` (exact: affine maps
    commute with the decomposition ``x = c + delta``).  Final moments:
    ``mu = R_total c + s1/W`` and the covariance from deviation sums,
    both cancellation-free.

    :param batch_size: the number of settings B; required only when the
        plan has no per-setting scalars (identity-only lattices), which
        carry no settings axis of their own.
    """
    dtype = particles.dtype
    if not scalars:
        if batch_size is None:
            raise ValueError(
                "the plan has no per-setting scalars (identity-only"
                " lattice); pass batch_size= to define the settings axis"
            )
        scalars = (jnp.zeros((batch_size,), dtype),)
    B = scalars[0].shape[0]

    total_w = jnp.sum(weights)
    total_w = jnp.where(total_w == 0, 1.0, total_w)
    center = jnp.sum(particles * weights[:, None], axis=0) / total_w
    center = center.at[6].set(1.0)
    delta = particles - center

    # Track the center's per-setting image to (a) offset each aperture
    # mask, (b) produce the final mean image.
    image = jnp.broadcast_to(center.astype(dtype), (B, 7))
    scalars = tuple(s.astype(dtype) for s in scalars)
    walk_entries = []
    extra = list(scalars)
    for entry in entries:
        if entry[0] == "map":
            walk_entries.append(entry)
            image = _apply_layout(entry[1], image, scalars)
        else:
            _, x_idx, y_idx, shape = entry
            cx_idx = len(extra)
            extra.append(image[:, 0])
            cy_idx = len(extra)
            extra.append(image[:, 2])
            walk_entries.append(
                ("aperture", x_idx, y_idx, cx_idx, cy_idx, shape)
            )

    s1, s2, w_sum = moment_sums(
        tuple(walk_entries), tuple(extra), delta, weights
    )
    # The deviation cloud's mean IS the shift; moments of the absolute
    # cloud are the deviation moments re-centered on the tracked image.
    shift, cov = particle_moments_from_sums(s1, s2, w_sum)
    return image + shift, cov, w_sum
