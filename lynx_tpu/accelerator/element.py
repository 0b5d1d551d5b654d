"""Element base class and the generic linear tracking rule.

Reference behavior contract: ``lynx/accelerator/element.py``.

Design: an element is a mutable pytree (see ``lynx_tpu._module``). Its
``transfer_map(energy)`` is a pure function of its array fields, so the whole
lattice traces cleanly under jit/grad/vmap.  All matmuls on the physics path
use ``Precision.HIGHEST``: at default precision XLA:GPU may run an f32
contraction in TF32 on the tensor cores (10 mantissa bits, ~3 decimal
digits), far too coarse for beam optics (positions at 1e-9..1e-3 m scales).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from lynx_tpu._module import Module
from lynx_tpu.particles import Beam, ParameterBeam, ParticleBeam
from lynx_tpu.utils import UniqueNameGenerator

Array = jax.Array

generate_unique_name = UniqueNameGenerator(prefix="unnamed_element")

#: Full-precision matmul for physics (the GPU default may be TF32 — not
#: acceptable).
PRECISION = jax.lax.Precision.HIGHEST

#: Opt-in: apply composed tables to ParticleBeam as coordinate-row
#: multiply-adds over the particle axis instead of densifying to a
#: (..., 7, 7) matmul.  Off by default pending measurements on the card.
PARTICLE_ROWS_PATH = False


def matmul(a: Array, b: Array) -> Array:
    return jnp.matmul(a, b, precision=PRECISION)


def to_batch_last(tm: Array) -> Array:
    """(..., 7, 7) -> (7, 7, ...): batch onto the trailing axes."""
    return jnp.moveaxis(tm, (-2, -1), (0, 1))


def from_batch_last(tm_bl: Array) -> Array:
    """(7, 7, ...) -> (..., 7, 7)."""
    return jnp.moveaxis(tm_bl, (0, 1), (-2, -1))


def apply_table(total, beam: Beam) -> Beam:
    """Apply a composed sparse table (see ``ops/table.py``) to a beam."""
    from lynx_tpu.ops import table as tbl

    if beam is Beam.empty:
        return beam
    if isinstance(beam, ParameterBeam):
        dtype = beam._mu.dtype
        mu_cells = [beam._mu[..., i] for i in range(7)]
        out_mu_cells = tbl.matvec(total, mu_cells)
        cov_table = tbl.table_from_batch_first(beam._cov)
        out_cov_table = tbl.cov_sandwich(total, cov_table)
        shapes = [jnp.shape(c) for c in out_mu_cells if not isinstance(c, float)]
        shapes += [
            jnp.shape(c)
            for row in out_cov_table
            for c in row
            if not isinstance(c, float)
        ]
        batch_shape = jnp.broadcast_shapes(beam.energy.shape, *shapes)
        mu = jnp.stack(
            [tbl.broadcast_cell(c, batch_shape, dtype) for c in out_mu_cells],
            axis=-1,
        )
        cov = jnp.stack(
            [
                jnp.stack(
                    [tbl.broadcast_cell(c, batch_shape, dtype) for c in row],
                    axis=-1,
                )
                for row in out_cov_table
            ],
            axis=-2,
        )
        return ParameterBeam(mu, cov, beam.energy, total_charge=beam.total_charge)
    if isinstance(beam, ParticleBeam):
        dtype = beam.particles.dtype
        if PARTICLE_ROWS_PATH:
            # Push particles as 7 coordinate rows (..., N) through the
            # sparse table — 49 fused multiply-adds over the particle
            # axis, skipping structural zeros; no
            # (..., 7, 7) map is densified and no (..., N, 7)-layout
            # matmul is issued.
            rows = [beam.particles[..., i] for i in range(7)]
            expanded = [
                [c if isinstance(c, float) else c[..., None] for c in row]
                for row in total
            ]
            out_rows = tbl.matvec(expanded, rows)
            row_shape = jnp.broadcast_shapes(
                beam.particles.shape[:-1],
                *[jnp.shape(r) for r in out_rows if not isinstance(r, float)],
            )
            particles = jnp.stack(
                [
                    jnp.broadcast_to(
                        jnp.asarray(r, dtype) if isinstance(r, float) else r,
                        row_shape,
                    )
                    for r in out_rows
                ],
                axis=-1,
            )
            return ParticleBeam(
                particles,
                beam.energy,
                particle_charges=beam.particle_charges,
                survival=beam.survival,
            )
        shapes = [
            jnp.shape(c) for row in total for c in row if not isinstance(c, float)
        ]
        batch_shape = jnp.broadcast_shapes(beam.energy.shape, *shapes)
        tm = jnp.stack(
            [
                jnp.stack(
                    [tbl.broadcast_cell(c, batch_shape, dtype) for c in row],
                    axis=-1,
                )
                for row in total
            ],
            axis=-2,
        )
        return apply_transfer_map(tm, beam)
    raise TypeError(f"Parameter incoming is of invalid type {type(beam)}")


def apply_transfer_map_batch_last(tm_bl: Array, beam: Beam) -> Beam:
    """Apply a batch-last ``(7, 7, ...)`` map to a beam.

    ParameterBeam moments stay in batch-last end-to-end (no transposes);
    ParticleBeam converts the single folded matrix back (the particle push
    itself is a bandwidth-bound contraction in standard layout).
    """
    if beam is Beam.empty:
        return beam
    if isinstance(beam, ParameterBeam):
        batch_shape = jnp.broadcast_shapes(tm_bl.shape[2:], beam.energy.shape)
        tm_bl = jnp.broadcast_to(tm_bl, (7, 7, *batch_shape))
        mu_bl = jnp.moveaxis(
            jnp.broadcast_to(beam._mu, (*batch_shape, 7)), -1, 0
        )
        cov_bl = jnp.moveaxis(
            jnp.broadcast_to(beam._cov, (*batch_shape, 7, 7)), (-2, -1), (0, 1)
        )
        mu = jnp.moveaxis(
            jnp.einsum("ij...,j...->i...", tm_bl, mu_bl, precision=PRECISION),
            0,
            -1,
        )
        cov = jnp.moveaxis(
            jnp.einsum(
                "ij...,jk...,lk...->il...", tm_bl, cov_bl, tm_bl,
                precision=PRECISION,
            ),
            (0, 1),
            (-2, -1),
        )
        return ParameterBeam(mu, cov, beam.energy, total_charge=beam.total_charge)
    return apply_transfer_map(from_batch_last(tm_bl), beam)


def apply_transfer_map(tm: Array, beam: Beam) -> Beam:
    """Propagate a beam through a ``(..., 7, 7)`` linear map.

    * ``ParameterBeam``: mu' = R mu ; cov' = R cov R^T
    * ``ParticleBeam``:  P' = P R^T   (reference ``element.py:71-92``)

    For large batches the moment propagation runs in batch-last layout
    (elementwise multiply-adds over the batch) instead of many tiny batched
    7x7 matmuls.
    """
    if beam is Beam.empty:
        return beam
    if isinstance(beam, ParameterBeam):
        batch_shape = jnp.broadcast_shapes(tm.shape[:-2], beam.energy.shape)
        flat_batch = 1
        for dim in batch_shape:
            flat_batch *= dim
        if flat_batch >= 512:
            tm_bl = jnp.moveaxis(
                jnp.broadcast_to(tm, (*batch_shape, 7, 7)), (-2, -1), (0, 1)
            )
            mu_bl = jnp.moveaxis(
                jnp.broadcast_to(beam._mu, (*batch_shape, 7)), -1, 0
            )
            cov_bl = jnp.moveaxis(
                jnp.broadcast_to(beam._cov, (*batch_shape, 7, 7)), (-2, -1), (0, 1)
            )
            mu = jnp.moveaxis(
                jnp.einsum("ij...,j...->i...", tm_bl, mu_bl, precision=PRECISION),
                0,
                -1,
            )
            cov = jnp.moveaxis(
                jnp.einsum(
                    "ij...,jk...,lk...->il...",
                    tm_bl,
                    cov_bl,
                    tm_bl,
                    precision=PRECISION,
                ),
                (0, 1),
                (-2, -1),
            )
        else:
            mu = matmul(tm, beam._mu[..., None])[..., 0]
            cov = matmul(tm, matmul(beam._cov, jnp.swapaxes(tm, -2, -1)))
        return ParameterBeam(
            mu, cov, beam.energy, total_charge=beam.total_charge
        )
    if isinstance(beam, ParticleBeam):
        particles = matmul(beam.particles, jnp.swapaxes(tm, -2, -1))
        return ParticleBeam(
            particles,
            beam.energy,
            particle_charges=beam.particle_charges,
            survival=beam.survival,
        )
    raise TypeError(f"Parameter incoming is of invalid type {type(beam)}")


class Element(Module):
    """Base class for accelerator lattice elements.

    :param name: Unique identifier of the element.
    """

    _data_fields = ("length",)
    _static_fields = ("name",)

    def __init__(
        self,
        name: Optional[str] = None,
        length: Optional[Array] = None,
        dtype=jnp.float32,
    ) -> None:
        self.name = name if name is not None else generate_unique_name()
        self.length = jnp.asarray(
            length if length is not None else jnp.zeros((1,)), dtype=dtype
        )

    # -- physics -----------------------------------------------------------
    def transfer_map(self, energy: Array) -> Array:
        r"""The element's ``(..., 7, 7)`` map over trace space
        ``(x, x', y, y', s, p, 1)``; the constant 7th component carries affine
        kicks (reference ``element.py:37-59``)."""
        raise NotImplementedError

    def track(self, incoming: Beam) -> Beam:
        """Track a beam through the element (generic linear rule)."""
        if incoming is Beam.empty:
            return incoming
        return apply_transfer_map(self.transfer_map(incoming.energy), incoming)

    def transfer_map_batch_last(self, energy: Array) -> Array:
        """``(7, 7, ...)`` layout variant of :meth:`transfer_map`.

        Subclasses with hot builders override this to assemble natively in
        batch-last layout (saves a large strided transpose per element on
        the big-batch path); the default transposes the standard map."""
        return to_batch_last(self.transfer_map(energy))

    def transfer_map_table(self, energy: Array):
        """Sparse-table form of the map (see ``ops/table.py``): a 7x7 list
        of ``(batch,)`` cells with literal 0/1 identity entries.  The
        big-batch flush path and the particle moment sweep consume this;
        the default slices the dense map (correct but dense)."""
        from lynx_tpu.ops.table import table_from_batch_first

        return table_from_batch_first(self.transfer_map(energy))

    def __call__(self, incoming: Beam) -> Beam:
        return self.track(incoming)

    forward = __call__  # reference API parity (``element.py:96-98``)

    # -- structure ---------------------------------------------------------
    def broadcast(self, shape: tuple) -> "Element":
        """Broadcast the element's parameters to higher batch dimensions."""
        raise NotImplementedError

    @property
    def is_skippable(self) -> bool:
        """Whether the element is purely linear so its map can be fused with
        neighbouring maps during tracking."""
        raise NotImplementedError

    @property
    def defining_features(self) -> list[str]:
        """Feature names that define the element (for saving/equality)."""
        return []

    def split(self, resolution: float) -> list["Element"]:
        """Split into slices no longer than ``resolution`` meters."""
        raise NotImplementedError

    def plot(self, ax, s: float) -> None:
        """Draw a representation of this element at position ``s``."""
        raise NotImplementedError

    def __eq__(self, other) -> bool:
        if type(self) is not type(other):
            return NotImplemented
        for feature in self.defining_features:
            a, b = getattr(self, feature), getattr(other, feature)
            if isinstance(a, jax.Array) or isinstance(b, jax.Array):
                if jnp.shape(a) != jnp.shape(b) or not bool(
                    jnp.all(jnp.asarray(a) == jnp.asarray(b))
                ):
                    return False
            elif a != b:
                return False
        return True

    def __hash__(self) -> int:
        return id(self)

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}(name={self.name!r})"
