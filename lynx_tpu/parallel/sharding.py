"""Multi-chip sharding for lynx-tpu.

The reference is strictly single-process: its only scale-out axis is the
in-process batch dimension (SURVEY.md §2.4).  Here we map that design to a
device mesh with two named axes:

* ``"batch"``     — vectorized lattice settings / RL environment instances
  (the data-parallel axis; equivalent of the reference's ``broadcast``),
* ``"particles"`` — the macro-particle axis of a ``ParticleBeam`` (the
  "long axis"; sharding it plays the role tensor/sequence parallelism plays
  in NN frameworks).

Everything tracks through ``jit`` with input ``NamedSharding``s; XLA inserts
the collectives (``psum`` over the particle axis for beam moments/histograms,
gradient ``psum`` over batch) and hands them to NCCL.  No hand-written
NCCL/MPI analog is needed — by construction there is nothing like the
reference to port here.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lynx_tpu.particles import Beam, ParameterBeam, ParticleBeam

BATCH_AXIS = "batch"
PARTICLE_AXIS = "particles"


def make_mesh(
    n_devices: Optional[int] = None,
    batch: Optional[int] = None,
    particles: Optional[int] = None,
) -> Mesh:
    """Create a ``(batch, particles)`` device mesh.

    By default the batch axis gets 2 devices (if available) and the particle
    axis the rest; pass explicit sizes to override.
    """
    devices = jax.devices()
    n = n_devices if n_devices is not None else len(devices)
    if batch is None and particles is None:
        batch = 2 if n % 2 == 0 and n > 1 else 1
        particles = n // batch
    elif batch is None:
        batch = n // particles
    elif particles is None:
        particles = n // batch
    assert batch * particles == n, (batch, particles, n)
    mesh_devices = np.asarray(devices[:n]).reshape(batch, particles)
    return Mesh(mesh_devices, (BATCH_AXIS, PARTICLE_AXIS))


def shard_beam(beam: Beam, mesh: Mesh) -> Beam:
    """Place a beam on the mesh: leading batch dim over ``batch``, particle
    dim over ``particles`` (ParameterBeam moments are replicated over the
    particle axis)."""

    def put(x, spec):
        return jax.device_put(x, NamedSharding(mesh, spec))

    if isinstance(beam, ParticleBeam):
        nbatch = beam.particles.ndim - 2
        lead = [BATCH_AXIS] + [None] * (nbatch - 1) if nbatch else []
        beam = ParticleBeam(
            particles=put(beam.particles, P(*lead, PARTICLE_AXIS, None)),
            energy=put(beam.energy, P(*lead)),
            particle_charges=put(beam.particle_charges, P(*lead, PARTICLE_AXIS)),
            survival=(
                put(beam.survival, P(*lead, PARTICLE_AXIS))
                if beam.survival is not None
                else None
            ),
        )
        return beam
    if isinstance(beam, ParameterBeam):
        nbatch = beam.energy.ndim
        lead = [BATCH_AXIS] + [None] * (nbatch - 1) if nbatch else []
        return ParameterBeam(
            mu=put(beam._mu, P(*lead, None)),
            cov=put(beam._cov, P(*lead, None, None)),
            energy=put(beam.energy, P(*lead)),
            total_charge=put(beam.total_charge, P(*lead)),
        )
    raise TypeError(type(beam))


def shard_segment(segment, mesh: Mesh):
    """Place element parameters on the mesh: leading batch dim over
    ``batch``, everything else replicated."""

    def put(x):
        if not isinstance(x, jax.Array) or x.ndim == 0:
            return x
        spec = (
            P(BATCH_AXIS, *([None] * (x.ndim - 1)))
            if x.shape[0] > 1
            else P(*([None] * x.ndim))
        )
        return jax.device_put(x, NamedSharding(mesh, spec))

    return jax.tree_util.tree_map(put, segment)


def make_tuning_train_step(optimizer, loss_fn):
    """Build a jitted full training step for gradient-based lattice tuning.

    ``loss_fn(segment, beam) -> scalar``.  The returned step function is the
    multi-chip training step: with inputs sharded via :func:`shard_beam` /
    :func:`shard_segment`, XLA partitions the tracking over the mesh and
    all-reduces the per-shard gradient contributions.
    """

    import optax

    @jax.jit
    def train_step(segment, opt_state, beam):
        loss, grads = jax.value_and_grad(loss_fn)(segment, beam)
        updates, opt_state = optimizer.update(grads, opt_state)
        segment = optax.apply_updates(segment, updates)
        return segment, opt_state, loss

    return train_step
