"""Multi-host (multi-process) initialization for lynx-tpu.

The reference is strictly single-process — it has no distributed backend at
all (SURVEY.md §2.4: no NCCL/MPI/Gloo/UCX anywhere).  On a multi-host GPU
cluster the idiom is ``jax.distributed.initialize`` + one global
:class:`jax.sharding.Mesh` spanning every card of every host; XLA then
hands the collectives to NCCL (NVLink within a host, the network across
hosts) without any hand-written communication code.

Typical launch on N hosts (same program on every host)::

    import lynx_tpu

    lynx_tpu.parallel.initialize()            # auto-detects SLURM / Open MPI
    mesh = lynx_tpu.parallel.global_mesh()    # (batch, particles) global mesh
    beam = lynx_tpu.parallel.host_local_beam_to_global(local_beam, mesh)
    ...

On CPU (tests, local smoke runs) pass the coordinator explicitly::

    lynx_tpu.parallel.initialize("host0:1234", num_processes=2, process_id=i)

See ``docs/distributed.md`` for the full launch recipe (SLURM, manual
multi-process launches).
"""

from __future__ import annotations

from typing import Optional, Sequence, Union

import jax
import numpy as np

__all__ = [
    "initialize",
    "is_initialized",
    "global_mesh",
    "host_local_beam_to_global",
    "process_count",
    "process_index",
]

_initialized = False


def is_initialized() -> bool:
    """Whether :func:`initialize` has successfully run in this process."""
    return _initialized


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids: Optional[Union[int, Sequence[int]]] = None,
    **kwargs,
) -> None:
    """Initialize the JAX distributed runtime for multi-host execution.

    A thin, idempotent wrapper over ``jax.distributed.initialize``.  With no
    arguments, JAX auto-detects the cluster in SLURM and Open MPI
    environments.  For manual launches (e.g. the multi-process
    CPU tests) pass ``coordinator_address``/``num_processes``/``process_id``
    explicitly.

    After this returns, ``jax.devices()`` is the *global* device list across
    all processes and :func:`global_mesh` builds a mesh spanning it.

    Safe to call more than once (subsequent calls are no-ops), and safe to
    call in a single-process run with explicit ``num_processes=1``.
    """
    global _initialized
    if _initialized:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
        local_device_ids=local_device_ids,
        **kwargs,
    )
    _initialized = True


def process_count() -> int:
    """Number of participating processes (1 if not distributed)."""
    return jax.process_count()


def process_index() -> int:
    """This process's index (0 if not distributed)."""
    return jax.process_index()


def global_mesh(
    batch: Optional[int] = None, particles: Optional[int] = None
) -> jax.sharding.Mesh:
    """Build a global ``(batch, particles)`` mesh over all devices of all
    processes.

    By default, the ``batch`` axis spans processes (each host keeps its own
    slice of the settings/env batch — network traffic only for the gradient
    all-reduce) and the ``particles`` axis spans the devices within a
    process (particle-moment ``psum`` stays on the host's NVLink).  Pass explicit sizes to
    override.
    """
    from lynx_tpu.parallel.sharding import BATCH_AXIS, PARTICLE_AXIS

    devices = jax.devices()
    n = len(devices)
    if batch is None and particles is None:
        batch = jax.process_count()
        particles = n // batch
    elif batch is None:
        batch = n // particles
    elif particles is None:
        particles = n // batch
    if batch * particles != n:
        raise ValueError(
            f"mesh ({batch} x {particles}) does not cover {n} global devices"
        )
    mesh_devices = np.asarray(devices).reshape(batch, particles)
    return jax.sharding.Mesh(mesh_devices, (BATCH_AXIS, PARTICLE_AXIS))


def host_local_beam_to_global(beam, mesh: jax.sharding.Mesh):
    """Assemble a globally-sharded beam from per-process local shards.

    Each process passes its *local* slice of the leading batch axis (e.g.
    the env instances it simulates); the result is one global sharded beam
    usable inside ``jit`` under ``mesh``.  Element parameters and
    ``ParameterBeam`` moments are replicated; ``ParticleBeam`` particle axes
    follow the same placement as :func:`lynx_tpu.parallel.shard_beam`.
    """
    from jax.sharding import NamedSharding, PartitionSpec as P

    from lynx_tpu.parallel.sharding import BATCH_AXIS, PARTICLE_AXIS
    from lynx_tpu.particles import ParameterBeam, ParticleBeam

    def build(x, spec):
        return jax.make_array_from_process_local_data(
            NamedSharding(mesh, spec), np.asarray(x)
        )

    if isinstance(beam, ParticleBeam):
        nbatch = beam.particles.ndim - 2
        lead = [BATCH_AXIS] + [None] * (nbatch - 1) if nbatch else []
        return ParticleBeam(
            particles=build(beam.particles, P(*lead, PARTICLE_AXIS, None)),
            energy=build(beam.energy, P(*lead)),
            particle_charges=build(beam.particle_charges, P(*lead, PARTICLE_AXIS)),
            survival=(
                build(beam.survival, P(*lead, PARTICLE_AXIS))
                if beam.survival is not None
                else None
            ),
        )
    if isinstance(beam, ParameterBeam):
        nbatch = beam.energy.ndim
        lead = [BATCH_AXIS] + [None] * (nbatch - 1) if nbatch else []
        return ParameterBeam(
            mu=build(beam._mu, P(*lead, None)),
            cov=build(beam._cov, P(*lead, None, None)),
            energy=build(beam.energy, P(*lead)),
            total_charge=build(beam.total_charge, P(*lead)),
        )
    raise TypeError(type(beam))


def replicate_to_global(tree, mesh: jax.sharding.Mesh):
    """Replicate a host-identical pytree (e.g. a ``Segment``) onto the global
    mesh.  Every process must pass identical values."""
    from jax.sharding import NamedSharding, PartitionSpec as P

    def put(x):
        if not isinstance(x, (jax.Array, np.ndarray)) or np.ndim(x) == 0:
            return x
        return jax.make_array_from_process_local_data(
            NamedSharding(mesh, P(*([None] * np.ndim(x)))), np.asarray(x)
        )

    return jax.tree_util.tree_map(put, tree)
