"""Pipeline parallelism over lattice stages (GPipe-style).

The reference has no pipeline parallelism (SURVEY.md §2.4 marks it absent;
the equivalent here is "segment-stage pipelining across devices").
Here a lattice is split into contiguous stages placed one-per-device along a
``"stage"`` mesh axis, and microbatches of beams stream through the stages:
device ``s`` tracks microbatch ``t - s`` at step ``t`` while handing its
previous result to device ``s + 1`` via ``lax.ppermute``.  After
``S - 1 + M`` steps every microbatch has crossed every stage — the classic
GPipe schedule with bubble fraction ``(S - 1) / (S - 1 + M)``.

For beam tracking this trades the all-device data parallelism of
``parallel.sharding`` for per-device *lattice locality*: each device only
materializes (and differentiates through) its own stage's transfer maps,
which is the memory-relevant regime for very long lattices (thousands of
elements, SURVEY §5 "long axis") with per-stage nonlinear breaks (cavities)
that prevent global map merging.

Everything is a pure function of (stages, beam): magnet parameters stay
traced, so ``jax.grad`` flows through the pipeline (scan + ppermute +
switch are all differentiable).
"""

from __future__ import annotations

from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from lynx_tpu.accelerator.aperture import Aperture
from lynx_tpu.accelerator.bpm import BPM
from lynx_tpu.accelerator.screen import Screen
from lynx_tpu.accelerator.segment import Segment
from lynx_tpu.particles import Beam, ParticleBeam

STAGE_AXIS = "stage"


def make_pipeline_mesh(num_stages: int) -> Mesh:
    """A 1-D ``("stage",)`` mesh over the first ``num_stages`` devices."""
    devices = np.asarray(jax.devices()[:num_stages])
    return Mesh(devices, (STAGE_AXIS,))


def split_into_stages(segment: Segment, num_stages: int) -> List[Segment]:
    """Split a segment into ``num_stages`` contiguous stages balanced by
    element count (flattening nested segments first).  Every stage is a
    valid :class:`Segment`; tracking them sequentially is identical to
    tracking the original."""
    elements = segment.flattened().elements
    if num_stages < 1 or num_stages > len(elements):
        raise ValueError(
            f"cannot split {len(elements)} elements into {num_stages} stages"
        )
    bounds = np.linspace(0, len(elements), num_stages + 1).astype(int)
    return [
        Segment(list(elements[a:b]), name=f"{segment.name}_stage_{i}")
        for i, (a, b) in enumerate(zip(bounds[:-1], bounds[1:]))
    ]


def _check_pipelineable(stages: Sequence[Segment]) -> bool:
    """Pipelined tracking is pure beam->beam: no mid-lattice absorption or
    per-element diagnostics collection.  Returns whether any stage contains
    an active aperture (survival must then be materialized up front so the
    beam pytree structure is step-invariant)."""
    any_aperture = False
    for stage in stages:
        for element in stage.flattened().elements:
            if isinstance(element, Screen) and element.is_active:
                raise ValueError(
                    "pipeline_track cannot cross an active Screen (it absorbs "
                    "the beam); deactivate it or pipeline up to the screen"
                )
            if isinstance(element, BPM) and element.is_active:
                raise ValueError(
                    "pipeline_track does not collect BPM diagnostics; "
                    "deactivate the BPM or use functional.track"
                )
            if isinstance(element, Aperture) and element.is_active:
                any_aperture = True
    return any_aperture


def _microbatch(beam: Beam, num_microbatches: int) -> Beam:
    """Reshape the leading batch dim ``B`` into ``(M, B // M)``."""

    def reshape(x):
        if x.ndim == 0:
            raise ValueError(
                "pipeline_track needs a batched beam (use beam.broadcast)"
            )
        if x.shape[0] % num_microbatches:
            raise ValueError(
                f"batch {x.shape[0]} not divisible by {num_microbatches} "
                "microbatches"
            )
        return x.reshape(num_microbatches, x.shape[0] // num_microbatches,
                         *x.shape[1:])

    return jax.tree_util.tree_map(reshape, beam)


def _tree_where(pred, a, b):
    return jax.tree_util.tree_map(
        lambda x, y: jnp.where(pred, x, y), a, b
    )


def pipeline_track(
    stages: Sequence[Segment],
    beam: Beam,
    mesh: Mesh,
    num_microbatches: int,
) -> Beam:
    """Track a batched beam through ``stages`` pipelined over ``mesh``'s
    ``"stage"`` axis with ``num_microbatches`` in flight.

    Equivalent to tracking the full batch through the stages sequentially
    (``tests/test_pipeline.py`` asserts equality with ``functional.track``),
    but each device only ever runs its own stage.  The beam must carry a
    leading batch dim divisible by ``num_microbatches``; the result is
    replicated on every device.
    """
    from lynx_tpu.functional import track

    num_stages = mesh.shape[STAGE_AXIS]
    if len(stages) != num_stages:
        raise ValueError(
            f"{len(stages)} stages vs mesh axis of size {num_stages}"
        )
    if _check_pipelineable(stages) and (
        isinstance(beam, ParticleBeam) and beam.survival is None
    ):
        # Materialize survival so every stage maps the SAME pytree structure.
        beam = ParticleBeam(
            beam.particles,
            beam.energy,
            particle_charges=beam.particle_charges,
            survival=jnp.ones_like(beam.particles[..., 0]),
        )

    microbatches = _microbatch(beam, num_microbatches)
    num_steps = num_stages - 1 + num_microbatches

    def stage_fn_of(stage):
        def fn(b):
            out, _ = track(stage, b)
            if out is None or out is Beam.empty:
                raise ValueError("stage absorbed or fully lost the beam")
            return out

        return fn

    def inner(stages_operand, mb):
        stage_fns = [stage_fn_of(stage) for stage in stages_operand]
        idx = jax.lax.axis_index(STAGE_AXIS)

        # Feed schedule: device 0 consumes microbatch t at step t (wrapped
        # duds for t >= M are never emitted).
        reps = -(-num_steps // num_microbatches)

        def wrap(x):
            return jnp.concatenate([x] * reps, axis=0)[:num_steps]

        xs = jax.tree_util.tree_map(wrap, mb)
        # Warm-up slots hold a COPY of microbatch 0, not zeros: a zero beam
        # (energy 0) drives the transfer-map guards to NaN jacobians, and
        # even discarded dud outputs would contaminate the backward pass
        # (0 * nan = nan).  Dud emissions are sliced away below either way.
        state0 = jax.tree_util.tree_map(lambda x: x[0], mb)

        def step(state, x_t):
            current = _tree_where(idx == 0, x_t, state)
            out = jax.lax.switch(idx, stage_fns, current)
            handed = jax.tree_util.tree_map(
                lambda o: jax.lax.ppermute(
                    o,
                    STAGE_AXIS,
                    [(i, i + 1) for i in range(num_stages - 1)],
                ),
                out,
            )
            return handed, out

        _, emitted = jax.lax.scan(step, state0, xs, length=num_steps)

        # The last stage's emissions at steps S-1 .. S-2+M are the results
        # for microbatches 0 .. M-1; psum-select them onto every device.
        valid = jax.tree_util.tree_map(
            lambda y: y[num_stages - 1 :], emitted
        )
        zeros = jax.tree_util.tree_map(jnp.zeros_like, valid)
        mine = _tree_where(idx == num_stages - 1, valid, zeros)
        return jax.tree_util.tree_map(
            lambda y: jax.lax.psum(y, STAGE_AXIS), mine
        )

    out_mb = jax.shard_map(
        inner,
        mesh=mesh,
        in_specs=(P(), P()),
        out_specs=P(),
        check_vma=False,
    )(tuple(stages), microbatches)

    def unbatch(x):
        return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])

    return jax.tree_util.tree_map(unbatch, out_mb)
