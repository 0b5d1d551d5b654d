"""Pure-functional tracking core.

``track(segment, beam)`` is the jit/grad/vmap-safe entry point of lynx-tpu:
the lattice is a pytree argument, and all diagnostic side-channels of the
reference's stateful API (BPM readings, screen images, aperture survival —
reference ``lynx/accelerator/{bpm,screen,aperture}.py``) become explicit
outputs in a ``diagnostics`` dict.  This is the idiomatic JAX replacement for
mutating ``.reading`` attributes during tracking, and what benchmarks, RL
environments and the multi-chip path build on.

The element sequence and each element's skippability are static metadata, so
a jit of ``track`` specializes to the lattice structure: maximal runs of
linear elements fold into single matrices, and an active screen statically
terminates the graph (the beam is absorbed).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import jax

from lynx_tpu.accelerator.aperture import Aperture, aperture_survival_mask
from lynx_tpu.accelerator.bpm import BPM, bpm_reading
from lynx_tpu.accelerator.cavity import Cavity
from lynx_tpu.accelerator.element import Element
from lynx_tpu.accelerator.marker import Marker
from lynx_tpu.accelerator.screen import (
    Screen,
    screen_reading_parameter,
    screen_reading_particle,
)
from lynx_tpu.accelerator.segment import Segment
from lynx_tpu.particles import Beam, ParameterBeam, ParticleBeam

Array = jax.Array
Diagnostics = Dict[str, Any]


def track(
    segment: Segment, incoming: Beam
) -> Tuple[Optional[Beam], Diagnostics]:
    """Track ``incoming`` through ``segment``; return (outgoing, diagnostics).

    * ``outgoing`` is the beam leaving the segment, or ``None`` if it was
      absorbed (active screen) or fully lost.
    * ``diagnostics`` maps ``"<element name>"`` to the element's reading:
      BPM -> ``(2, ...)`` position reading, Screen -> ``(..., H, W)`` image,
      Aperture -> ``(..., N)`` survival mask after the aperture.

    Pure: no element state is touched; safe under jit/grad/vmap/shard_map.
    """
    diagnostics: Diagnostics = {}
    beam = incoming
    run: list[Element] = []
    flush = Segment._flush_run

    for element in segment.flattened().elements:
        if element.is_skippable:
            run.append(element)
            continue

        beam = flush(run, beam)
        run = []

        if isinstance(element, Cavity):
            beam = element._track_beam(beam)
        elif isinstance(element, BPM):
            diagnostics[element.name] = bpm_reading(beam)
        elif isinstance(element, Screen):
            read_beam = element.misaligned_beam(beam)
            if isinstance(read_beam, ParticleBeam):
                diagnostics[element.name] = screen_reading_particle(
                    read_beam,
                    element.resolution,
                    element.pixel_size,
                    element.binning,
                )
            elif isinstance(read_beam, ParameterBeam):
                diagnostics[element.name] = screen_reading_parameter(
                    read_beam,
                    element.resolution,
                    element.pixel_size,
                    element.binning,
                )
            # The screen absorbs the beam; everything downstream is
            # statically dead (reference ``screen.py:139``).
            return None, diagnostics
        elif isinstance(element, Aperture):
            if isinstance(beam, ParticleBeam):
                x_max = element.x_max[..., None] if element.x_max.ndim else element.x_max
                y_max = element.y_max[..., None] if element.y_max.ndim else element.y_max
                mask = aperture_survival_mask(
                    beam.xs, beam.ys, x_max, y_max, element.shape
                ).astype(beam.particles.dtype)
                survival = mask if beam.survival is None else beam.survival * mask
                beam = ParticleBeam(
                    beam.particles,
                    beam.energy,
                    particle_charges=beam.particle_charges * mask,
                    survival=survival,
                )
                diagnostics[element.name] = survival
        elif isinstance(element, Marker):
            pass
        elif isinstance(element, Segment):
            beam, sub_diagnostics = track(element, beam)
            diagnostics.update(sub_diagnostics)
            if beam is None:
                return None, diagnostics
        else:
            beam = element.track(beam)

    beam = flush(run, beam)
    return beam, diagnostics


def moment_sufficient(segment: Segment, incoming: Beam) -> bool:
    """True when tracking ``incoming`` through ``segment`` is *moment
    sufficient*: every observable the track can produce depends on the beam
    only through its first/second sample moments, so a
    :class:`~lynx_tpu.particles.ParticleBeam` may be replaced by
    ``incoming.as_parameter_beam()`` with *exactly* the same downstream
    ``mu_*``/``sigma_*`` statistics (linear maps commute with sample
    moments: ``mu' = R mu``, ``Sigma' = R Sigma R^T``).

    The decision is static metadata (skippability), so it can gate a jit
    route: a segment is moment-sufficient iff every flattened element is
    skippable — i.e. purely affine, with no per-particle side effects
    (aperture culling, particle-histogram screens, active cavities'
    nonlinear phase update all make it False).
    """
    if not isinstance(incoming, ParticleBeam):
        return False
    return all(
        element.is_skippable for element in segment.flattened().elements
    )


def track_jit(segment: Segment, incoming: Beam):
    """Jit-compiled :func:`track` (the segment is a pytree argument, so
    re-tuning magnet strengths does NOT retrigger compilation; only
    structural changes do)."""
    return _track_jitted(segment, incoming)


@jax.jit
def _track_jitted(segment: Segment, incoming: Beam):
    return track(segment, incoming)
