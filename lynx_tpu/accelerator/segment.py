"""Segment: composite lattice element with optimization passes.

Reference behavior contract: ``lynx/accelerator/segment.py``.

Tracking strategy: elements are partitioned at *trace time* into
maximal runs of skippable (purely linear) elements; each run's maps are
stacked and folded with balanced batched matmuls (``lynx_tpu.ops.folding``)
and applied to the beam as one matrix, with non-skippable elements (active
cavities / screens / BPMs / apertures) interleaved.  Because skippability is
static metadata, a jit-compiled track specializes to the lattice structure.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Optional, Union

import jax
import jax.numpy as jnp

from lynx_tpu.accelerator.custom_transfer_map import CustomTransferMap
from lynx_tpu.accelerator.drift import Drift
from lynx_tpu.accelerator.element import (
    Element,
    apply_table,
    apply_transfer_map,
    from_batch_last,
)
from lynx_tpu.accelerator.marker import Marker
from lynx_tpu.ops.folding import (
    fold_transfer_maps,
    fold_transfer_maps_batch_last,
)
from lynx_tpu.particles import Beam, ParticleBeam

Array = jax.Array

#: Flat batch size from which a run of maps is composed as a sparse table
#: of ``(batch,)`` cells (``ops/table.py``) instead of a dense matrix fold.
BATCH_LAST_THRESHOLD = 512


def _flat_batch_of(elements: list[Element], energy: Array) -> tuple:
    shapes = [energy.shape] + [
        jnp.shape(element.length) for element in elements
    ]
    batch_shape = jnp.broadcast_shapes(*shapes)
    flat = 1
    for dim in batch_shape:
        flat *= dim
    return batch_shape, flat


def stacked_transfer_map_batch_last(
    elements: list[Element], energy: Array
) -> Array:
    """Fold consecutive skippable elements' maps in ``(7, 7, ...)`` layout
    (built natively batch-last — no per-element transposes)."""
    maps = [element.transfer_map_batch_last(energy) for element in elements]
    batch_shape = jnp.broadcast_shapes(*(m.shape[2:] for m in maps))
    maps = [jnp.broadcast_to(m, (7, 7, *batch_shape)) for m in maps]
    return fold_transfer_maps_batch_last(maps)


def composed_table(elements: list[Element], energy: Array):
    """Compose the sparse tables of consecutive skippable elements
    (literal-zero short-circuiting; see ``ops/table.py``)."""
    from lynx_tpu.ops import table as tbl

    total = None
    for element in elements:
        T = element.transfer_map_table(energy)
        total = T if total is None else tbl.compose(T, total)
    return total


def stacked_transfer_map(elements: list[Element], energy: Array) -> Array:
    """Fold the maps of consecutive skippable elements at a fixed energy."""
    energy = jnp.asarray(energy)
    _, flat_batch = _flat_batch_of(elements, energy)
    if flat_batch >= BATCH_LAST_THRESHOLD:
        return from_batch_last(stacked_transfer_map_batch_last(elements, energy))
    maps = [element.transfer_map(energy) for element in elements]
    if len(maps) == 1:
        return maps[0]
    batch_shape = jnp.broadcast_shapes(*(m.shape[:-2] for m in maps))
    maps = [jnp.broadcast_to(m, (*batch_shape, 7, 7)) for m in maps]
    return fold_transfer_maps(jnp.stack(maps, axis=0))


class Segment(Element):
    """Segment of a particle accelerator consisting of several elements.

    :param elements: List of elements that describe the accelerator (section).
    :param name: Unique identifier of the segment.
    """

    _data_fields = ("elements",)
    _exclude_fields = ("length",)

    def __init__(self, elements: list[Element], name: Optional[str] = None) -> None:
        # NOTE: deliberately not calling Element.__init__ — ``length`` is a
        # computed property on segments.
        from lynx_tpu.accelerator.element import generate_unique_name

        self.name = name if name is not None else generate_unique_name()
        self.elements = list(elements)

    def __getattr__(self, name: str):
        # Elements are accessible as attributes by their name; duplicates
        # come back as a list (reference ``segment.py:45-54``).
        if name.startswith("_") or name == "elements":
            raise AttributeError(name)
        elements = self.__dict__.get("elements", None)
        if elements is None:
            raise AttributeError(name)
        matches = [el for el in elements if getattr(el, "name", None) == name]
        if not matches:
            raise AttributeError(
                f"{type(self).__name__!s} object has no attribute {name!r}"
            )
        return matches[0] if len(matches) == 1 else matches

    # -- structural passes -------------------------------------------------
    def subcell(self, start: str, end: str) -> "Segment":
        """Extract a subcell ``[start, end]`` from this segment."""
        subcell = []
        is_in_subcell = False
        for element in self.elements:
            if element.name == start:
                is_in_subcell = True
            if is_in_subcell:
                subcell.append(element)
            if element.name == end:
                break
        return self.__class__(subcell)

    def flattened(self) -> "Segment":
        """Resolve all nested segments into one flat element list."""
        flattened_elements = []
        for element in self.elements:
            if isinstance(element, Segment):
                flattened_elements += element.flattened().elements
            else:
                flattened_elements.append(element)
        return Segment(elements=flattened_elements, name=self.name)

    def transfer_maps_merged(
        self, incoming_beam: Beam, except_for: Optional[list[str]] = None
    ) -> "Segment":
        """Merge runs of skippable elements into ``CustomTransferMap``s.

        Requires a beam to fix each element's entrance energy
        (reference ``segment.py:84-132``).

        :param except_for: Names of elements to keep unmerged (e.g. the
            magnets that will be re-tuned between trackings).
        """
        if except_for is None:
            except_for = []

        merged_elements = []
        skippable_run: list[Element] = []
        tracked_beam = incoming_beam
        for element in self.elements:
            if element.is_skippable and element.name not in except_for:
                skippable_run.append(element)
                continue
            if len(skippable_run) == 1:
                merged_elements.append(skippable_run[0])
                tracked_beam = skippable_run[0].track(tracked_beam)
            elif len(skippable_run) > 1:
                merged_elements.append(
                    CustomTransferMap.from_merging_elements(
                        skippable_run, incoming_beam=tracked_beam
                    )
                )
                tracked_beam = merged_elements[-1].track(tracked_beam)
            skippable_run = []

            merged_elements.append(element)
            tracked_beam = element.track(tracked_beam)

        if len(skippable_run) == 1:
            merged_elements.append(skippable_run[0])
        elif len(skippable_run) > 1:
            merged_elements.append(
                CustomTransferMap.from_merging_elements(
                    skippable_run, incoming_beam=tracked_beam
                )
            )
        return Segment(elements=merged_elements, name=self.name)

    def without_inactive_markers(
        self, except_for: Optional[list[str]] = None
    ) -> "Segment":
        """Remove markers (reference ``segment.py:134-159``)."""
        if except_for is None:
            except_for = []
        return Segment(
            elements=[
                element
                for element in self.elements
                if not isinstance(element, Marker) or element.name in except_for
            ],
            name=self.name,
        )

    def without_inactive_zero_length_elements(
        self, except_for: Optional[list[str]] = None
    ) -> "Segment":
        """Remove inactive zero-length elements (reference ``segment.py:161-187``)."""
        if except_for is None:
            except_for = []
        return Segment(
            elements=[
                element
                for element in self.elements
                if bool(jnp.any(element.length > 0.0))
                or (hasattr(element, "is_active") and element.is_active)
                or element.name in except_for
            ],
            name=self.name,
        )

    def inactive_elements_as_drifts(
        self, except_for: Optional[list[str]] = None
    ) -> "Segment":
        """Replace inactive elements that have length by plain drifts
        (reference ``segment.py:189-218``)."""
        if except_for is None:
            except_for = []
        return Segment(
            elements=[
                (
                    element
                    if (hasattr(element, "is_active") and element.is_active)
                    or bool(jnp.all(element.length == 0.0))
                    or element.name in except_for
                    else Drift(element.length, name=element.name)
                )
                for element in self.elements
            ],
            name=self.name,
        )

    # -- I/O ----------------------------------------------------------------
    @classmethod
    def from_lattice_json(cls, filepath: str) -> "Segment":
        """Load a lattice from a (Cheetah-compatible) LatticeJSON file."""
        from lynx_tpu.converters.latticejson import load_cheetah_model

        return load_cheetah_model(filepath)

    def to_lattice_json(
        self,
        filepath: str,
        title: Optional[str] = None,
        info: str = "This is a placeholder lattice description",
    ) -> None:
        """Save the lattice to a (Cheetah-compatible) LatticeJSON file."""
        from lynx_tpu.converters.latticejson import save_cheetah_model

        save_cheetah_model(self, filepath, title, info)

    @classmethod
    def from_ocelot(
        cls,
        cell,
        name: Optional[str] = None,
        warnings: bool = True,
        dtype=jnp.float32,
        **kwargs,
    ) -> "Segment":
        """Translate an Ocelot cell (duck-typed) to a lynx-tpu Segment."""
        from lynx_tpu.converters.ocelot import ocelot2lynx

        converted = [
            ocelot2lynx(element, warnings=warnings, dtype=dtype) for element in cell
        ]
        return cls(converted, name=name, **kwargs)

    @classmethod
    def from_bmad(
        cls,
        bmad_lattice_file_path: str,
        environment_variables: Optional[dict] = None,
    ) -> "Segment":
        """Read a Segment from a Bmad lattice file."""
        from lynx_tpu.converters.bmad import convert_bmad_lattice

        return convert_bmad_lattice(
            Path(bmad_lattice_file_path), environment_variables
        )

    @classmethod
    def from_nx_tables(cls, filepath: Union[Path, str]) -> "Element":
        """Read an NX Tables CSV file (ARES/DESY-specific) into a Segment."""
        from lynx_tpu.converters.nxtables import read_nx_tables

        return read_nx_tables(Path(filepath))

    # -- physics -----------------------------------------------------------
    @property
    def is_skippable(self) -> bool:
        return all(element.is_skippable for element in self.elements)

    @property
    def length(self) -> Array:
        lengths = [element.length for element in self.elements]
        batch_shape = jnp.broadcast_shapes(*(l.shape for l in lengths))
        return sum(
            (jnp.broadcast_to(l, batch_shape) for l in lengths),
            start=jnp.zeros(batch_shape),
        )

    def transfer_map(self, energy: Array) -> Optional[Array]:
        if self.is_skippable:
            return stacked_transfer_map(self.elements, energy)
        return None

    def track(self, incoming: Beam) -> Beam:
        """Track a beam through the segment.

        Consecutive skippable elements are folded into one matrix; the
        non-skippable elements (which may have side outputs or nonlinear
        physics) are tracked individually (reference ``segment.py:340-356``).
        """
        if incoming is Beam.empty:
            return incoming
        if self.is_skippable:
            # Route through the flush so the table fast path applies to
            # fully-linear segments too.
            return self._flush_run(self.flattened().elements, incoming)

        beam = incoming
        run: list[Element] = []
        for element in self.flattened().elements:
            if element.is_skippable:
                run.append(element)
                continue
            beam = self._flush_run(run, beam)
            run = []
            beam = element.track(beam)
        beam = self._flush_run(run, beam)
        return beam

    @staticmethod
    def _flush_run(run: list[Element], beam: Beam) -> Beam:
        if not run or beam is Beam.empty:
            return beam
        energy = jnp.asarray(beam.energy)
        _, flat_batch = _flat_batch_of(run, energy)
        if flat_batch >= BATCH_LAST_THRESHOLD:
            return apply_table(composed_table(run, energy), beam)
        return apply_transfer_map(stacked_transfer_map(run, energy), beam)

    def broadcast(self, shape: tuple) -> Element:
        return self.__class__(
            elements=[element.broadcast(shape) for element in self.elements],
            name=self.name,
        )

    def split(self, resolution: float) -> list[Element]:
        return [
            split_element
            for element in self.elements
            for split_element in element.split(resolution)
        ]

    # -- plotting ----------------------------------------------------------
    def plot(self, ax, s: float) -> None:
        element_lengths = [float(el.length.ravel()[0]) for el in self.elements]
        element_ss = [s]
        for length in element_lengths:
            element_ss.append(element_ss[-1] + length)

        ax.plot([0, element_ss[-1]], [0, 0], "--", color="black")
        for element, element_s in zip(self.elements, element_ss[:-1]):
            element.plot(ax, element_s)
        ax.set_ylim(-1, 1)
        ax.set_xlabel("s (m)")
        ax.set_yticks([])

    def plot_reference_particle_traces(
        self,
        axx,
        axy,
        beam: Optional[Beam] = None,
        num_particles: int = 10,
        resolution: float = 0.01,
    ) -> None:
        """Plot reference-particle traces along the segment
        (reference ``segment.py:387-459``)."""
        splits = self.split(resolution)
        split_lengths = [float(split.length.ravel()[0]) for split in splits]
        ss = [0]
        for length in split_lengths:
            ss.append(ss[-1] + length)

        if beam is None:
            initial = ParticleBeam.make_linspaced(num_particles=num_particles)
        else:
            initial = ParticleBeam.make_linspaced(
                num_particles=num_particles, **beam.parameters
            )
        references = [initial]
        for split in splits:
            references.append(split.track(references[-1]))

        for particle_index in range(num_particles):
            xs = [
                float(ref.xs.reshape(-1, num_particles)[0, particle_index])
                for ref in references
                if ref is not Beam.empty
            ]
            axx.plot(ss[: len(xs)], xs)
        axx.set_xlabel("s (m)")
        axx.set_ylabel("x (m)")
        axx.grid()

        for particle_index in range(num_particles):
            ys = [
                float(ref.ys.reshape(-1, num_particles)[0, particle_index])
                for ref in references
                if ref is not Beam.empty
            ]
            axy.plot(ss[: len(ys)], ys)
        axy.set_xlabel("s (m)")
        axy.set_ylabel("y (m)")
        axy.grid()

    def plot_overview(
        self,
        fig=None,
        beam: Optional[Beam] = None,
        n: int = 10,
        resolution: float = 0.01,
    ) -> None:
        """Lattice layout + reference particle traces
        (reference ``segment.py:461-488``)."""
        import matplotlib.pyplot as plt

        if fig is None:
            fig = plt.figure()
        gs = fig.add_gridspec(3, hspace=0, height_ratios=[2, 2, 1])
        axs = gs.subplots(sharex=True)
        axs[0].set_title("Reference Particle Traces")
        self.plot_reference_particle_traces(axs[0], axs[1], beam, n, resolution)
        self.plot(axs[2], 0)
        plt.tight_layout()

    def plot_twiss(self, beam: Beam, ax: Optional[Any] = None) -> None:
        """Twiss parameters along the segment (reference ``segment.py:490-518``)."""
        import matplotlib.pyplot as plt

        longitudinal_beams = [beam]
        s_positions = [0.0]
        for element in self.elements:
            if bool(jnp.all(element.length == 0)):
                continue
            outgoing = element.track(longitudinal_beams[-1])
            longitudinal_beams.append(outgoing)
            s_positions.append(
                s_positions[-1] + float(element.length.ravel()[0])
            )

        beta_x = [float(b.beta_x.ravel()[0]) for b in longitudinal_beams]
        beta_y = [float(b.beta_y.ravel()[0]) for b in longitudinal_beams]

        if ax is None:
            fig = plt.figure()
            ax = fig.add_subplot(111)
        ax.set_title("Twiss Parameters")
        ax.set_xlabel("s (m)")
        ax.set_ylabel(r"$\beta$ (m)")
        ax.plot(s_positions, beta_x, label=r"$\beta_x$", c="tab:red")
        ax.plot(s_positions, beta_y, label=r"$\beta_y$", c="tab:green")
        ax.legend()
        plt.tight_layout()

    def plot_twiss_over_lattice(self, beam: Beam, figsize=(8, 4)) -> None:
        """Twiss plot over a lattice layout plot (reference ``segment.py:524-533``)."""
        import matplotlib.pyplot as plt

        fig = plt.figure(figsize=figsize)
        gs = fig.add_gridspec(2, hspace=0, height_ratios=[3, 1])
        axs = gs.subplots(sharex=True)
        self.plot_twiss(beam, ax=axs[0])
        self.plot(axs[1], 0)
        plt.tight_layout()

    @property
    def defining_features(self) -> list[str]:
        return super().defining_features + ["elements"]

    def __repr__(self) -> str:
        return (
            f"{self.__class__.__name__}(elements={self.elements!r}, "
            f"name={self.name!r})"
        )
