"""ARES (DESY) lattice models.

The flagship lattice of the reference's RL/tuning workloads (its tests and
notebooks revolve around the ARES Experimental Area).  The lattice ships as
LatticeJSON data (``resources/ares_lattice.json``), machine-converted from the
publicly available Ocelot-format ARES description via
``lynx_tpu.converters.ocelot``.
"""

from __future__ import annotations

from pathlib import Path

from lynx_tpu.accelerator import Segment

_RESOURCES = Path(__file__).parent / "resources"


def ares_lattice() -> Segment:
    """The full ARES lattice (195 elements, ~42.3 m)."""
    return Segment.from_lattice_json(str(_RESOURCES / "ares_lattice.json"))


def ares_ea_segment() -> Segment:
    """The ARES Experimental Area subcell (AREASOLA1 -> AREABSCR1).

    The transverse-tuning benchmark lattice: 3 quadrupoles (AREAMQZM1/2/3),
    2 correctors (AREAMCVM1, AREAMCHM1) and a diagnostic screen (AREABSCR1).
    """
    return ares_lattice().subcell("AREASOLA1", "AREABSCR1")
