"""Ocelot lattice converter.

Behavioral parity with reference ``lynx/converters/ocelot.py``, but
*duck-typed by class name* instead of ``isinstance`` against an installed
Ocelot — so both real Ocelot cells and shim-built lattice modules
(:mod:`lynx_tpu.converters.ocelot_shim`) convert on machines where
Ocelot cannot be installed.
"""

from __future__ import annotations

import jax.numpy as jnp

import lynx_tpu
from lynx_tpu.log import get_logger

logger = get_logger("converters.ocelot")


def _class_names(element) -> list[str]:
    return [klass.__name__ for klass in type(element).__mro__]


def ocelot2lynx(element, warnings: bool = True, dtype=jnp.float32):
    """Translate one Ocelot element to a lynx-tpu element.

    Unsupported elements become drifts; ``Monitor``s with "BSC" in their id
    become ARES-default screens, "BPM" ids become BPMs, other monitors become
    markers (reference ``converters/ocelot.py:7-185``).
    """
    names = _class_names(element)

    def arr(value) -> jnp.ndarray:
        return jnp.array([value], dtype=dtype)

    if "Quadrupole" in names:
        return lynx_tpu.Quadrupole(
            length=arr(element.l),
            k1=arr(element.k1),
            tilt=arr(getattr(element, "tilt", 0.0)),
            name=element.id,
            dtype=dtype,
        )
    if "Solenoid" in names:
        return lynx_tpu.Solenoid(
            length=arr(element.l), k=arr(element.k), name=element.id, dtype=dtype
        )
    if "Hcor" in names:
        return lynx_tpu.HorizontalCorrector(
            length=arr(element.l),
            angle=arr(element.angle),
            name=element.id,
            dtype=dtype,
        )
    if "Vcor" in names:
        return lynx_tpu.VerticalCorrector(
            length=arr(element.l),
            angle=arr(element.angle),
            name=element.id,
            dtype=dtype,
        )
    if "RBend" in names:
        # Ocelot RBend edge angles include the angle/2 geometry that our
        # RBend re-adds, so subtract it here (round-trip identity).
        return lynx_tpu.RBend(
            length=arr(element.l),
            angle=arr(element.angle),
            e1=arr(element.e1 - element.angle / 2),
            e2=arr(element.e2 - element.angle / 2),
            tilt=arr(element.tilt),
            fringe_integral=arr(element.fint),
            fringe_integral_exit=arr(element.fintx),
            gap=arr(element.gap),
            name=element.id,
            dtype=dtype,
        )
    if "Bend" in names or "SBend" in names:
        return lynx_tpu.Dipole(
            length=arr(element.l),
            angle=arr(element.angle),
            e1=arr(element.e1),
            e2=arr(element.e2),
            tilt=arr(element.tilt),
            fringe_integral=arr(element.fint),
            fringe_integral_exit=arr(element.fintx),
            gap=arr(element.gap),
            name=element.id,
            dtype=dtype,
        )
    if "Cavity" in names or "TDCavity" in names:
        return lynx_tpu.Cavity(
            length=arr(element.l),
            voltage=arr(element.v * 1e9),  # Ocelot stores GV
            frequency=arr(element.freq),
            phase=arr(element.phi),
            name=element.id,
            dtype=dtype,
        )
    if "Monitor" in names and "BSC" in (element.id or ""):
        # ARES-specific: BSC monitors are diagnostic screens.
        if warnings:
            logger.warning(
                "Diagnostic screen was converted with default screen"
                " properties."
            )
        return lynx_tpu.Screen(
            resolution=(2448, 2040),
            pixel_size=jnp.array([3.5488e-6, 2.5003e-6], dtype=dtype),
            name=element.id,
            dtype=dtype,
        )
    if "Monitor" in names and "BPM" in (element.id or ""):
        return lynx_tpu.BPM(name=element.id)
    if "Marker" in names or "Monitor" in names:
        return lynx_tpu.Marker(name=element.id)
    if "Undulator" in names:
        return lynx_tpu.Undulator(
            length=arr(element.l), name=element.id, dtype=dtype
        )
    if "Aperture" in names:
        shape_translation = {"rect": "rectangular", "elip": "elliptical"}
        return lynx_tpu.Aperture(
            x_max=arr(element.xmax),
            y_max=arr(element.ymax),
            shape=shape_translation[element.type],
            is_active=True,
            name=element.id,
            dtype=dtype,
        )
    if "Drift" in names:
        return lynx_tpu.Drift(length=arr(element.l), name=element.id, dtype=dtype)

    if warnings:
        logger.warning(
            "Unknown element %s of type %s, replacing with drift section.",
            element.id,
            type(element),
        )
    return lynx_tpu.Drift(
        length=arr(getattr(element, "l", 0.0)), name=element.id, dtype=dtype
    )


def subcell_of_ocelot(cell: list, start: str, end: str) -> list:
    """Extract a subcell ``[start, end]`` from an Ocelot cell."""
    subcell = []
    is_in_subcell = False
    for el in cell:
        if el.id == start:
            is_in_subcell = True
        if is_in_subcell:
            subcell.append(el)
        if el.id == end:
            break
    return subcell
