"""Plans for the particle moment sweep: adapters from elements to map builders.

Each supported element type contributes a list of ``(B,)`` parameter vectors
and a pure builder ``f(params, energy) -> table`` that reconstructs its
transfer map as a sparse table (``ops/table.py``) from the same entry
builders as the dense path (``ops/rmatrix.py``).  ``particle_moment_plan``
composes them into the plan that ``ops/sweep.sweep_particle_moments`` walks.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import jax
import jax.numpy as jnp

from lynx_tpu.accelerator.aperture import Aperture
from lynx_tpu.accelerator.bpm import BPM
from lynx_tpu.accelerator.cavity import Cavity
from lynx_tpu.accelerator.correctors import HorizontalCorrector, VerticalCorrector
from lynx_tpu.accelerator.custom_transfer_map import CustomTransferMap
from lynx_tpu.accelerator.dipole import Dipole, RBend
from lynx_tpu.accelerator.drift import Drift
from lynx_tpu.accelerator.marker import Marker
from lynx_tpu.accelerator.quadrupole import Quadrupole
from lynx_tpu.accelerator.screen import Screen
from lynx_tpu.accelerator.solenoid import Solenoid
from lynx_tpu.accelerator.undulator import Undulator
from lynx_tpu.ops import table as tbl
from lynx_tpu.ops.rmatrix import (
    base_rmatrix_table,
    cavity_rmatrix_entries,
    drift_rmatrix_entries,
)

Array = jax.Array

#: A builder maps (params, energy) -> sparse table (see ``ops/table.py``).
Builder = Tuple[List[Array], Callable[[List[Array], Array], tbl.Table]]


def _build_drift(params, energy):
    return tbl.entries_to_table(drift_rmatrix_entries(params[0], energy))


def _build_quadrupole(params, energy):
    length, k1, tilt, mx, my = params
    T = base_rmatrix_table(length, k1, jnp.zeros_like(length), tilt, energy)
    entry = tbl.entries_to_table({(0, 6): -mx, (2, 6): -my})
    exit_ = tbl.entries_to_table({(0, 6): mx, (2, 6): my})
    return tbl.compose(exit_, tbl.compose(T, entry))


def _build_corrector(kick_row, params, energy):
    length, angle = params
    entries = drift_rmatrix_entries(length, energy)
    entries[(kick_row, 6)] = angle
    return tbl.entries_to_table(entries)


def _build_cavity(params, energy):
    length, voltage, phase, frequency = params
    entries, _, _ = cavity_rmatrix_entries(
        length, voltage, phase, frequency, energy
    )
    return tbl.entries_to_table(entries)


def _build_identity(params, energy):
    return tbl.identity_table()


def _build_undulator(params, energy):
    from lynx_tpu.ops.rmatrix import igamma2_from_energy

    (length,) = params
    igamma2 = igamma2_from_energy(energy, zero_value=0.0)
    return tbl.entries_to_table(
        {(0, 1): length, (2, 3): length, (4, 5): length * igamma2}
    )


def _build_solenoid(params, energy):
    import jax.numpy as jnp

    from lynx_tpu.constants import REST_ENERGY_EV

    length, k, mx, my = params
    gamma = energy / REST_ENERGY_EV
    c = jnp.cos(length * k)
    s = jnp.sin(length * k)
    k_safe = jnp.where(k == 0, 1.0, k)
    s_k = jnp.where(k == 0, length, s / k_safe)
    gamma_safe = jnp.where(gamma == 0, 1.0, gamma)
    beta2_gamma2 = gamma_safe**2 - 1.0
    r56 = jnp.where(
        gamma == 0, 0.0, -length / jnp.where(beta2_gamma2 == 0, 1.0, beta2_gamma2)
    )
    T = tbl.entries_to_table(
        {
            (0, 0): c**2, (0, 1): c * s_k, (0, 2): s * c, (0, 3): s * s_k,
            (1, 0): -k * s * c, (1, 1): c**2, (1, 2): -k * s**2, (1, 3): s * c,
            (2, 0): -s * c, (2, 1): -s * s_k, (2, 2): c**2, (2, 3): c * s_k,
            (3, 0): k * s**2, (3, 1): -s * c, (3, 2): -k * s * c, (3, 3): c**2,
            (4, 5): r56,
        }
    )
    entry = tbl.entries_to_table({(0, 6): -mx, (2, 6): -my})
    exit_ = tbl.entries_to_table({(0, 6): mx, (2, 6): my})
    return tbl.compose(exit_, tbl.compose(T, entry))


def _build_dipole(params, energy):
    import jax.numpy as jnp

    from lynx_tpu.ops.rmatrix import base_rmatrix_entries, rotation_entries

    length, angle, e1, e2, tilt, fint, fintx, gap = params
    length_safe = jnp.where(length == 0, 1.0, length)
    hx = jnp.where(length == 0, 0.0, angle / length_safe)
    body_entries, _, _, _ = base_rmatrix_entries(
        length=jnp.where(length == 0, 1.0, length),
        k1=jnp.zeros_like(length),
        hx=hx,
        tilt=jnp.zeros_like(length),
        energy=energy,
    )
    body = tbl.entries_to_table(body_entries)
    thin = tbl.entries_to_table({(0, 1): length, (2, 6): angle, (2, 3): length})
    R = tbl.where_table(length == 0, thin, body)

    def edge(e, fi):
        sec_e = 1.0 / jnp.cos(e)
        phi = fi * hx * gap * sec_e * (1 + jnp.sin(e) ** 2)
        return tbl.entries_to_table(
            {(1, 0): hx * jnp.tan(e), (3, 2): -hx * jnp.tan(e - phi)}
        )

    R = tbl.compose(edge(e2, fintx), tbl.compose(R, edge(e1, fint)))
    rot_fwd = tbl.entries_to_table(rotation_entries(tilt))
    rot_bwd = tbl.entries_to_table(rotation_entries(-tilt))
    return tbl.compose(rot_bwd, tbl.compose(R, rot_fwd))


def _build_custom(params, energy):
    return [[params[i * 7 + j] for j in range(7)] for i in range(7)]


def element_map_builder(element) -> Optional[Builder]:
    """Return (param vectors, table builder) for a supported element, or
    ``None`` if the element type has no table builder."""
    if type(element) is Drift:
        return [element.length], _build_drift
    if type(element) is Quadrupole:
        return (
            [
                element.length,
                element.k1,
                element.tilt,
                element.misalignment[..., 0],
                element.misalignment[..., 1],
            ],
            _build_quadrupole,
        )
    if isinstance(element, HorizontalCorrector):
        return [element.length, element.angle], lambda p, E: _build_corrector(1, p, E)
    if isinstance(element, VerticalCorrector):
        return [element.length, element.angle], lambda p, E: _build_corrector(3, p, E)
    if type(element) is Cavity:  # only reached when inactive (skippable)
        return (
            [element.length, element.voltage, element.phase, element.frequency],
            _build_cavity,
        )
    if isinstance(element, (Marker, BPM, Screen, Aperture)):
        return [], _build_identity
    if isinstance(element, Undulator):
        return [element.length], _build_undulator
    if isinstance(element, Solenoid):
        return (
            [
                element.length,
                element.k,
                element.misalignment[..., 0],
                element.misalignment[..., 1],
            ],
            _build_solenoid,
        )
    if type(element) is Dipole or type(element) is RBend:
        return (
            [
                element.length,
                element.angle,
                element.e1,
                element.e2,
                element.tilt,
                element.fringe_integral,
                element.fringe_integral_exit,
                element.gap,
            ],
            _build_dipole,
        )
    if isinstance(element, CustomTransferMap):
        tm = element._transfer_map
        params = [tm[..., i, j] for i in range(7) for j in range(7)]
        return params, _build_custom
    return None


_IDENTITY_LAYOUT = [
    [1.0 if i == j else 0.0 for j in range(7)] for i in range(7)
]


def particle_moment_plan(
    elements: list, energy: Array, vec: Callable[[Array], Array]
):
    """Build the plan for the settings-amortized particle moment sweep
    (``ops/sweep.sweep_particle_moments``): maximal runs of
    affine elements compose into ``("map", layout)`` entries whose dynamic
    cells are ``(B,)`` per-setting scalars, and ACTIVE apertures — the one
    per-particle, per-setting operation no moment algebra can absorb —
    become ``("aperture", x_idx, y_idx, shape)`` entries.

    Returns ``(entries, scalars)`` or ``None`` when the element list needs
    anything else per-particle (active screens/cavities): those runs route
    through the general tracking paths instead.
    """
    vec_energy = vec(jnp.asarray(energy))
    # Compose in the energy's dtype: element parameters default to f32
    # (reference parity), and the dense path promotes them inside each
    # map builder the same way — keeping f64 sweeps bit-consistent with
    # f64 dense tracking.
    dtype = vec_energy.dtype
    entries: List[tuple] = []
    scalars: List[Array] = []
    group: List[Builder] = []

    def flush_group() -> None:
        if not group:
            return
        total = None
        for params, fn in group:
            T = fn([vec(p).astype(dtype) for p in params], vec_energy)
            total = T if total is None else tbl.compose(T, total)
        group.clear()
        layout, cells = tbl.split_table(total)
        if not cells and layout == _IDENTITY_LAYOUT:
            return
        offset = len(scalars)
        scalars.extend(cells)
        entries.append(
            (
                "map",
                tuple(
                    tuple(
                        c if isinstance(c, float) else c + offset
                        for c in row
                    )
                    for row in layout
                ),
            )
        )

    for element in elements:
        if element.is_skippable:
            builder = element_map_builder(element)
            if builder is None:
                return None
            group.append(builder)
        elif isinstance(element, Aperture):
            flush_group()
            x_idx = len(scalars)
            scalars.append(vec(element.x_max).astype(dtype))
            y_idx = len(scalars)
            scalars.append(vec(element.y_max).astype(dtype))
            entries.append(("aperture", x_idx, y_idx, element.shape))
        elif isinstance(element, BPM):
            # Active BPMs read moments but leave the beam untouched.
            continue
        else:
            return None
    flush_group()
    return tuple(entries), tuple(scalars)

