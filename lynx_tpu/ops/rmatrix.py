"""Linear-optics transfer-matrix kernels.

Every lattice element maps the 7-dimensional trace-space state
``(x, x', y, y', s, p, 1)`` linearly: ``state' = R @ state`` with ``R`` a
``(..., 7, 7)`` matrix.  The constant 7th component turns affine kicks
(correctors, misalignments) into pure matmuls.

These kernels are *branch-free*: where the reference uses in-place masked
assignment (illegal in JAX, e.g. reference ``lynx/track_methods.py:60-77``)
we use ``jnp.where`` with guarded operands so that the functions are
jit/vmap/grad-safe and numerically identical in the non-degenerate regime.

Behavioral parity sources (formulas, not code):
 * ``base_rmatrix``      — reference ``lynx/track_methods.py:37-105``
 * ``rotation_matrix``   — reference ``lynx/track_methods.py:14-34``
 * ``misalignment_matrix`` — reference ``lynx/track_methods.py:108-122``
 * ``drift_rmatrix``     — reference ``lynx/accelerator/drift.py:44-62``
 * ``cavity_rmatrix``    — reference ``lynx/accelerator/cavity.py:248-325``
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp

from lynx_tpu.constants import ELECTRON_MASS_EV, REST_ENERGY_EV, SPEED_OF_LIGHT

Array = jax.Array


def build_rmatrix(
    entries: Dict[Tuple[int, int], Array],
    batch_shape: Tuple[int, ...],
    dtype: jnp.dtype,
    batch_last: bool = False,
) -> Array:
    """Assemble a batched 7x7 matrix: identity plus the given entries.

    ``batch_last=True`` produces ``(7, 7, *batch_shape)`` — the batch-last
    layout used by the large-batch fast path (entry writes then touch
    contiguous memory instead of a stride-49 scatter).
    """
    # Stack-based assembly in BOTH layouts (no scatter): a per-entry
    # ``.at[..., i, j].set`` chain lowers to one dynamic-update-slice op
    # per matrix cell — ~50 of them across an EA map build.  Two nested
    # stacks are a handful of fusable concats instead.
    col_axis, row_axis = (0, 0) if batch_last else (-1, -2)
    zero = jnp.zeros(batch_shape, dtype=dtype)
    one = jnp.ones(batch_shape, dtype=dtype)
    rows = []
    for i in range(7):
        row = []
        for j in range(7):
            if (i, j) in entries:
                row.append(
                    jnp.broadcast_to(
                        jnp.asarray(entries[(i, j)], dtype=dtype), batch_shape
                    )
                )
            else:
                row.append(one if i == j else zero)
        rows.append(jnp.stack(row, axis=col_axis))
    return jnp.stack(rows, axis=row_axis)


def _safe_div(num: Array, den: Array, fallback: Array | float = 0.0) -> Array:
    """num / den, with entries where den == 0 replaced by ``fallback``."""
    den_safe = jnp.where(den == 0, 1.0, den)
    return jnp.where(den == 0, fallback, num / den_safe)


def _flat_batch(*shapes) -> int:
    batch_shape = jnp.broadcast_shapes(*shapes)
    flat = 1
    for dim in batch_shape:
        flat *= dim
    return flat


def compose_batch_last(second: Array, first: Array) -> Array:
    """``second @ first`` for ``(7, 7, ...)`` maps via explicitly unrolled
    multiply-adds — pure elementwise work that XLA fuses, instead of a
    dot_general with a trailing batch dim."""
    rows = []
    for i in range(7):
        row = []
        for k in range(7):
            acc = second[i, 0] * first[0, k]
            for j in range(1, 7):
                acc = acc + second[i, j] * first[j, k]
            row.append(acc)
        rows.append(jnp.stack(row, axis=0))
    return jnp.stack(rows, axis=0)


def matvec_batch_last(matrix: Array, vector: Array) -> Array:
    """``(7, 7, ...) @ (7, ...) -> (7, ...)`` via unrolled multiply-adds."""
    out = []
    for i in range(7):
        acc = matrix[i, 0] * vector[0]
        for j in range(1, 7):
            acc = acc + matrix[i, j] * vector[j]
        out.append(acc)
    return jnp.stack(out, axis=0)


def cov_sandwich_batch_last(matrix: Array, cov: Array) -> Array:
    """``R C R^T`` for batch-last ``(7, 7, ...)`` operands, unrolled."""
    rc = compose_batch_last(matrix, cov)
    rows = []
    for i in range(7):
        row = []
        for l in range(7):  # noqa: E741
            acc = rc[i, 0] * matrix[l, 0]
            for k in range(1, 7):
                acc = acc + rc[i, k] * matrix[l, k]
            row.append(acc)
        rows.append(jnp.stack(row, axis=0))
    return jnp.stack(rows, axis=0)


def sandwich(
    left: Array, mid: Array, right: Array, batch_last: bool = False
) -> Array:
    """``left @ mid @ right`` for 7x7 maps, layout-aware.

    With ``batch_last=True`` all operands are already ``(7, 7, ...)`` and the
    product is computed (and returned) in that layout directly.  Otherwise
    operands are ``(..., 7, 7)``; large batches are routed through the
    batch-last layout internally (elementwise multiply-adds instead of
    many tiny batched matmuls — see ``folding.py``).
    """
    precision = jax.lax.Precision.HIGHEST
    if batch_last:
        return compose_batch_last(left, compose_batch_last(mid, right))
    if _flat_batch(left.shape[:-2], mid.shape[:-2], right.shape[:-2]) >= 512:
        batch_shape = jnp.broadcast_shapes(
            left.shape[:-2], mid.shape[:-2], right.shape[:-2]
        )

        def bl(m):
            return jnp.moveaxis(
                jnp.broadcast_to(m, (*batch_shape, 7, 7)), (-2, -1), (0, 1)
            )

        out = jnp.einsum(
            "ij...,jk...,kl...->il...",
            bl(left),
            bl(mid),
            bl(right),
            precision=precision,
        )
        return jnp.moveaxis(out, (0, 1), (-2, -1))
    return jnp.matmul(
        left, jnp.matmul(mid, right, precision=precision), precision=precision
    )


def igamma2_from_energy(energy: Array, zero_value: float = 0.0) -> Array:
    """1/gamma^2 with gamma = E / (m_e c^2 / e); ``zero_value`` where E == 0.

    The reference uses ``zero_value=0`` in drift-like elements
    (``drift.py:53-54``) and ``zero_value=1`` inside ``base_rmatrix``
    (``track_methods.py:61-62``); both conventions are supported.
    """
    gamma = energy / REST_ENERGY_EV
    gamma_safe = jnp.where(gamma == 0, 1.0, gamma)
    return jnp.where(gamma == 0, zero_value, 1.0 / gamma_safe**2)


def _cos_sinc(k2: Array, length: Array) -> Tuple[Array, Array]:
    """Return (cos(k L), sin(k L)/k) for k = sqrt(k2), valid for k2 of any sign.

    For k2 < 0 this is (cosh(|k| L), sinh(|k| L)/|k|) — the real part of the
    complex-sqrt formulation the reference uses (``track_methods.py:72-79``).
    """
    abs_k = jnp.sqrt(jnp.abs(k2))
    arg = abs_k * length
    focusing = k2 >= 0

    # Hyperbolic branch without cosh/sinh/expm1: exp-based identities for large args, Taylor series where the exp form
    # would cancel catastrophically (|arg| < 0.1; series error < 3e-13 rel).
    exp_pos = jnp.exp(arg)
    exp_neg = jnp.exp(-arg)
    small = arg < 0.1
    x2 = arg * arg
    cosh_value = jnp.where(
        small,
        1.0 + x2 * (0.5 + x2 * (1.0 / 24.0 + x2 / 720.0)),
        0.5 * (exp_pos + exp_neg),
    )
    # sinh(arg)/k = L * (1 + x^2/6 + x^4/120 + x^6/5040) for small args.
    sinh_over_k = jnp.where(
        small,
        length * (1.0 + x2 * (1.0 / 6.0 + x2 * (1.0 / 120.0 + x2 / 5040.0))),
        _safe_div(0.5 * (exp_pos - exp_neg), abs_k, fallback=length),
    )

    c = jnp.where(focusing, jnp.cos(arg), cosh_value)
    s_over_k = jnp.where(
        focusing,
        _safe_div(jnp.sin(arg), abs_k, fallback=length),
        sinh_over_k,
    )
    return c, s_over_k


def rotation_matrix(angle: Array, batch_last: bool = False) -> Array:
    """x-y plane rotation of the transfer map (reference ``track_methods.py:14-34``)."""
    angle = jnp.asarray(angle)
    cs = jnp.cos(angle)
    sn = jnp.sin(angle)
    return build_rmatrix(
        {
            (0, 0): cs,
            (0, 2): sn,
            (1, 1): cs,
            (1, 3): sn,
            (2, 0): -sn,
            (2, 2): cs,
            (3, 1): -sn,
            (3, 3): cs,
        },
        batch_shape=angle.shape,
        dtype=angle.dtype,
        batch_last=batch_last,
    )


def base_rmatrix(
    length: Array,
    k1: Array,
    hx: Array,
    tilt: Optional[Array] = None,
    energy: Optional[Array] = None,
    batch_last: bool = False,
) -> Array:
    """Universal linear R-matrix for quadrupoles and bends.

    Handles quad strength ``k1``, curvature ``hx``, tilt rotation and the
    energy-dependent longitudinal ``r56`` term.  Reference behavior:
    ``lynx/track_methods.py:37-105`` (itself Ocelot's ``uni_matrix``).
    """
    entries, batch_shape, dtype, tilt = base_rmatrix_entries(
        length, k1, hx, tilt, energy
    )
    R = build_rmatrix(
        entries, batch_shape=batch_shape, dtype=dtype, batch_last=batch_last
    )

    # Rotate for skew / vertical magnets: R <- rot(-tilt) @ R @ rot(tilt).
    # Applied unconditionally (exact for tilt == 0) to stay branch-free.
    return sandwich(
        rotation_matrix(-tilt, batch_last=batch_last),
        R,
        rotation_matrix(tilt, batch_last=batch_last),
        batch_last=batch_last,
    )


def base_rmatrix_entries(
    length: Array,
    k1: Array,
    hx: Array,
    tilt: Optional[Array] = None,
    energy: Optional[Array] = None,
):
    """Entry dict of the universal R-matrix, *before* the tilt rotation.

    Returns ``(entries, batch_shape, dtype, tilt)``.
    """
    length = jnp.asarray(length)
    dtype = length.dtype
    k1 = jnp.asarray(k1, dtype=dtype)
    hx = jnp.asarray(hx, dtype=dtype)
    tilt = jnp.zeros_like(length) if tilt is None else jnp.asarray(tilt, dtype=dtype)
    energy = (
        jnp.zeros_like(length) if energy is None else jnp.asarray(energy, dtype=dtype)
    )

    batch_shape = jnp.broadcast_shapes(
        length.shape, k1.shape, hx.shape, tilt.shape, energy.shape
    )
    length, k1, hx, tilt, energy = (
        jnp.broadcast_to(a, batch_shape) for a in (length, k1, hx, tilt, energy)
    )

    # NOTE: the reference sets igamma2 = 1 (not 0) for E == 0 here.
    igamma2 = igamma2_from_energy(energy, zero_value=1.0)
    beta = jnp.sqrt(1.0 - igamma2)

    # Avoid k1 == 0 degeneracy exactly like the reference (k1 -> 1e-12), but
    # as an ADDITIVE perturbation so d/dk1 still flows at k1 == 0 (a `where`
    # replacement would zero the gradient there).
    k1 = k1 + jnp.where(k1 == 0, 1e-12, 0.0)
    kx2 = k1 + hx**2
    ky2 = -k1

    cx, sx = _cos_sinc(kx2, length)
    cy, sy = _cos_sinc(ky2, length)

    dx = hx / kx2 * (1.0 - cx)
    beta_safe = jnp.where(beta == 0, 1.0, beta)
    inv_beta = jnp.where(beta == 0, jnp.inf, 1.0 / beta_safe)
    r56 = hx**2 * (length - sx) / kx2 * inv_beta**2 - length * inv_beta**2 * igamma2

    entries = {
        (0, 0): cx,
        (0, 1): sx,
        (0, 5): dx * inv_beta,
        (1, 0): -kx2 * sx,
        (1, 1): cx,
        (1, 5): sx * hx * inv_beta,
        (2, 2): cy,
        (2, 3): sy,
        (3, 2): -ky2 * sy,
        (3, 3): cy,
        (4, 0): sx * hx * inv_beta,
        (4, 1): dx * inv_beta,
        (4, 5): r56,
    }
    return entries, batch_shape, dtype, tilt


def rotation_entries(angle: Array) -> dict:
    cs = jnp.cos(angle)
    sn = jnp.sin(angle)
    return {
        (0, 0): cs,
        (0, 2): sn,
        (1, 1): cs,
        (1, 3): sn,
        (2, 0): -sn,
        (2, 2): cs,
        (3, 1): -sn,
        (3, 3): cs,
    }


def base_rmatrix_table(
    length: Array,
    k1: Array,
    hx: Array,
    tilt: Optional[Array] = None,
    energy: Optional[Array] = None,
):
    """Sparse-table form of :func:`base_rmatrix` (see ``ops/table.py``)."""
    from lynx_tpu.ops import table as tbl

    entries, _, _, tilt = base_rmatrix_entries(length, k1, hx, tilt, energy)
    T = tbl.entries_to_table(entries)
    rot_fwd = tbl.entries_to_table(rotation_entries(tilt))
    rot_bwd = tbl.entries_to_table(rotation_entries(-tilt))
    return tbl.compose(rot_bwd, tbl.compose(T, rot_fwd))


def misalignment_matrix(
    misalignment: Array, batch_last: bool = False
) -> Tuple[Array, Array]:
    """(entry, exit) affine shift matrices for a transversely misaligned element.

    Reference ``lynx/track_methods.py:108-122``.
    """
    misalignment = jnp.asarray(misalignment)
    batch_shape = misalignment.shape[:-1]
    dtype = misalignment.dtype
    mx = misalignment[..., 0]
    my = misalignment[..., 1]
    R_entry = build_rmatrix(
        {(0, 6): -mx, (2, 6): -my}, batch_shape, dtype, batch_last=batch_last
    )
    R_exit = build_rmatrix(
        {(0, 6): mx, (2, 6): my}, batch_shape, dtype, batch_last=batch_last
    )
    return R_entry, R_exit


def drift_rmatrix(length: Array, energy: Array, batch_last: bool = False) -> Array:
    """Drift transfer map with r56 = -L / (beta^2 gamma^2).

    Reference ``lynx/accelerator/drift.py:44-62``.
    """
    length = jnp.asarray(length)
    dtype = length.dtype
    energy = jnp.asarray(energy, dtype=dtype)
    batch_shape = jnp.broadcast_shapes(length.shape, energy.shape)
    length = jnp.broadcast_to(length, batch_shape)
    energy = jnp.broadcast_to(energy, batch_shape)

    igamma2 = igamma2_from_energy(energy, zero_value=0.0)
    beta2 = 1.0 - igamma2
    r56 = -length * _safe_div(igamma2, beta2, fallback=0.0)
    return build_rmatrix(
        {(0, 1): length, (2, 3): length, (4, 5): r56},
        batch_shape=batch_shape,
        dtype=dtype,
        batch_last=batch_last,
    )


def drift_rmatrix_entries(length: Array, energy: Array) -> dict:
    """Entry dict of the drift map (table form support)."""
    length = jnp.asarray(length)
    energy = jnp.asarray(energy, dtype=length.dtype)
    igamma2 = igamma2_from_energy(energy, zero_value=0.0)
    beta2 = 1.0 - igamma2
    r56 = -length * _safe_div(igamma2, beta2, fallback=0.0)
    return {(0, 1): length, (2, 3): length, (4, 5): r56}


def cavity_rmatrix(
    length: Array,
    voltage: Array,
    phase: Array,
    frequency: Array,
    energy: Array,
    batch_last: bool = False,
) -> Array:
    entries, batch_shape, dtype = cavity_rmatrix_entries(
        length, voltage, phase, frequency, energy
    )
    return build_rmatrix(
        entries, batch_shape=batch_shape, dtype=dtype, batch_last=batch_last
    )


def cavity_rmatrix_entries(
    length: Array,
    voltage: Array,
    phase: Array,
    frequency: Array,
    energy: Array,
):
    r"""Linear map of an accelerating RF cavity (pi-standing-wave model).

    Rosenzweig-Serafini-style transverse focusing plus the longitudinal
    (r55_cor, r56, r65, r66) block.  Reference behavior:
    ``lynx/accelerator/cavity.py:248-325``.

    The formulas are *reparametrized* into a uniformly stable, branch-free
    form (exactly equal to the reference's in real arithmetic), so that a
    single expression covers V = 0, the zero-crossing phase (cos phi = 0) and
    mixed on/off batches without NaNs — the reference's Python-level guards
    cannot (contract: ``tests/test_vectorized.py:423-439``):

    * ``alpha = sqrt(eta/8)/cos(phi) * ln(Ef/Ei)`` is rewritten via
      ``ln(1+x)/x`` with ``x = V cos(phi)/E`` — no ``1/cos(phi)``.
    * ``r12 = sqrt(8/eta) Ei/E' cos(phi) sin(alpha)`` becomes
      ``sqrt(8/eta) L (Ei/V) sin(alpha)`` — no division by the energy gain.
    * the ``(g0-g1)^2`` denominator of ``r55_cor`` cancels analytically:
      ``g0 g1 (b0 b1 - 1) + 1 = -[(g0-g1)^2 + (g0 b0 - g1 b1)^2] /
      (2 g0 g1 (1 + b0 b1))`` and ``(g0 b0 - g1 b1) = (g0-g1)(g0+g1)/(g0 b0
      + g1 b1)``, so the quotient is evaluated without cancellation.
    """
    length = jnp.asarray(length)
    dtype = length.dtype
    voltage = jnp.asarray(voltage, dtype=dtype)
    phase = jnp.asarray(phase, dtype=dtype)
    frequency = jnp.asarray(frequency, dtype=dtype)
    energy = jnp.asarray(energy, dtype=dtype)

    batch_shape = jnp.broadcast_shapes(
        length.shape, voltage.shape, phase.shape, frequency.shape, energy.shape
    )
    length, voltage, phase, frequency, energy = (
        jnp.broadcast_to(a, batch_shape)
        for a in (length, voltage, phase, frequency, energy)
    )

    eta = 1.0
    phi = jnp.deg2rad(phase)
    cos_phi = jnp.cos(phi)
    sin_phi = jnp.sin(phi)

    has_beam = energy != 0
    Ei = jnp.where(has_beam, energy, 1.0) / ELECTRON_MASS_EV  # gamma_in
    Vm = voltage / ELECTRON_MASS_EV

    x = Vm * cos_phi / Ei  # relative energy gain
    Ef = Ei * (1.0 + x)  # gamma_out
    # Valid = beam present and outgoing energy physically meaningful.
    valid = has_beam & (Ef > 1.0)
    Ef = jnp.where(valid, Ef, Ei)
    x = jnp.where(valid, x, 0.0)

    # ln(Ef/Ei)/x = ln(1+x)/x, -> 1 as x -> 0.
    x_safe = jnp.where(x == 0, 1.0, x)
    lx = jnp.where(x == 0, 1.0, jnp.log1p(x) / x_safe)
    alpha = jnp.sqrt(eta / 8.0) * (Vm / Ei) * lx
    sin_alpha = jnp.sin(alpha)
    cos_alpha = jnp.cos(alpha)

    r11 = cos_alpha - jnp.sqrt(2.0 / eta) * cos_phi * sin_alpha
    # sin(alpha)/alpha -> 1 handles V -> 0 (r12 -> L, the drift limit).
    Vm_safe = jnp.where(Vm == 0, 1.0, Vm)
    r12 = jnp.where(
        Vm == 0,
        length,
        jnp.sqrt(8.0 / eta) * length * (Ei / Vm_safe) * sin_alpha,
    )
    r21 = (
        -(Vm / (length * Ef))
        * sin_alpha
        * (cos_phi**2 / jnp.sqrt(2.0 * eta) + jnp.sqrt(eta / 8.0))
    )
    r22 = Ei / Ef * (cos_alpha + jnp.sqrt(2.0 / eta) * cos_phi * sin_alpha)

    beta0 = jnp.sqrt(1.0 - 1.0 / Ei**2)
    beta1 = jnp.sqrt(1.0 - 1.0 / Ef**2)

    k = 2.0 * jnp.pi * frequency / SPEED_OF_LIGHT
    # Identical to drift r56 when V == 0 (verified analytically).
    r56 = -length / (Ef**2 * Ei * beta1) * (Ef + Ei) / (beta1 + beta0)
    # Cancellation-free r55 correction (see docstring).
    g0, g1 = Ei, Ef
    gb_sum = g0 * beta0 + g1 * beta1
    ratio = (g0 + g1) / jnp.where(gb_sum == 0, 1.0, gb_sum)
    r55_cor = (
        -k
        * length
        * beta0
        * Vm
        * sin_phi
        * (1.0 + ratio**2)
        / (2.0 * g0 * g1 * (1.0 + beta0 * beta1) * beta1 * g1)
    )

    r66 = Ei / Ef * beta0 / beta1
    r65 = k * sin_phi * Vm / (Ef * beta1)

    # Invalid entries (no beam / fully decelerated): identity-but-drift map.
    igamma2 = igamma2_from_energy(energy, zero_value=0.0)
    beta2 = 1.0 - igamma2
    drift_r56 = -length * _safe_div(igamma2, beta2, fallback=0.0)

    r11 = jnp.where(valid, r11, 1.0)
    r12 = jnp.where(valid, r12, length)
    r21 = jnp.where(valid, r21, 0.0)
    r22 = jnp.where(valid, r22, 1.0)
    r55 = jnp.where(valid, 1.0 + r55_cor, 1.0)
    r56 = jnp.where(valid, r56, drift_r56)
    r65 = jnp.where(valid, r65, 0.0)
    r66 = jnp.where(valid, r66, 1.0)

    entries = {
        (0, 0): r11,
        (0, 1): r12,
        (1, 0): r21,
        (1, 1): r22,
        (2, 2): r11,
        (2, 3): r12,
        (3, 2): r21,
        (3, 3): r22,
        (4, 4): r55,
        (4, 5): r56,
        (5, 4): r65,
        (5, 5): r66,
    }
    return entries, batch_shape, dtype
