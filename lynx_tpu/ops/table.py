"""Sparse symbolic 7x7 map algebra over batched entry vectors.

A transfer map over a large flat batch is represented as a 7x7 Python table
whose cells are either ``(batch,)`` arrays or literal Python floats (0.0/1.0
for structural zeros / identity).  Composing tables skips literal zeros at
*trace time*, so a chain of mostly-sparse accelerator maps (drifts have 10
non-trivial entries of 49) costs a fraction of the dense 343 multiply-adds —
and no ``(7, 7, B)`` array is ever materialized: every cell stays a
``(batch,)`` vector that XLA fuses into elementwise multiply-adds.

This is the compute core of the large-batch flush path
(``Segment._flush_run``) and of the particle moment sweep plans
(``accelerator/fused.py``, ``ops/sweep.py``).
"""

from __future__ import annotations

from typing import Dict, List, Tuple, Union

import jax
import jax.numpy as jnp

Array = jax.Array
Cell = Union[Array, float]
Table = List[List[Cell]]  # 7 x 7


def _is_literal(cell: Cell) -> bool:
    return isinstance(cell, (int, float))


def _is_zero(cell: Cell) -> bool:
    return _is_literal(cell) and cell == 0.0


def _is_one(cell: Cell) -> bool:
    return _is_literal(cell) and cell == 1.0


def _mul(a: Cell, b: Cell) -> Cell:
    if _is_zero(a) or _is_zero(b):
        return 0.0
    if _is_one(a):
        return b
    if _is_one(b):
        return a
    if _is_literal(a) and _is_literal(b):
        return a * b
    return a * b


def _add(a: Cell, b: Cell) -> Cell:
    if _is_zero(a):
        return b
    if _is_zero(b):
        return a
    return a + b


def identity_table() -> Table:
    return [[1.0 if i == j else 0.0 for j in range(7)] for i in range(7)]


def entries_to_table(entries: Dict[Tuple[int, int], Cell]) -> Table:
    """Identity plus the given entries (the table analog of build_rmatrix)."""
    return [
        [entries.get((i, j), 1.0 if i == j else 0.0) for j in range(7)]
        for i in range(7)
    ]


def compose(second: Table, first: Table) -> Table:
    """``second @ first`` with literal-zero short-circuiting."""
    out: Table = []
    for i in range(7):
        row: List[Cell] = []
        for k in range(7):
            acc: Cell = 0.0
            for j in range(7):
                acc = _add(acc, _mul(second[i][j], first[j][k]))
            row.append(acc)
        out.append(row)
    return out


def matvec(table: Table, vector: List[Cell]) -> List[Cell]:
    """``T @ v`` for a 7-entry cell vector."""
    out: List[Cell] = []
    for i in range(7):
        acc: Cell = 0.0
        for j in range(7):
            acc = _add(acc, _mul(table[i][j], vector[j]))
        out.append(acc)
    return out


def cov_sandwich(table: Table, cov: Table) -> Table:
    """``T C T^T`` on tables."""
    tc = compose(table, cov)
    out: Table = []
    for i in range(7):
        row: List[Cell] = []
        for l in range(7):  # noqa: E741
            acc: Cell = 0.0
            for k in range(7):
                acc = _add(acc, _mul(tc[i][k], table[l][k]))
            row.append(acc)
        out.append(row)
    return out


def transpose_table(table: Table) -> Table:
    """``T^T`` (free at trace time)."""
    return [[table[j][i] for j in range(7)] for i in range(7)]


def add_tables(a: Table, b: Table) -> Table:
    """Cell-wise ``A + B`` with literal-zero short-circuiting."""
    return [[_add(a[i][j], b[i][j]) for j in range(7)] for i in range(7)]


def outer_table(u: List[Cell], v: List[Cell]) -> Table:
    """Rank-1 table ``u v^T``."""
    return [[_mul(u[i], v[j]) for j in range(7)] for i in range(7)]


def where_table(mask: Array, then_table: Table, else_table: Table) -> Table:
    """Cell-wise ``jnp.where`` merge of two tables (literals preserved when
    both branches agree)."""
    out: Table = []
    for i in range(7):
        row: List[Cell] = []
        for j in range(7):
            a, b = then_table[i][j], else_table[i][j]
            if _is_literal(a) and _is_literal(b) and a == b:
                row.append(a)
            else:
                row.append(jnp.where(mask, a, b))
        out.append(row)
    return out


def broadcast_cell(cell: Cell, batch_shape, dtype) -> Array:
    if _is_literal(cell):
        if cell == 0.0:
            return jnp.zeros(batch_shape, dtype=dtype)
        return jnp.full(batch_shape, cell, dtype=dtype)
    return jnp.broadcast_to(jnp.asarray(cell, dtype=dtype), batch_shape)


def split_table(total: Table):
    """Split a table into ``(layout, cells)``: literals stay in the layout,
    array cells are replaced by their index into the cell list."""
    layout = []
    cells = []
    for i in range(7):
        row = []
        for j in range(7):
            cell = total[i][j]
            if _is_literal(cell):
                row.append(float(cell))
            else:
                row.append(len(cells))
                cells.append(cell)
        layout.append(row)
    return layout, cells


def table_to_batch_last(table: Table, batch_shape, dtype) -> Array:
    """Materialize a table as a stacked ``(7, 7, *batch)`` array."""
    return jnp.stack(
        [
            jnp.stack(
                [broadcast_cell(cell, batch_shape, dtype) for cell in row], axis=0
            )
            for row in table
        ],
        axis=0,
    )


def batch_last_to_table(stacked: Array) -> Table:
    return [[stacked[i, j] for j in range(7)] for i in range(7)]


def table_from_batch_first(tm: Array) -> Table:
    """``(..., 7, 7)`` array -> table of ``(...)`` cells."""
    return [[tm[..., i, j] for j in range(7)] for i in range(7)]
