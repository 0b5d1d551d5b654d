"""Composition of transfer-map chains.

The hot loop of lattice tracking is composing a run of ``(..., 7, 7)``
transfer maps into a single matrix (reference ``lynx/accelerator/
segment.py:329-338`` does this with a sequential Python loop).  Here we
fold the stacked maps with a balanced binary tree: ``ceil(log2(L))`` *batched*
matmuls instead of ``L`` sequential ones, which both shrinks the XLA graph
for long lattices (1000+ elements) and exposes batch parallelism.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def fold_transfer_maps(maps: Array) -> Array:
    """Compose stacked maps in application order.

    :param maps: ``(L, ..., 7, 7)`` array where ``maps[0]`` is applied first.
    :return: ``(..., 7, 7)`` composition ``maps[L-1] @ ... @ maps[0]``.
    """
    if maps.ndim < 3:
        raise ValueError(f"Expected (L, ..., 7, 7) maps, got shape {maps.shape}")
    while maps.shape[0] > 1:
        n = maps.shape[0]
        even = n - (n % 2)
        paired = jnp.matmul(
            maps[1:even:2], maps[0:even:2], precision=jax.lax.Precision.HIGHEST
        )
        if n % 2:
            maps = jnp.concatenate([paired, maps[-1:]], axis=0)
        else:
            maps = paired
    return maps[0]


def fold_transfer_maps_batch_last(maps: list[Array]) -> Array:
    """Compose a list of maps held in batch-last layout ``(7, 7, ...)``.

    Large-batch fast path: with the batch dimension on the trailing axes, a
    7x7 composition lowers to 49x7 vectorized multiply-adds that XLA fuses
    instead of many tiny batched matmuls.

    The maps stay a Python list (tree-folded pairwise) rather than a stacked
    ``(L, 7, 7, ...)`` array: XLA assigns stacked small-dim arrays a tiled
    layout that pads both 7s up to (8, 128) — a 16x memory blow-up that OOMs
    at million-scale batches.

    :param maps: list of ``(7, 7, ...)``; ``maps[0]`` is applied first.
    :return: ``(7, 7, ...)`` composition.
    """

    from lynx_tpu.ops.rmatrix import compose_batch_last as compose

    maps = list(maps)
    while len(maps) > 1:
        even = len(maps) - (len(maps) % 2)
        paired = [
            compose(maps[i + 1], maps[i]) for i in range(0, even, 2)
        ]
        if len(maps) % 2:
            paired.append(maps[-1])
        maps = paired
    return maps[0]
