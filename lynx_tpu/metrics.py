"""Per-step beam-statistics metrics emission (SURVEY.md §5 metrics row).

The reference's only observability is matplotlib plots; this module adds
the structured-metrics channel this build needs: scalar beam
statistics emitted per training/env step through the ``lynx_tpu``
logger, including from *inside* jitted code via
``jax.debug.callback`` (the host callback runs asynchronously — call
``jax.block_until_ready`` or ``jax.effects_barrier()`` before asserting
on captured logs).

Usage (host side)::

    from lynx_tpu.metrics import beam_stats, log_metrics
    log_metrics(step=i, **beam_stats(outgoing))

Inside jit (e.g. the RL env with ``log_metrics=True``)::

    emit_metrics({"reward": reward.mean(), ...}, step=state.step_count)
"""

from __future__ import annotations

from typing import Dict, Optional

import jax
import jax.numpy as jnp

from lynx_tpu.log import get_logger

logger = get_logger("metrics")


def beam_stats(beam) -> Dict[str, jax.Array]:
    """Scalar summary statistics of a beam (means over any batch dims)."""
    return {
        "mu_x": jnp.mean(beam.mu_x),
        "sigma_x": jnp.mean(beam.sigma_x),
        "mu_y": jnp.mean(beam.mu_y),
        "sigma_y": jnp.mean(beam.sigma_y),
        "energy": jnp.mean(beam.energy),
    }


def format_metrics(metrics: Dict[str, float], step: Optional[int] = None) -> str:
    """One structured ``key=value`` line, stable key order."""
    parts = [] if step is None else [f"step={int(step)}"]
    parts += [f"{k}={float(v):.6g}" for k, v in sorted(metrics.items())]
    return " ".join(parts)


def log_metrics(step: Optional[int] = None, **metrics) -> None:
    """Host-side structured metrics emission through the package logger."""
    logger.info(format_metrics(metrics, step))


def emit_metrics(metrics: Dict[str, jax.Array], step=None) -> None:
    """Jit-safe metrics emission: usable inside traced code.

    Lowers to a ``jax.debug.callback`` that logs on the host once the
    values are computed.  Zero device-side cost beyond materializing the
    scalars; the callback is ordered with other debug effects.
    """

    def _cb(step_val, vals):
        s = None if step_val is None else int(jnp.reshape(step_val, (-1,))[0])
        logger.info(format_metrics(vals, s))

    jax.debug.callback(_cb, step, metrics)
