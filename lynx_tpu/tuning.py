"""On-device gradient-tuning loops.

The reference's flagship workload is gradient-based lattice tuning driven by
a Python loop — one optimizer step per host->device dispatch (reference
``docs/examples/gradientbased.ipynb``).  On an accelerator, whose per-call
dispatch cost exceeds a small step's compute, that loop shape leaves most
of the device idle.  :func:`make_tuner` compiles the WHOLE loop: ``steps``
value-and-grad + optimizer updates run as a single ``lax.scan`` under one
``jit``, so a full tuning run is one dispatch and the loss history comes
back as one array.

The parameters can be any pytree — a bare magnet-settings vector, or a whole
``Segment`` (every array leaf is then trainable; freeze leaves by masking the
optimizer, e.g. ``optax.masked``).  Composes with multi-chip sharding: inputs
placed via :func:`lynx_tpu.parallel.shard_beam` / ``shard_segment`` keep
their shardings through the scan, exactly like
:func:`lynx_tpu.parallel.make_tuning_train_step`.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import jax
import jax.numpy as jnp
import optax

__all__ = ["make_tuner", "tune", "tune_until"]


def make_tuner(optimizer, loss_fn: Callable[..., jax.Array]):
    """Build ``tune(params, opt_state, steps, *args) -> (params, opt_state,
    losses)``: ``steps`` optimizer iterations in one compiled ``lax.scan``.

    ``loss_fn(params, *args) -> scalar``; ``*args`` (beams, targets, ...) are
    closed over the scan as loop constants.  ``steps`` is static — each
    distinct value compiles once; reuse one value (or chunk) when sweeping.
    """

    def _tune(params, opt_state, steps: int, *args):
        def step(carry, _):
            params, opt_state = carry
            loss, grads = jax.value_and_grad(loss_fn)(params, *args)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return (params, opt_state), loss

        (params, opt_state), losses = jax.lax.scan(
            step, (params, opt_state), None, length=steps
        )
        return params, opt_state, losses

    return jax.jit(_tune, static_argnums=2)


def tune(
    loss_fn: Callable[..., jax.Array],
    params: Any,
    *args,
    optimizer=None,
    steps: int = 100,
    chunk: Optional[int] = None,
    callback: Optional[Callable[[int, float], None]] = None,
):
    """One-call tuning: minimize ``loss_fn(params, *args)`` for ``steps``
    iterations entirely on device; return ``(params, losses)``.

    :param optimizer: optax transform (default ``optax.adam(5e-2)``).
    :param chunk: if given, run the scan in chunks of this many steps and
        invoke ``callback(step, loss)`` between chunks (progress reporting
        without paying a dispatch per step).  One compile serves all chunks.
    :return: tuned params and the ``(steps,)`` loss history.
    """
    if optimizer is None:
        optimizer = optax.adam(5e-2)
    tuner = make_tuner(optimizer, loss_fn)
    opt_state = optimizer.init(params)

    if not chunk or chunk >= steps:
        params, _, losses = tuner(params, opt_state, steps, *args)
        if callback is not None:
            callback(steps - 1, float(losses[-1]))
        return params, losses

    histories = []
    done = 0
    while done < steps:
        n = min(chunk, steps - done)
        params, opt_state, losses = tuner(params, opt_state, n, *args)
        histories.append(losses)
        done += n
        if callback is not None:
            callback(done - 1, float(losses[-1]))
    return params, jnp.concatenate(histories)


def tune_until(
    loss_fn: Callable[..., jax.Array],
    params: Any,
    *args,
    optimizer=None,
    tol: float = 1e-8,
    max_steps: int = 1000,
):
    """Minimize until converged, entirely on device: one dispatch runs a
    ``lax.while_loop`` of optimizer steps that stops as soon as the loss
    improves by less than ``tol`` (relative to ``max(1, |loss|)``) between
    consecutive steps — no per-step host round trips for the convergence
    check.

    :return: ``(params, losses, num_steps)`` — ``losses`` is a fixed
        ``(max_steps,)`` buffer, NaN-padded past ``num_steps``.
    """
    if optimizer is None:
        optimizer = optax.adam(5e-2)
    opt_state = optimizer.init(params)

    @jax.jit
    def run(params, opt_state, *args):
        def step_fn(carry):
            params, opt_state, history, i, _prev = carry
            loss, grads = jax.value_and_grad(loss_fn)(params, *args)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            history = jax.lax.dynamic_update_index_in_dim(
                history, loss.astype(history.dtype), i, axis=0
            )
            return params, opt_state, history, i + 1, loss

        def cond_fn(carry):
            _, _, history, i, last = carry
            # ``last`` is the most recent loss (history[i-1]); compare with
            # the one before it.
            previous = history[jnp.maximum(i - 2, 0)]
            improving = jnp.abs(previous - last) > tol * jnp.maximum(
                1.0, jnp.abs(last)
            )
            return (i < max_steps) & ((i < 2) | improving)

        history0 = jnp.full((max_steps,), jnp.nan, dtype=jnp.float32)
        params, opt_state, history, i, _ = jax.lax.while_loop(
            cond_fn,
            step_fn,
            (params, opt_state, history0, jnp.asarray(0), jnp.asarray(jnp.inf)),
        )
        return params, history, i

    return run(params, opt_state, *args)
