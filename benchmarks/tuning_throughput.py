"""Gradient-tuning throughput: scanned on-device loop vs per-step dispatch.

The flagship workload (reference ``docs/examples/gradientbased.ipynb``) is a
value-and-grad + Adam loop over ARES EA beam parameters.  This harness
measures optimizer steps/s two ways:

* ``scanned`` — ``lynx_tpu.tune``'s ``lax.scan`` loop, one dispatch per
  ``--steps-per-call`` steps (the production shape; it amortizes the
  per-call dispatch cost), and
* ``per_step`` — the reference-style Python loop, one jitted step per
  dispatch.

Prints one JSON line:
    {"metric": "tuning_steps_per_s", "value": N, "unit": "steps/s",
     "per_step_steps_per_s": N, "speedup": N, "batch": B}

``--batch B`` tunes B independent magnet settings simultaneously (vectorized
machines; the scan then advances B optimizations per step).

Usage: python benchmarks/tuning_throughput.py [--steps-per-call 100]
       [--batch 1] [--cpu]
"""

from __future__ import annotations

# Make the repo root importable no matter where this script is launched
# from (round-2 on-device runs died on `ModuleNotFoundError: lynx_tpu`).
import pathlib as _pathlib
import sys as _sys

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))

import argparse
import json
import time


def main(steps_per_call: int, batch: int, measure_calls: int) -> None:
    import jax
    import jax.numpy as jnp
    import optax

    from lynx_tpu.envs import make_env
    from lynx_tpu.envs.ares_ea import default_params
    from lynx_tpu.tuning import make_tuner

    env = make_env()
    if batch > 1:
        params = jax.vmap(default_params)(
            jax.random.split(jax.random.PRNGKey(42), batch)
        )
        reference = jnp.tile(
            jnp.array([0.3, -0.4, 0.25, 0.3, -0.2]), (batch, 1)
        )
        target = jax.jit(env.batched_beam_parameters)(reference, params)
        params = params._replace(target=target)

        def loss_fn(normalized, params):
            observed = env.batched_beam_parameters(
                jnp.tanh(normalized), params
            )
            return jnp.mean(jnp.abs(observed - params.target)) * 1e3

        magnets0 = jnp.zeros((batch, env.num_actions))
    else:
        params = default_params(jax.random.PRNGKey(42))
        params = params._replace(
            target=env.beam_parameters(
                jnp.array([0.3, -0.4, 0.25, 0.3, -0.2]), params
            )
        )

        def loss_fn(normalized, params):
            observed = env.beam_parameters(jnp.tanh(normalized), params)
            return jnp.sum(jnp.abs(observed - params.target)) * 1e3

        magnets0 = jnp.zeros(env.num_actions)

    optimizer = optax.adam(5e-2)
    tuner = make_tuner(optimizer, loss_fn)
    opt_state = optimizer.init(magnets0)

    from lynx_tpu.profiling import _fetch

    # Scanned loop: one dispatch per steps_per_call steps.  The (m, s)
    # carry chains calls data-dependently; the closing value fetch forces
    # completion.
    m, s, losses = tuner(magnets0, opt_state, steps_per_call, params)
    _fetch(losses)  # compile + warm
    start = time.perf_counter()
    m, s = magnets0, opt_state
    for _ in range(measure_calls):
        m, s, losses = tuner(m, s, steps_per_call, params)
    _fetch((m, losses))
    scanned = steps_per_call * measure_calls / (time.perf_counter() - start)

    # Reference-style per-step dispatch.
    @jax.jit
    def step(m, s, params):
        loss, grads = jax.value_and_grad(loss_fn)(m, params)
        updates, s = optimizer.update(grads, s, m)
        return optax.apply_updates(m, updates), s, loss

    m, s = magnets0, opt_state
    m, s, loss = step(m, s, params)
    _fetch(loss)  # compile + warm
    n_steps = min(steps_per_call * measure_calls, 300)
    start = time.perf_counter()
    for _ in range(n_steps):
        m, s, loss = step(m, s, params)
    _fetch((m, loss))
    per_step = n_steps / (time.perf_counter() - start)

    print(
        json.dumps(
            {
                "metric": "tuning_steps_per_s",
                "value": round(scanned, 1),
                "unit": "steps/s",
                "per_step_steps_per_s": round(per_step, 1),
                "speedup": round(scanned / per_step, 2),
                "batch": batch,
                "steps_per_call": steps_per_call,
                "final_loss_mm": round(float(losses[-1].mean()), 6),
            }
        )
    )


if __name__ == "__main__":
    from lynx_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps-per-call", type=int, default=100)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--measure-calls", type=int, default=5)
    parser.add_argument("--cpu", action="store_true")
    args = parser.parse_args()
    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")
    main(args.steps_per_call, args.batch, args.measure_calls)
