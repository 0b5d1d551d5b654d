"""Reproducible RL-training throughput measurement.

Runs the full PPO loop from ``examples/ppo_ares_ea.py`` (environment physics
+ policy + GAE + Adam, all in one jit) and reports *steady-state* env-steps/s
— warmup updates are excluded, unlike the cumulative rate the example prints.

Prints one JSON line:
    {"metric": "ppo_env_steps_per_s", "value": N, "unit": "env-steps/s",
     "num_envs": B, "rollout": T}

Usage: python benchmarks/rl_throughput.py [--num-envs 4096] [--rollout 16]
"""

from __future__ import annotations

# Make the repo root importable no matter where this script is launched
# from (round-2 on-device runs died on `ModuleNotFoundError: lynx_tpu`).
import pathlib as _pathlib
import sys as _sys

_sys.path.insert(0, str(_pathlib.Path(__file__).resolve().parent.parent))

import argparse
import json
import pathlib
import sys
import time

import jax

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "examples"))


def main(num_envs: int, rollout: int, warmup: int, measure: int) -> None:
    import jax.numpy as jnp
    import optax
    from ppo_ares_ea import MLPPolicy, gaussian_logp  # noqa: F401 (jit body)
    import ppo_ares_ea

    # Reuse the example's training-step construction by running its main loop
    # logic inline with explicit timing.
    from lynx_tpu.envs import make_env
    from lynx_tpu.envs.ares_ea import default_params

    env = make_env()
    key = jax.random.PRNGKey(0)
    key, k_params, k_reset, k_policy = jax.random.split(key, 4)
    env_params = jax.vmap(default_params)(jax.random.split(k_params, num_envs))
    policy = MLPPolicy.init(k_policy, env.obs_size, env.num_actions)
    optimizer = optax.adam(3e-4)
    opt_state = optimizer.init(policy)
    obs, states = jax.jit(env.batched_reset)(
        jax.random.split(k_reset, num_envs), env_params
    )

    step_fn = ppo_ares_ea.make_collect_and_update(
        env, env_params, optimizer, rollout
    )

    from lynx_tpu.profiling import _fetch

    carry = (policy, opt_state, obs, states, key)
    for _ in range(warmup):
        *carry, _, _ = step_fn(*carry)
    _fetch(carry[2])  # value fetch: block_until_ready is dispatch-ack only

    start = time.perf_counter()
    for _ in range(measure):
        *carry, loss, _ = step_fn(*carry)
    # The PPO carry chains data-dependently through every step, so this
    # single value fetch forces completion of the whole measured span.
    _fetch(loss)
    elapsed = time.perf_counter() - start

    steps_per_s = num_envs * rollout * measure / elapsed
    print(
        json.dumps(
            {
                "metric": "ppo_env_steps_per_s",
                "value": round(steps_per_s),
                "unit": "env-steps/s",
                "num_envs": num_envs,
                "rollout": rollout,
            }
        )
    )


if __name__ == "__main__":
    from lynx_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    parser = argparse.ArgumentParser()
    parser.add_argument("--num-envs", type=int, default=4096)
    parser.add_argument("--rollout", type=int, default=16)
    parser.add_argument("--warmup", type=int, default=5)
    parser.add_argument("--measure", type=int, default=20)
    args = parser.parse_args()
    main(args.num_envs, args.rollout, args.warmup, args.measure)
