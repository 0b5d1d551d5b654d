"""PPO on the vectorized ARES-EA tuning environment — pure JAX.

Reference analog: the RL workload Cheetah/lynx was built for (its README's
"speed up the training of reinforcement learning models").  Everything —
environment physics, policy, PPO update — runs inside one jit; environments
are vectorized with vmap (and shard over a device mesh for multi-chip).

Run: python examples/ppo_ares_ea.py [--updates 20] [--num-envs 512]
"""

from __future__ import annotations

import argparse
import time
from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax

from lynx_tpu.envs import make_env
from lynx_tpu.envs.ares_ea import default_params


class MLPPolicy(NamedTuple):
    """Parameters of a tanh-Gaussian policy + value function."""

    weights: dict

    @staticmethod
    def init(key, obs_size, act_size, hidden=64):
        keys = jax.random.split(key, 6)

        def dense(k, n_in, n_out):
            return {
                "w": jax.random.normal(k, (n_in, n_out)) * jnp.sqrt(2.0 / n_in),
                "b": jnp.zeros((n_out,)),
            }

        return MLPPolicy(
            weights={
                "torso1": dense(keys[0], obs_size, hidden),
                "torso2": dense(keys[1], hidden, hidden),
                "mean": dense(keys[2], hidden, act_size),
                "value": dense(keys[3], hidden, 1),
                "log_std": jnp.zeros((act_size,)) - 0.5,
            }
        )

    def __call__(self, obs):
        w = self.weights
        h = jnp.tanh(obs @ w["torso1"]["w"] + w["torso1"]["b"])
        h = jnp.tanh(h @ w["torso2"]["w"] + w["torso2"]["b"])
        mean = jnp.tanh(h @ w["mean"]["w"] + w["mean"]["b"])
        value = (h @ w["value"]["w"] + w["value"]["b"])[..., 0]
        return mean, w["log_std"], value


def gaussian_logp(mean, log_std, action):
    return jnp.sum(
        -0.5 * ((action - mean) / jnp.exp(log_std)) ** 2
        - log_std
        - 0.5 * jnp.log(2 * jnp.pi),
        axis=-1,
    )


def make_collect_and_update(env, env_params, optimizer, rollout: int):
    """Build the jitted PPO step: rollout via lax.scan over the natively
    batched env (NOT vmap — batched tracking engages the framework's
    sparse-table fast path), GAE, clipped surrogate update."""
    step = env.batched_step
    gamma, lam, clip_eps = 0.99, 0.95, 0.2

    @jax.jit
    def collect_and_update(policy, opt_state, obs, states, key):
        def rollout_step(carry, _):
            obs, states, key = carry
            key, k_act = jax.random.split(key)
            mean, log_std, value = policy(obs)
            noise = jax.random.normal(k_act, mean.shape)
            action = mean + jnp.exp(log_std) * noise
            logp = gaussian_logp(mean, log_std, action)
            next_obs, next_states, reward, done = step(states, action, env_params)
            transition = (obs, action, logp, value, reward, done)
            return (next_obs, next_states, key), transition

        (obs, states, key), traj = jax.lax.scan(
            rollout_step, (obs, states, key), None, length=rollout
        )
        traj_obs, traj_act, traj_logp, traj_val, traj_rew, traj_done = traj

        # GAE advantages.
        _, _, last_val = policy(obs)

        def gae_step(carry, inputs):
            gae, next_value = carry
            value, reward, done = inputs
            not_done = 1.0 - done.astype(jnp.float32)
            delta = reward + gamma * next_value * not_done - value
            gae = delta + gamma * lam * not_done * gae
            return (gae, value), gae

        _, advantages = jax.lax.scan(
            gae_step,
            (jnp.zeros_like(last_val), last_val),
            (traj_val, traj_rew, traj_done),
            reverse=True,
        )
        returns = advantages + traj_val
        advantages = (advantages - advantages.mean()) / (advantages.std() + 1e-8)

        def ppo_loss(policy):
            mean, log_std, value = policy(traj_obs)
            logp = gaussian_logp(mean, log_std, traj_act)
            ratio = jnp.exp(logp - traj_logp)
            pg = -jnp.minimum(
                ratio * advantages,
                jnp.clip(ratio, 1 - clip_eps, 1 + clip_eps) * advantages,
            ).mean()
            vf = 0.5 * ((value - returns) ** 2).mean()
            entropy = jnp.sum(log_std + 0.5 * jnp.log(2 * jnp.pi * jnp.e))
            return pg + 0.5 * vf - 0.001 * entropy, traj_rew.mean()

        (loss, mean_reward), grads = jax.value_and_grad(ppo_loss, has_aux=True)(
            policy
        )
        updates_, opt_state = optimizer.update(grads, opt_state)
        policy = optax.apply_updates(policy, updates_)
        return policy, opt_state, obs, states, key, loss, mean_reward

    return collect_and_update


def main(updates: int = 20, num_envs: int = 512, rollout: int = 16) -> None:
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

    collect_and_update = make_collect_and_update(
        env, env_params, optimizer, rollout
    )

    steps_per_update = num_envs * rollout
    start = time.perf_counter()
    for i in range(updates):
        policy, opt_state, obs, states, key, loss, mean_reward = (
            collect_and_update(policy, opt_state, obs, states, key)
        )
        if i % 5 == 0 or i == updates - 1:
            jax.block_until_ready(loss)
            elapsed = time.perf_counter() - start
            sps = steps_per_update * (i + 1) / elapsed
            print(
                f"update {i:4d}  loss {float(loss):9.4f}  "
                f"mean reward {float(mean_reward):9.4f}  "
                f"env-steps/s {sps:,.0f}"
            )


if __name__ == "__main__":
    from lynx_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    parser = argparse.ArgumentParser()
    parser.add_argument("--updates", type=int, default=20)
    parser.add_argument("--num-envs", type=int, default=512)
    parser.add_argument("--rollout", type=int, default=16)
    args = parser.parse_args()
    main(args.updates, args.num_envs, args.rollout)
