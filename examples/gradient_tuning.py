"""Gradient-based tuning of the ARES Experimental Area.

The lynx-tpu version of the reference's flagship example
(``docs/examples/gradientbased.ipynb``): tune 3 quadrupoles + 2 correctors so
the beam hits a target position/size on the AREABSCR1 screen — with
``jax.grad`` through the pure tracking function and optax.

Magnets are optimized in *normalized* space (each setting in [-1, 1], scaled
by its physical limit) so a single Adam learning rate is well-conditioned for
quadrupole strengths (O(10) 1/m^2) and corrector kicks (O(1e-3) rad) alike.

Run: python examples/gradient_tuning.py [--steps 300]
"""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import optax

from lynx_tpu.envs import make_env
from lynx_tpu.envs.ares_ea import MAGNET_LIMITS, default_params


def main(steps: int = 300) -> None:
    env = make_env()
    params = default_params(jax.random.PRNGKey(42))
    # Target the beam produced by a reference magnet setting so the optimum
    # is exactly reachable (a random target can be outside the machine's
    # attainable set, stalling the loss at its boundary distance).
    reference_setting = jnp.array([0.3, -0.4, 0.25, 0.3, -0.2])
    params = params._replace(
        target=env.beam_parameters(reference_setting, params)
    )
    print("target (mu_x, sigma_x, mu_y, sigma_y) [mm]:", params.target * 1e3)

    def loss_fn(normalized_magnets):
        observed = env.beam_parameters(jnp.tanh(normalized_magnets), params)
        return jnp.sum(jnp.abs(observed - params.target)) * 1e3  # mm

    # The whole loop runs on device: `tune` compiles `steps` value-and-grad +
    # Adam updates into one lax.scan, so a full tuning run is a handful of
    # dispatches (chunked only for progress printing) instead of one per step
    # — one dispatch cost instead of `steps` of them.
    from lynx_tpu.tuning import tune

    magnets, losses = tune(
        loss_fn,
        jnp.zeros(env.num_actions),
        optimizer=optax.adam(5e-2),
        steps=steps,
        chunk=25,
        callback=lambda i, loss: print(
            f"step {i:4d}  |beam - target| = {loss:.6f} mm"
        ),
    )

    settings = jnp.tanh(magnets) * MAGNET_LIMITS
    print("tuned k1 [1/m^2]:", settings[:3])
    print("tuned angles [rad]:", settings[3:])
    observed = env.beam_parameters(jnp.tanh(magnets), params)
    print("achieved beam [mm]:", observed * 1e3)


if __name__ == "__main__":
    from lynx_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    parser = argparse.ArgumentParser()
    parser.add_argument("--steps", type=int, default=300)
    main(parser.parse_args().steps)
