"""ARES-EA transverse beam-tuning environment.

The reference's flagship RL workload (its README and
``docs/examples/gradientbased.ipynb``): tune the 3 quadrupoles and 2
correctors of the ARES Experimental Area so the beam hits a target position
and size on the AREABSCR1 screen.

Design: a *functional* environment in the jax-rl style (pure ``reset`` /
``step`` over an explicit ``EnvState``), so the whole environment vectorizes
with ``vmap`` and shards over device meshes — thousands of env instances per
chip is the normal operating mode (this is what replaces the reference's
in-process ``broadcast`` batching for RL).  A Gymnasium adapter is provided
for drop-in use with standard RL libraries.

Action: 5 deltas/settings ``(k1_Q1, k1_Q2, k1_Q3, angle_CV, angle_CH)``.
Observation: current magnet settings + beam parameters on the screen
``(mu_x, sigma_x, mu_y, sigma_y)`` + target beam parameters.
Reward: negative L1 distance between observed and target beam parameters.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

import lynx_tpu as lt
from lynx_tpu.functional import track
from lynx_tpu.models import ares_ea_segment

Array = jax.Array

#: Action scaling: max |k1| for quads (1/m^2), max |angle| for correctors (rad).
#: Kept as a numpy constant so importing this module needs no device backend.
import numpy as _np

MAGNET_LIMITS = _np.array([30.0, 30.0, 30.0, 6e-3, 6e-3], dtype=_np.float32)


class EnvParams(NamedTuple):
    """Per-instance environment configuration (a pytree; vmap-able).

    The working-point beam energy deliberately lives on the environment
    (``AresEATransverseTuning(energy=...)``), NOT here: per-instance
    energies would batch the energy through every transfer-map builder, and
    the EA tuning task runs at a fixed working point anyway (magnet
    strengths are geometric ``k1``, so the maps' energy dependence is only
    in the longitudinal cells).
    """

    target: Array  # (4,) target (mu_x, sigma_x, mu_y, sigma_y) on the screen
    incoming_mu: Array  # (4,) incoming beam (mu_x, mu_xp, mu_y, mu_yp)
    incoming_sigma: Array  # (4,) incoming (sigma_x, sigma_xp, sigma_y, sigma_yp)
    max_steps: int = 50


class EnvState(NamedTuple):
    magnets: Array  # (5,) current magnet settings (normalized to [-1, 1])
    step_count: Array  # () int32
    key: Array  # PRNG key


def default_params(key: Optional[Array] = None) -> EnvParams:
    """Randomized-target default parameters (mirrors the ARES-EA task)."""
    key = key if key is not None else jax.random.PRNGKey(0)
    k_pos, k_size, k_mu = jax.random.split(key, 3)
    target_pos = jax.random.uniform(k_pos, (2,), minval=-2e-3, maxval=2e-3)
    target_size = jax.random.uniform(k_size, (2,), minval=1e-5, maxval=1e-3)
    target = jnp.stack(
        [target_pos[0], target_size[0], target_pos[1], target_size[1]]
    )
    incoming_mu = jax.random.uniform(k_mu, (4,), minval=-1e-4, maxval=1e-4)
    return EnvParams(
        target=target,
        incoming_mu=incoming_mu,
        incoming_sigma=jnp.array([1.75e-4, 2e-5, 1.75e-4, 2e-5]),
    )


class AresEATransverseTuning:
    """Functional ARES-EA tuning environment over ParameterBeam physics.

    All methods are pure; wrap with ``jax.vmap`` for vectorized instances and
    ``jax.jit`` for compilation.  The lattice is traced once at construction.
    """

    num_actions = 5
    obs_size = 5 + 4 + 4  # magnets + current beam params + target

    def __init__(
        self, log_metrics: bool = False, energy: float = 1.073e8
    ) -> None:
        segment = ares_ea_segment()
        segment.AREABSCR1.is_active = False
        self._segment = segment
        #: Working-point beam energy in eV (shared across instances; see
        #: the ``EnvParams`` docstring for why it is not per-instance).
        self.energy = float(energy)
        #: When True, every (batched) step emits structured beam-stat
        #: metrics through the ``lynx_tpu.metrics`` logger — jit-safe via
        #: ``jax.debug.callback`` (SURVEY.md §5 metrics row).
        self.log_metrics = log_metrics

    # -- physics -----------------------------------------------------------
    def beam_parameters(self, magnets: Array, params: EnvParams) -> Array:
        """Track the incoming beam and return (mu_x, sigma_x, mu_y, sigma_y)
        at the screen position."""
        settings = magnets * MAGNET_LIMITS
        segment = self._segment
        # Functional magnet update: replace the tuned elements' strengths.
        elements = []
        for element in segment.elements:
            if element.name == "AREAMQZM1":
                element = element.replace(k1=settings[0][None])
            elif element.name == "AREAMQZM2":
                element = element.replace(k1=settings[1][None])
            elif element.name == "AREAMQZM3":
                element = element.replace(k1=settings[2][None])
            elif element.name == "AREAMCVM1":
                element = element.replace(angle=settings[3][None])
            elif element.name == "AREAMCHM1":
                element = element.replace(angle=settings[4][None])
            elements.append(element)
        tuned = lt.Segment(elements, name=segment.name)

        beam = lt.ParameterBeam.from_parameters(
            mu_x=params.incoming_mu[0][None],
            mu_xp=params.incoming_mu[1][None],
            mu_y=params.incoming_mu[2][None],
            mu_yp=params.incoming_mu[3][None],
            sigma_x=params.incoming_sigma[0][None],
            sigma_xp=params.incoming_sigma[1][None],
            sigma_y=params.incoming_sigma[2][None],
            sigma_yp=params.incoming_sigma[3][None],
            energy=jnp.full((1,), self.energy),
        )
        outgoing, _ = track(tuned, beam)
        return jnp.stack(
            [
                outgoing.mu_x[0],
                outgoing.sigma_x[0],
                outgoing.mu_y[0],
                outgoing.sigma_y[0],
            ]
        )

    def _batched_tuned_segment(self, magnets: Array) -> "lt.Segment":
        """The EA segment with the 5 tuned magnets set from ``(B, 5)``
        normalized settings (batched along the leading axis)."""
        B = magnets.shape[0]
        settings = magnets * MAGNET_LIMITS
        elements = []
        for element in self._segment.elements:
            def b(x):
                return jnp.broadcast_to(x, (B,))

            if element.name == "AREAMQZM1":
                element = element.replace(
                    length=b(element.length), k1=settings[:, 0]
                )
            elif element.name == "AREAMQZM2":
                element = element.replace(
                    length=b(element.length), k1=settings[:, 1]
                )
            elif element.name == "AREAMQZM3":
                element = element.replace(
                    length=b(element.length), k1=settings[:, 2]
                )
            elif element.name == "AREAMCVM1":
                element = element.replace(
                    length=b(element.length), angle=settings[:, 3]
                )
            elif element.name == "AREAMCHM1":
                element = element.replace(
                    length=b(element.length), angle=settings[:, 4]
                )
            elements.append(element)
        return lt.Segment(elements, name=self._segment.name)

    def batched_beam_parameters(
        self, magnets: Array, params: EnvParams
    ) -> Array:
        """Vectorized :meth:`beam_parameters` for ``(B, 5)`` magnet settings
        and batched ``EnvParams`` (leaves with a leading ``(B,)`` axis).

        Uses natively batched tracking — unlike ``vmap`` over
        :meth:`beam_parameters` (whose per-instance shapes hide the batch),
        this engages the large-batch sparse-table path.
        """
        tuned = self._batched_tuned_segment(magnets)

        beam = lt.ParameterBeam.from_parameters(
            mu_x=params.incoming_mu[:, 0],
            mu_xp=params.incoming_mu[:, 1],
            mu_y=params.incoming_mu[:, 2],
            mu_yp=params.incoming_mu[:, 3],
            sigma_x=params.incoming_sigma[:, 0],
            sigma_xp=params.incoming_sigma[:, 1],
            sigma_y=params.incoming_sigma[:, 2],
            sigma_yp=params.incoming_sigma[:, 3],
        )
        # Re-wrap with the UNBATCHED working-point energy:
        # ``from_parameters`` broadcasts every argument (including energy)
        # to the common batch shape (see the ``EnvParams`` docstring).
        beam = lt.ParameterBeam(
            beam._mu, beam._cov, energy=jnp.full((1,), self.energy)
        )
        outgoing, _ = track(tuned, beam)
        return jnp.stack(
            [outgoing.mu_x, outgoing.sigma_x, outgoing.mu_y, outgoing.sigma_y],
            axis=-1,
        )

    def batched_particle_beam_parameters(
        self,
        magnets: Array,
        beam: "lt.ParticleBeam",
        method: str = "auto",
    ) -> Array:
        """Full-fidelity observation: track a macro-particle beam through the
        tuned EA and return the ``(B, 4)`` sample-moment beam parameters
        ``(mu_x, sigma_x, mu_y, sigma_y)`` at the screen position.

        This is the BASELINE.md north-star workload (env-steps/s with a
        100k-``ParticleBeam``): the reference's equivalent is a broadcast
        ``Segment.track`` over a sampled beam (``tests/test_vectorized.py``'s
        (3, 100_000)-settings sweep).  The incoming beam is shared across the
        batch (it broadcasts against the ``(B,)``-batched magnet settings).

        :param method: observation route —

            * ``"auto"`` (default): ``"moments"`` when the tuned lattice is
              moment-sufficient (purely linear; the EA with its screen
              inactive is), else ``"particles"``.
            * ``"moments"``: propagate the beam's *sample* moments
              (``beam.as_parameter_beam()``) through the lattice.  For a
              linear lattice this is algebraically EXACT — identical
              ``mu``/``sigma`` observations to pushing all N particles
              (``mu' = R mu``, ``Sigma' = R Sigma R^T``; the moments are a
              sufficient statistic) — at ~N-times less work per setting
              (the dense per-setting push re-reads the whole particle array
              from device memory per setting).
            * ``"kernel"``: the settings-amortized moment sweep over the
              shared cloud (``ops/sweep.sweep_particle_moments``), which
              keeps per-particle fidelity through interleaved apertures.
            * ``"particles"``: push every particle for every setting (the
              fidelity path required by per-particle observables —
              apertures, particle-histogram screens, nonlinear elements).
        """
        tuned = self._batched_tuned_segment(magnets)
        if method == "auto":
            from lynx_tpu.functional import moment_sufficient

            method = (
                "moments" if moment_sufficient(tuned, beam) else "particles"
            )
        if method == "moments":
            outgoing, _ = track(tuned, beam.as_parameter_beam())
        elif method == "kernel":
            return self._kernel_particle_beam_parameters(magnets, tuned, beam)
        elif method == "particles":
            outgoing, _ = track(tuned, beam)
        else:
            raise ValueError(
                f"unknown method {method!r}"
                " (auto | moments | kernel | particles)"
            )
        return jnp.stack(
            [outgoing.mu_x, outgoing.sigma_x, outgoing.mu_y, outgoing.sigma_y],
            axis=-1,
        )

    def _kernel_particle_beam_parameters(
        self,
        magnets: Array,
        tuned: "lt.Segment",
        beam: "lt.ParticleBeam",
    ) -> Array:
        """Particle-fidelity observation through the settings-amortized
        moment sweep (``ops/sweep.sweep_particle_moments``): the shared
        cloud is walked once per setting and only the 36 moment sums per
        setting leave the walk.  Supports interleaved active apertures
        (per-particle survival that no moment algebra can express)."""
        from lynx_tpu.accelerator.fused import particle_moment_plan
        from lynx_tpu.ops.sweep import sweep_particle_moments

        B = magnets.shape[0]
        plan = particle_moment_plan(
            tuned.flattened().elements,
            # Pin to the beam's dtype: self.energy is a Python float and
            # would otherwise promote the whole sweep to f64 under x64.
            jnp.asarray(self.energy, beam.particles.dtype),
            lambda x: jnp.broadcast_to(jnp.reshape(jnp.asarray(x), (-1,)), (B,)),
        )
        if plan is None:
            raise ValueError(
                "kernel method requires an affine-plus-apertures lattice"
            )
        particles = beam.particles
        if particles.ndim == 3 and particles.shape[0] == 1:
            particles = particles[0]
        if particles.ndim != 2:
            raise ValueError(
                "kernel method requires one shared (unbatched) beam"
            )
        weights = (
            jnp.ones(particles.shape[:1], particles.dtype)
            if beam.survival is None
            else jnp.reshape(beam.survival, particles.shape[:1])
        )
        entries, scalars = plan
        mu, cov, _ = sweep_particle_moments(
            entries, scalars, particles, weights, batch_size=B
        )
        return jnp.stack(
            [
                mu[:, 0],
                jnp.sqrt(cov[:, 0, 0]),
                mu[:, 2],
                jnp.sqrt(cov[:, 2, 2]),
            ],
            axis=-1,
        )

    def batched_step(
        self, states: EnvState, actions: Array, params: EnvParams
    ) -> Tuple[Array, EnvState, Array, Array]:
        """Vectorized :meth:`step` over ``(B, ...)`` states/actions/params —
        the high-throughput path for RL training loops (avoid ``vmap`` here;
        see :meth:`batched_beam_parameters`)."""
        magnets = jnp.clip(actions, -1.0, 1.0)
        next_states = EnvState(
            magnets=magnets,
            step_count=states.step_count + 1,
            key=states.key,
        )
        beam = self.batched_beam_parameters(magnets, params)
        rewards = -jnp.sum(jnp.abs(beam - params.target), axis=-1) * 1e3
        dones = next_states.step_count >= params.max_steps
        obs = jnp.concatenate(
            [magnets, beam * 1e3, params.target * 1e3], axis=-1
        )
        if self.log_metrics:
            from lynx_tpu.metrics import emit_metrics

            emit_metrics(
                {
                    "mu_x": jnp.mean(beam[..., 0]),
                    "sigma_x": jnp.mean(beam[..., 1]),
                    "mu_y": jnp.mean(beam[..., 2]),
                    "sigma_y": jnp.mean(beam[..., 3]),
                    "reward": jnp.mean(rewards),
                },
                step=next_states.step_count,
            )
        return obs, next_states, rewards, dones

    def batched_reset(
        self, keys: Array, params: EnvParams
    ) -> Tuple[Array, EnvState]:
        """Vectorized :meth:`reset` over ``(B, ...)`` keys/params."""
        B = keys.shape[0]
        split = jax.vmap(jax.random.split)(keys)
        next_keys, magnet_keys = split[:, 0], split[:, 1]
        magnets = jax.vmap(
            lambda k: jax.random.uniform(
                k, (self.num_actions,), minval=-0.5, maxval=0.5
            )
        )(magnet_keys)
        states = EnvState(
            magnets=magnets,
            step_count=jnp.zeros((B,), jnp.int32),
            key=next_keys,
        )
        beam = self.batched_beam_parameters(magnets, params)
        obs = jnp.concatenate(
            [magnets, beam * 1e3, params.target * 1e3], axis=-1
        )
        return obs, states

    # -- env API -----------------------------------------------------------
    def observation(self, state: EnvState, params: EnvParams) -> Array:
        beam = self.beam_parameters(state.magnets, params)
        return jnp.concatenate([state.magnets, beam * 1e3, params.target * 1e3])

    def reset(self, key: Array, params: EnvParams) -> Tuple[Array, EnvState]:
        key, k_magnets = jax.random.split(key)
        magnets = jax.random.uniform(
            k_magnets, (self.num_actions,), minval=-0.5, maxval=0.5
        )
        state = EnvState(
            magnets=magnets, step_count=jnp.zeros((), jnp.int32), key=key
        )
        return self.observation(state, params), state

    def step(
        self, state: EnvState, action: Array, params: EnvParams
    ) -> Tuple[Array, EnvState, Array, Array]:
        """Apply a (clipped) absolute magnet setting; return
        (obs, next_state, reward, done)."""
        magnets = jnp.clip(action, -1.0, 1.0)
        next_state = EnvState(
            magnets=magnets,
            step_count=state.step_count + 1,
            key=state.key,
        )
        beam = self.beam_parameters(magnets, params)
        reward = -jnp.sum(jnp.abs(beam - params.target)) * 1e3
        done = next_state.step_count >= params.max_steps
        obs = jnp.concatenate([magnets, beam * 1e3, params.target * 1e3])
        if self.log_metrics:
            from lynx_tpu.metrics import emit_metrics

            emit_metrics(
                {
                    "mu_x": beam[0],
                    "sigma_x": beam[1],
                    "mu_y": beam[2],
                    "sigma_y": beam[3],
                    "reward": reward,
                },
                step=next_state.step_count,
            )
        return obs, next_state, reward, done


def make_env(log_metrics: bool = False) -> AresEATransverseTuning:
    return AresEATransverseTuning(log_metrics=log_metrics)


try:  # pragma: no cover - optional dependency adapter
    import gymnasium
    import numpy as np

    class AresEAGymEnv(gymnasium.Env):
        """Gymnasium adapter around the functional environment."""

        metadata = {"render_modes": []}

        def __init__(self, params: Optional[EnvParams] = None, seed: int = 0):
            self._env = make_env()
            self._params = params if params is not None else default_params()
            self._key = jax.random.PRNGKey(seed)
            self._step = jax.jit(self._env.step)
            self._reset = jax.jit(self._env.reset)
            self.action_space = gymnasium.spaces.Box(
                low=-1.0, high=1.0, shape=(self._env.num_actions,)
            )
            self.observation_space = gymnasium.spaces.Box(
                low=-np.inf, high=np.inf, shape=(self._env.obs_size,)
            )

        def reset(self, *, seed=None, options=None):
            if seed is not None:
                self._key = jax.random.PRNGKey(seed)
            self._key, sub = jax.random.split(self._key)
            obs, self._state = self._reset(sub, self._params)
            return np.asarray(obs), {}

        def step(self, action):
            obs, self._state, reward, done = self._step(
                self._state, jnp.asarray(action), self._params
            )
            return np.asarray(obs), float(reward), bool(done), False, {}

except ImportError:  # pragma: no cover
    pass
