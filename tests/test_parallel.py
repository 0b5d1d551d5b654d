"""Multi-device sharding tests on the 8-virtual-device CPU mesh
(the virtual-device fake backend; SURVEY.md §4 implication (d))."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

import lynx_tpu as lt
from lynx_tpu.functional import track
from lynx_tpu.models import ares_ea_segment
from lynx_tpu.parallel import (
    make_mesh,
    make_tuning_train_step,
    shard_beam,
    shard_segment,
)

pytestmark = [
    pytest.mark.slow,
    pytest.mark.skipif(
        len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
    ),
]


def _flagship(batch, num_particles):
    segment = ares_ea_segment().broadcast((batch,))
    segment.AREABSCR1.is_active = False
    segment.AREAMQZM1.k1 = jnp.linspace(-5, 5, batch)
    beam = lt.ParticleBeam.from_parameters(
        num_particles=num_particles,
        sigma_x=jnp.full((batch,), 1.75e-4),
        energy=jnp.full((batch,), 1.073e8),
        key=jax.random.PRNGKey(0),
    )
    return segment, beam


def test_mesh_shapes():
    mesh = make_mesh(8)
    assert mesh.shape["batch"] * mesh.shape["particles"] == 8


def test_sharded_track_matches_single_device():
    mesh = make_mesh(8)
    segment, beam = _flagship(batch=4, num_particles=64 * mesh.shape["particles"])
    expected, _ = track(segment, beam)

    with mesh:
        sharded_segment = shard_segment(segment, mesh)
        sharded_beam = shard_beam(beam, mesh)
        out, _ = jax.jit(track)(sharded_segment, sharded_beam)

    np.testing.assert_allclose(
        np.asarray(out.sigma_x), np.asarray(expected.sigma_x), rtol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(out.particles), np.asarray(expected.particles), rtol=1e-5,
        atol=1e-10,
    )


def test_sharded_train_step_runs_and_improves():
    mesh = make_mesh(8)
    segment, beam = _flagship(batch=4, num_particles=64 * mesh.shape["particles"])
    target = jnp.full((4,), 5e-5)

    def loss_fn(seg, beam):
        out, _ = track(seg, beam)
        return jnp.mean((out.sigma_x - target) ** 2 + (out.sigma_y - target) ** 2)

    optimizer = optax.adam(1e-1)
    with mesh:
        segment = shard_segment(segment, mesh)
        beam = shard_beam(beam, mesh)
        opt_state = optimizer.init(segment)
        train_step = make_tuning_train_step(optimizer, loss_fn)
        first_loss = None
        for _ in range(10):
            segment, opt_state, loss = train_step(segment, opt_state, beam)
            if first_loss is None:
                first_loss = float(loss)
    assert np.isfinite(float(loss))
    assert float(loss) < first_loss


def test_particle_axis_sharding_preserves_moments():
    """Moments of a particle-sharded beam match the unsharded values (the
    psum over the particle axis is inserted by XLA)."""
    mesh = make_mesh(8, batch=1, particles=8)
    segment, beam = _flagship(batch=1, num_particles=8 * 128)
    with mesh:
        sharded = shard_beam(beam, mesh)
        sigma = jax.jit(lambda b: b.sigma_x)(sharded)
    np.testing.assert_allclose(
        np.asarray(sigma), np.asarray(beam.sigma_x), rtol=1e-6
    )


def test_sharded_screen_reading_matches_single_device():
    """An active screen's histogram over a particle-axis-sharded beam equals
    the unsharded reading (XLA reduces the per-shard partial histograms
    across the mesh — SURVEY §2.4's cross-device beam-stats collective)."""
    mesh = make_mesh(8, batch=1, particles=8)
    segment = ares_ea_segment()
    segment.AREABSCR1.is_active = True
    beam = lt.ParticleBeam.from_parameters(
        num_particles=8 * 1024,
        sigma_x=jnp.array(1.75e-4),
        sigma_y=jnp.array(1.75e-4),
        energy=jnp.array(1.073e8),
        key=jax.random.PRNGKey(5),
    )
    _, expected = jax.jit(track)(segment, beam)

    with mesh:
        sharded_beam = shard_beam(beam, mesh)
        _, diagnostics = jax.jit(track)(segment, sharded_beam)

    np.testing.assert_allclose(
        np.asarray(diagnostics["AREABSCR1"]),
        np.asarray(expected["AREABSCR1"]),
        rtol=1e-6,
        atol=1e-6,
    )
    assert float(np.asarray(diagnostics["AREABSCR1"]).sum()) > 0


def test_batched_env_shards_over_batch_axis():
    """Data-parallel RL: the natively-batched env steps under a mesh with all
    (B, ...) inputs sharded on the batch axis, matching unsharded results —
    the multi-chip scaling mode for PPO training (no collectives needed;
    each device tracks its own env shard)."""
    from lynx_tpu.envs import make_env
    from lynx_tpu.envs.ares_ea import default_params

    env = make_env()
    n = 16
    params = jax.vmap(default_params)(jax.random.split(jax.random.PRNGKey(1), n))
    keys = jax.random.split(jax.random.PRNGKey(0), n)
    obs, states = env.batched_reset(keys, params)
    actions = jnp.tanh(jax.random.normal(jax.random.PRNGKey(2), (n, env.num_actions)))
    obs_ref, _, rew_ref, _ = env.batched_step(states, actions, params)

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("batch",))
    spec = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("batch"))
    shard = lambda tree: jax.tree.map(lambda x: jax.device_put(x, spec), tree)

    with mesh:
        obs_s, _, rew_s, _ = jax.jit(env.batched_step)(
            shard(states), shard(actions), shard(params)
        )

    # Outputs stay sharded over the batch axis (no implicit gather).
    assert obs_s.sharding.is_equivalent_to(spec, obs_s.ndim)
    np.testing.assert_allclose(np.asarray(obs_s), np.asarray(obs_ref), rtol=1e-5)
    np.testing.assert_allclose(np.asarray(rew_s), np.asarray(rew_ref), rtol=1e-5)


def test_sharded_ppo_update_runs_and_matches():
    """Full PPO update (rollout scan + GAE + Adam) with env state sharded
    over the batch axis — the single-program multi-chip RL training mode
    (BASELINE.md: env instances sharded over hosts feeding a sharded
    learner).  The policy is replicated; XLA inserts the gradient
    reductions."""
    import pathlib
    import sys

    sys.path.insert(
        0, str(pathlib.Path(__file__).parent.parent / "examples")
    )
    import optax
    from ppo_ares_ea import MLPPolicy, make_collect_and_update

    from lynx_tpu.envs import make_env
    from lynx_tpu.envs.ares_ea import default_params

    env = make_env()
    n = 16
    env_params = jax.vmap(default_params)(
        jax.random.split(jax.random.PRNGKey(1), n)
    )
    policy = MLPPolicy.init(jax.random.PRNGKey(2), env.obs_size, env.num_actions)
    optimizer = optax.adam(3e-4)
    opt_state = optimizer.init(policy)
    obs, states = env.batched_reset(
        jax.random.split(jax.random.PRNGKey(0), n), env_params
    )
    step = make_collect_and_update(env, env_params, optimizer, rollout=4)

    key = jax.random.PRNGKey(3)
    _, _, _, _, _, loss_ref, reward_ref = step(
        policy, opt_state, obs, states, key
    )

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("batch",))
    batch_spec = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec("batch")
    )
    shard = lambda tree: jax.tree.map(
        lambda x: jax.device_put(x, batch_spec), tree
    )
    with mesh:
        policy_s, opt_s, obs_s, states_s, _, loss_s, reward_s = step(
            policy, opt_state, shard(obs), shard(states), key
        )
        jax.block_until_ready(loss_s)

    # Next obs stays sharded; scalars match the unsharded update.
    assert obs_s.sharding.is_equivalent_to(batch_spec, obs_s.ndim)
    np.testing.assert_allclose(float(loss_s), float(loss_ref), rtol=1e-4)
    np.testing.assert_allclose(float(reward_s), float(reward_ref), rtol=1e-4)
    assert all(
        bool(jnp.all(jnp.isfinite(leaf)))
        for leaf in jax.tree.leaves(policy_s)
    )


def test_moment_sweep_shards_over_settings():
    """Multi-chip mode of the particle-fidelity moment sweep: the SETTING
    axis shards over the mesh via shard_map (each device walks its local
    slab of settings against the replicated cloud — no collectives),
    matching the unsharded sweep."""
    import functools

    from lynx_tpu.accelerator.fused import particle_moment_plan
    from lynx_tpu.ops.sweep import sweep_particle_moments

    B, N = 128, 1500  # 16 settings per device
    beam = lt.ParticleBeam.from_parameters(
        num_particles=N,
        sigma_x=jnp.array([1.75e-4]),
        sigma_y=jnp.array([1.75e-4]),
        energy=jnp.array([1.073e8]),
        key=jax.random.PRNGKey(0),
        dtype=jnp.float32,
    )
    elements = [
        lt.Drift(jnp.array([0.3])),
        lt.Quadrupole(jnp.array([0.12]), k1=jnp.linspace(-8.0, 8.0, B)),
        lt.Aperture(
            x_max=jnp.array([3e-4]), y_max=jnp.array([4e-4]), is_active=True
        ),
        lt.Drift(jnp.array([0.4])),
    ]
    entries, scalars = particle_moment_plan(
        elements,
        beam.energy,
        lambda x: jnp.broadcast_to(jnp.reshape(jnp.asarray(x), (-1,)), (B,)),
    )
    particles = beam.particles[0]
    weights = jnp.ones((N,), jnp.float32)

    mu_ref, cov_ref, w_ref = sweep_particle_moments(
        entries, scalars, particles, weights
    )

    mesh = jax.sharding.Mesh(np.array(jax.devices()[:8]), ("settings",))
    pspec = jax.sharding.PartitionSpec("settings")
    rep = jax.sharding.PartitionSpec()

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(tuple(pspec for _ in scalars), rep, rep),
        out_specs=(pspec, pspec, pspec),
        check_vma=False,
    )
    def sharded_sweep(scalars, particles, weights):
        return sweep_particle_moments(entries, scalars, particles, weights)

    mu_s, cov_s, w_s = jax.jit(sharded_sweep)(
        tuple(scalars), particles, weights
    )
    np.testing.assert_allclose(np.asarray(w_s), np.asarray(w_ref), rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(mu_s), np.asarray(mu_ref), rtol=1e-5, atol=1e-9
    )
    np.testing.assert_allclose(
        np.asarray(cov_s), np.asarray(cov_ref), rtol=1e-4, atol=1e-12
    )
