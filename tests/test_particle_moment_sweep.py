"""Settings-amortized particle moment sweep: one shared cloud, B settings
(``ops/sweep.sweep_particle_moments``).

Pins the plain walk against dense broadcast tracking — including
interleaved ACTIVE apertures, the case no moment algebra can express —
its gradients against gradients through dense tracking, and its f32
results against its f64 results.  Reference workload contract:
BASELINE.md:27 / the reference's (3, 100_000)-settings sweep
(``tests/test_vectorized.py:298-321``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import lynx_tpu as lt
from lynx_tpu.accelerator.fused import particle_moment_plan
from lynx_tpu.functional import track
from lynx_tpu.ops.sweep import (
    moment_sums,
    particle_moments_from_sums,
    sweep_particle_moments,
)


def _beam(n=3000, dtype=jnp.float64):
    return lt.ParticleBeam.from_parameters(
        num_particles=n,
        mu_x=jnp.array([2e-5]),
        sigma_x=jnp.array([1.75e-4]),
        sigma_y=jnp.array([1.75e-4]),
        sigma_p=jnp.array([2e-3]),
        energy=jnp.array([1.073e8]),
        key=jax.random.PRNGKey(0),
        dtype=dtype,
    )


def _elements(B, with_aperture, dtype=jnp.float64):
    k1 = jnp.linspace(-8.0, 8.0, B, dtype=dtype)
    first = [
        lt.Drift(jnp.asarray([0.3], dtype), dtype=dtype),
        lt.Quadrupole(jnp.asarray([0.12], dtype), k1=k1, dtype=dtype),
        lt.HorizontalCorrector(
            jnp.asarray([0.02], dtype),
            angle=jnp.asarray([1e-3], dtype),
            dtype=dtype,
        ),
    ]
    rest = [
        lt.Drift(jnp.asarray([0.4], dtype), dtype=dtype),
        lt.Quadrupole(
            jnp.asarray([0.12], dtype),
            k1=jnp.full((B,), 3.0, dtype),
            dtype=dtype,
        ),
        lt.Drift(jnp.asarray([0.2], dtype), dtype=dtype),
    ]
    if with_aperture:
        aperture = [
            lt.Aperture(
                x_max=jnp.asarray([2e-4], dtype),
                y_max=jnp.asarray([3e-4], dtype),
                shape="rectangular",
                is_active=True,
                dtype=dtype,
            )
        ]
    else:
        aperture = []
    return first + aperture + rest


def _sweep(elements, beam, B):
    plan = particle_moment_plan(
        elements,
        beam.energy,
        lambda x: jnp.broadcast_to(jnp.reshape(jnp.asarray(x), (-1,)), (B,)),
    )
    assert plan is not None
    entries, scalars = plan
    particles = beam.particles[0]
    weights = jnp.ones(particles.shape[:1], particles.dtype)
    mu, cov, w_sum = sweep_particle_moments(
        entries, scalars, particles, weights
    )
    return (mu, cov), w_sum


def _dense_reference(elements, beam, B):
    outgoing, _ = track(lt.Segment(elements), beam.broadcast((B,)))
    return outgoing


@pytest.mark.parametrize("with_aperture", [False, True])
def test_sweep_matches_dense_tracking(with_aperture):
    B = 6
    beam = _beam()
    elements = _elements(B, with_aperture)
    (mu, cov), w_sum = _sweep(elements, beam, B)
    reference = _dense_reference(elements, beam, B)

    np.testing.assert_allclose(
        np.asarray(w_sum),
        np.asarray(reference.num_particles_survived),
        rtol=1e-12,
    )
    if with_aperture:
        assert float(w_sum.min()) < beam.num_particles  # losses happened
        assert float(w_sum.min()) > 0
    for stat, value in [
        ("mu_x", mu[:, 0]),
        ("mu_y", mu[:, 2]),
        ("sigma_x", jnp.sqrt(cov[:, 0, 0])),
        ("sigma_y", jnp.sqrt(cov[:, 2, 2])),
        ("sigma_p", jnp.sqrt(cov[:, 5, 5])),
    ]:
        np.testing.assert_allclose(
            np.asarray(value),
            np.asarray(getattr(reference, stat)),
            rtol=1e-9,
            atol=1e-18,
            err_msg=stat,
        )


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
def test_env_kernel_method_matches_particles(dtype):
    from lynx_tpu.envs import make_env

    env = make_env()
    beam = _beam(n=4000, dtype=dtype)
    magnets = jax.random.uniform(
        jax.random.PRNGKey(2), (6, env.num_actions), minval=-0.5, maxval=0.5,
        dtype=dtype,
    )
    kernel = env.batched_particle_beam_parameters(
        magnets, beam, method="kernel"
    )
    dense = env.batched_particle_beam_parameters(
        magnets, beam, method="particles"
    )
    np.testing.assert_allclose(
        np.asarray(kernel), np.asarray(dense), rtol=3e-3, atol=1e-9
    )


def test_plan_rejects_active_screen():
    B = 3
    elements = [
        lt.Drift(jnp.array([0.3])),
        lt.Screen(is_active=True),
    ]
    plan = particle_moment_plan(
        elements,
        jnp.array([1e8]),
        lambda x: jnp.broadcast_to(jnp.reshape(jnp.asarray(x), (-1,)), (B,)),
    )
    assert plan is None


def test_identity_only_plan_requires_batch_size():
    """A plan with no per-setting scalars carries no settings axis: the
    sweep must demand batch_size= instead of silently shaping output by
    the PARTICLE count (review r5)."""
    beam = _beam(n=300, dtype=jnp.float32)
    particles = beam.particles[0]
    weights = jnp.ones(particles.shape[:1], particles.dtype)
    identity_layout = tuple(
        tuple(1.0 if i == j else 0.0 for j in range(7)) for i in range(7)
    )
    entries = (("map", identity_layout),)

    with pytest.raises(ValueError, match="batch_size"):
        sweep_particle_moments(entries, (), particles, weights)

    B = 5
    mu, cov, w = sweep_particle_moments(
        entries, (), particles, weights, batch_size=B
    )
    assert mu.shape == (B, 7) and cov.shape == (B, 7, 7) and w.shape == (B,)
    np.testing.assert_allclose(np.asarray(w), 300.0, rtol=1e-6)
    np.testing.assert_allclose(
        np.asarray(mu[0]),
        np.asarray(mu[1]),
        rtol=1e-7,
        err_msg="identity plan must give identical rows",
    )


@pytest.mark.parametrize(
    "shapes",
    [
        ("rectangular", "rectangular"),
        ("rectangular", "elliptical"),
        ("elliptical", "elliptical"),
    ],
)
def test_multiple_apertures_match_dense_tracking(shapes):
    """Two apertures with distinct prefix maps: each mask must evaluate at
    its own plane, not at the final coordinates."""
    B = 7
    beam = _beam(n=2000)
    elements = [
        lt.Drift(jnp.array([0.2], jnp.float64), dtype=jnp.float64),
        lt.Aperture(
            x_max=jnp.array([2.5e-4]), y_max=jnp.array([2.5e-4]),
            shape=shapes[0], is_active=True, dtype=jnp.float64,
        ),
        lt.Quadrupole(
            jnp.array([0.12]), k1=jnp.linspace(-6, 6, B), dtype=jnp.float64
        ),
        lt.Drift(jnp.array([0.5]), dtype=jnp.float64),
        lt.Aperture(
            x_max=jnp.array([2e-4]), y_max=jnp.array([5e-4]),
            shape=shapes[1], is_active=True, dtype=jnp.float64,
        ),
        lt.Drift(jnp.array([0.1]), dtype=jnp.float64),
    ]
    (mu, cov), w_sum = _sweep(elements, beam, B)
    assert sum(e[0] == "aperture" for e in particle_moment_plan(
        elements, beam.energy,
        lambda x: jnp.broadcast_to(jnp.reshape(jnp.asarray(x), (-1,)), (B,)),
    )[0]) == 2
    dense = _dense_reference(elements, beam, B)
    np.testing.assert_allclose(
        np.asarray(w_sum), np.asarray(dense.num_particles_survived),
        rtol=1e-12,
    )
    assert float(jnp.min(w_sum)) < 2000
    np.testing.assert_allclose(
        np.asarray(jnp.sqrt(cov[:, 0, 0])), np.asarray(dense.sigma_x),
        rtol=1e-9,
    )
    np.testing.assert_allclose(
        np.asarray(mu[:, 2]), np.asarray(dense.mu_y), rtol=1e-9, atol=1e-18
    )


@pytest.mark.parametrize("with_aperture", [False, True])
def test_sweep_gradients_match_dense_tracking(with_aperture):
    """d(sum of sigma_x^2 + mu_x^2)/d k1 through the sweep equals the
    gradient through dense broadcast tracking."""
    B = 5
    beam = _beam(n=1500)
    k1 = jnp.linspace(-8.0, 8.0, B)

    def elements_of(k1):
        elements = _elements(B, with_aperture)
        elements[1] = elements[1].replace(k1=k1)
        return elements

    def sweep_loss(k1):
        (mu, cov), _ = _sweep(elements_of(k1), beam, B)
        return jnp.sum(cov[:, 0, 0]) + jnp.sum(mu[:, 0] ** 2)

    def dense_loss(k1):
        out = _dense_reference(elements_of(k1), beam, B)
        return jnp.sum(out.sigma_x**2) + jnp.sum(out.mu_x**2)

    grad = jax.grad(sweep_loss)(k1)
    expected = jax.grad(dense_loss)(k1)
    assert float(jnp.max(jnp.abs(expected))) > 0
    np.testing.assert_allclose(
        np.asarray(grad), np.asarray(expected), rtol=1e-7,
        atol=1e-7 * float(jnp.max(jnp.abs(expected))),
    )


@pytest.mark.parametrize("offset", [0.0, 6e-4])
def test_f32_sweep_matches_f64(offset):
    """The shifted-moments walk keeps f32 spot sizes within 1e-5 of f64
    even when the beam sits far off axis relative to its size."""
    B = 6
    results = {}
    for dtype in (jnp.float32, jnp.float64):
        beam = lt.ParticleBeam.from_parameters(
            num_particles=3000,
            mu_x=jnp.array([offset]),
            sigma_x=jnp.array([1.75e-5]),
            sigma_y=jnp.array([1.75e-4]),
            energy=jnp.array([1.073e8]),
            key=jax.random.PRNGKey(0),
            dtype=jnp.float64,
        )
        beam = lt.ParticleBeam(
            beam.particles.astype(jnp.float32).astype(dtype),
            beam.energy.astype(dtype),
        )
        (mu, cov), _ = _sweep(_elements(B, True, dtype=dtype), beam, B)
        results[dtype] = (np.asarray(mu), np.sqrt(np.asarray(cov[:, 0, 0])))
    np.testing.assert_allclose(
        results[jnp.float32][1], results[jnp.float64][1], rtol=1e-5
    )
    np.testing.assert_allclose(
        results[jnp.float32][0][:, 0], results[jnp.float64][0][:, 0],
        rtol=1e-5, atol=1e-5 * 1.75e-5,
    )


@pytest.mark.parametrize("shape", ["rectangular", "elliptical"])
def test_moment_sums_match_numpy(shape):
    """The raw walk: one identity-plus-scalar map, one aperture, weighted
    sums over the surviving particles."""
    rng = np.random.default_rng(3)
    n, B = 400, 3
    particles = rng.normal(0, 1e-3, (n, 7))
    particles[:, 6] = 1.0
    weights = rng.uniform(0.5, 1.0, n)
    scale = np.array([1.0, 2.0, 0.5])
    layout = [[1.0 if i == j else 0.0 for j in range(7)] for i in range(7)]
    layout[0][0] = 0  # x -> scale_b * x
    half = np.array([1e-3, 2e-3, 5e-4])
    zero = np.zeros(B)
    entries = (("map", layout), ("aperture", 1, 1, 2, 2, shape))
    scalars = tuple(jnp.asarray(v) for v in (scale, half, zero))
    s1, s2, w_sum = moment_sums(
        entries, scalars, jnp.asarray(particles), jnp.asarray(weights)
    )
    for b in range(B):
        coords = particles.copy()
        coords[:, 0] *= scale[b]
        xs, ys = coords[:, 0], coords[:, 2]
        if shape == "rectangular":
            alive = (np.abs(xs) < half[b]) & (np.abs(ys) < half[b])
        else:
            alive = xs**2 / half[b] ** 2 + ys**2 / half[b] ** 2 <= 1.0
        w = weights * alive
        np.testing.assert_allclose(float(w_sum[b]), w.sum(), rtol=1e-12)
        np.testing.assert_allclose(
            np.asarray(s1[b]), (w[:, None] * coords).sum(0), rtol=1e-10,
            atol=1e-16,
        )
        np.testing.assert_allclose(
            np.asarray(s2[b]), (w[:, None] * coords).T @ coords, rtol=1e-10,
            atol=1e-16,
        )
    mu, cov = particle_moments_from_sums(s1, s2, w_sum)
    assert mu.shape == (B, 7) and cov.shape == (B, 7, 7)
