"""The screen histogram (``ops/histogram.weighted_histogram_2d``) against
``numpy.histogram2d`` in float64: weights, dead and out-of-range
particles, batch dimensions, camera orientation, mass, the weight VJP, and
the f32 bin-edge precision."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lynx_tpu.accelerator.screen import screen_reading_particle
from lynx_tpu.ops.histogram import weighted_histogram_2d

X_RANGE = (-3e-3, 3e-3)
Y_RANGE = (-2e-3, 2.5e-3)


def _cloud(seed, n=4000, batch=()):
    rng = np.random.default_rng(seed)
    x = rng.normal(2e-4, 8e-4, (*batch, n))
    y = rng.normal(-1e-4, 6e-4, (*batch, n))
    return x, y


def _numpy_hist(x, y, w, bins, x_range=X_RANGE, y_range=Y_RANGE):
    hist, _, _ = np.histogram2d(
        np.asarray(x, np.float64),
        np.asarray(y, np.float64),
        bins=bins,
        range=(x_range, y_range),
        weights=np.asarray(w, np.float64),
    )
    return hist


def _hist(x, y, w, bins, x_range=X_RANGE, y_range=Y_RANGE):
    return np.asarray(
        weighted_histogram_2d(
            jnp.asarray(x), jnp.asarray(y), jnp.asarray(w), x_range, y_range,
            bins,
        )
    )


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("bins", [(64, 48), (65, 47), (200, 1)])
def test_fractional_weights_match_numpy(seed, bins):
    x, y = _cloud(seed)
    w = np.random.default_rng(10 + seed).uniform(0.0, 2.0, x.shape)
    np.testing.assert_allclose(
        _hist(x, y, w, bins), _numpy_hist(x, y, w, bins), rtol=1e-12,
        atol=1e-12,
    )


@pytest.mark.parametrize("outside", ["x_low", "x_high", "y_low", "y_high"])
def test_dead_and_out_of_range_particles_dropped(outside):
    x, y = _cloud(3, n=500)
    w = np.ones_like(x)
    w[:50] = 0.0  # dead particles
    target = {"x_low": (x, -1.0), "x_high": (x, 1.0),
              "y_low": (y, -1.0), "y_high": (y, 1.0)}[outside]
    target[0][50:80] = target[1]  # far outside the image
    hist = _hist(x, y, w, (32, 32))
    np.testing.assert_allclose(hist, _numpy_hist(x, y, w, (32, 32)))
    assert hist.sum() == pytest.approx(w[80:].sum() - np.sum(
        (x[80:] < X_RANGE[0]) | (x[80:] > X_RANGE[1])
        | (y[80:] < Y_RANGE[0]) | (y[80:] > Y_RANGE[1])
    ))


def test_edges_follow_numpy_semantics():
    """Interior edges fall into the right bin; the last edge is closed."""
    edges_x = np.linspace(*X_RANGE, 5)
    edges_y = np.linspace(*Y_RANGE, 4)
    x = np.concatenate([edges_x, edges_x])
    y = np.concatenate([np.full(5, edges_y[1]), np.full(5, edges_y[-1])])
    w = np.ones_like(x)
    np.testing.assert_array_equal(
        _hist(x, y, w, (4, 3)), _numpy_hist(x, y, w, (4, 3))
    )


@pytest.mark.parametrize("batch", [(3,), (2, 2)])
def test_batched_input_matches_per_row(batch):
    x, y = _cloud(4, n=700, batch=batch)
    w = np.random.default_rng(5).uniform(0, 1, x.shape)
    hist = _hist(x, y, w, (40, 30))
    assert hist.shape == (*batch, 40, 30)
    for index in np.ndindex(*batch):
        np.testing.assert_allclose(
            hist[index],
            _numpy_hist(x[index], y[index], w[index], (40, 30)),
            rtol=1e-12,
            atol=1e-12,
        )


def test_batch_dims_on_y_only():
    """An unbatched x broadcasts against a batched y."""
    x, _ = _cloud(6, n=600)
    _, y = _cloud(7, n=600, batch=(3,))
    hist = np.asarray(
        weighted_histogram_2d(
            jnp.asarray(x), jnp.asarray(y), jnp.ones(600), X_RANGE, Y_RANGE,
            (20, 20),
        )
    )
    assert hist.shape == (3, 20, 20)
    for row in range(3):
        np.testing.assert_array_equal(
            hist[row], _numpy_hist(x, y[row], np.ones(600), (20, 20))
        )


@pytest.mark.parametrize("binning", [1, 4])
def test_screen_reading_is_camera_oriented(binning):
    """Rows of the screen image are -y bins, columns x bins."""
    import lynx_tpu as lt

    rng = np.random.default_rng(8)
    particles = np.zeros((1, 3000, 7))
    particles[..., 0] = rng.normal(3e-4, 4e-4, 3000)
    particles[..., 2] = rng.normal(-5e-4, 2e-4, 3000)
    particles[..., 6] = 1.0
    beam = lt.ParticleBeam(jnp.asarray(particles), jnp.array([1e8]))
    resolution = (96, 64)
    pixel = np.array([2e-5, 3e-5])
    image = np.asarray(
        screen_reading_particle(
            beam, resolution, jnp.asarray(pixel), binning, dtype=jnp.float64
        )
    )
    half_w, half_h = resolution[0] * pixel[0] / 2, resolution[1] * pixel[1] / 2
    expected = _numpy_hist(
        -particles[0, :, 2], particles[0, :, 0], np.ones(3000),
        (resolution[1] // binning, resolution[0] // binning),
        (-half_h, half_h), (-half_w, half_w),
    )
    np.testing.assert_array_equal(image[0], expected)
    # The spot sits right of center (x > 0) and below it (y < 0 -> rows
    # past the middle).
    rows, cols = np.nonzero(image[0])
    assert np.average(cols, weights=image[0][rows, cols]) > image.shape[-1] / 2
    assert np.average(rows, weights=image[0][rows, cols]) > image.shape[-2] / 2


@pytest.mark.parametrize("seed", [0, 1])
def test_mass_is_conserved(seed):
    x, y = _cloud(seed, n=5000)
    w = np.random.default_rng(seed).uniform(0, 1, x.shape)
    inside = (
        (x >= X_RANGE[0]) & (x <= X_RANGE[1])
        & (y >= Y_RANGE[0]) & (y <= Y_RANGE[1])
    )
    assert _hist(x, y, w, (50, 50)).sum() == pytest.approx(w[inside].sum())


def test_weight_vjp_gathers_the_cotangent():
    """d sum(hist * c) / d w_n = c[bin(n)] for in-range particles, 0 for
    out-of-range ones."""
    x, y = _cloud(9, n=300)
    x[:10] = 1.0  # out of range
    bins = (16, 12)
    cot = np.random.default_rng(1).normal(size=bins)
    grad = np.asarray(
        jax.grad(
            lambda w: jnp.sum(
                weighted_histogram_2d(
                    jnp.asarray(x), jnp.asarray(y), w, X_RANGE, Y_RANGE, bins
                )
                * cot
            )
        )(jnp.ones(300))
    )
    ix = np.clip(
        np.floor((x - X_RANGE[0]) / (X_RANGE[1] - X_RANGE[0]) * bins[0]),
        0, bins[0] - 1,
    ).astype(int)
    iy = np.clip(
        np.floor((y - Y_RANGE[0]) / (Y_RANGE[1] - Y_RANGE[0]) * bins[1]),
        0, bins[1] - 1,
    ).astype(int)
    expected = np.where(np.arange(300) < 10, 0.0, cot[ix, iy])
    np.testing.assert_allclose(grad, expected, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("seed", [0, 1])
def test_f32_bins_agree_with_f64_on_a_full_screen(seed):
    """On the 2040x2448 ARES screen, an f32 histogram of f32 coordinates
    puts at most 1e-4 of a centered beam's particles in another bin than
    the f64 histogram of the same coordinates (bin indices counted from
    the range's center)."""
    rng = np.random.default_rng(seed)
    n = 100_000
    x = rng.normal(3e-4, 2e-4, n).astype(np.float32)
    y = rng.normal(-2e-4, 8e-4, n).astype(np.float32)
    half_x = np.float32(2448 * 3.5488e-6 / 2)
    half_y = np.float32(2040 * 2.5003e-6 / 2)
    image = np.asarray(
        weighted_histogram_2d(
            jnp.asarray(-y), jnp.asarray(x), jnp.ones(n, jnp.float32),
            (-half_y, half_y), (-half_x, half_x), (2040, 2448),
        )
    )
    expected = _numpy_hist(
        -y, x, np.ones(n), (2040, 2448),
        (-float(half_y), float(half_y)), (-float(half_x), float(half_x)),
    )
    assert image.sum() == expected.sum()
    moved = 0.5 * np.abs(image - expected).sum()
    assert moved <= 1e-4 * n
