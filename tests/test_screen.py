"""Screen reading tests (mirrors reference ``tests/test_screen.py``)."""

import jax
import jax.numpy as jnp
import numpy as np

import lynx_tpu as lt


def test_reading_shows_beam_particle(astra_beam_path):
    segment = lt.Segment(
        elements=[
            lt.Drift(length=jnp.array([1.0])),
            lt.Screen(
                resolution=jnp.array((100, 100)),
                pixel_size=jnp.array((1e-5, 1e-5)),
                is_active=True,
                name="my_screen",
            ),
        ],
    )
    beam = lt.ParticleBeam.from_astra(astra_beam_path)

    assert isinstance(segment.my_screen.reading, jax.Array)
    assert segment.my_screen.reading.shape == (1, 100, 100)
    assert np.allclose(np.asarray(segment.my_screen.reading), 0.0)

    _ = segment.track(beam)

    assert isinstance(segment.my_screen.reading, jax.Array)
    assert segment.my_screen.reading.shape == (1, 100, 100)
    assert bool(jnp.all(segment.my_screen.reading >= 0.0))
    assert bool(jnp.any(segment.my_screen.reading > 0.0))


def test_reading_shows_beam_parameter(astra_beam_path):
    segment = lt.Segment(
        elements=[
            lt.Drift(length=jnp.array([1.0])),
            lt.Screen(
                resolution=jnp.array((100, 100)),
                pixel_size=jnp.array((1e-5, 1e-5)),
                is_active=True,
                name="my_screen",
            ),
        ],
        name="my_segment",
    )
    beam = lt.ParameterBeam.from_astra(astra_beam_path)

    assert segment.my_screen.reading.shape == (1, 100, 100)
    assert np.allclose(np.asarray(segment.my_screen.reading), 0.0)

    _ = segment.track(beam)

    assert segment.my_screen.reading.shape == (1, 100, 100)
    assert bool(jnp.all(segment.my_screen.reading >= 0.0))
    assert bool(jnp.any(segment.my_screen.reading > 0.0))


def test_reading_shows_beam_ares(astra_beam_path):
    """The real ARES screen (2448x2040) sees the beam."""
    from lynx_tpu.models import ares_ea_segment

    segment = ares_ea_segment()
    beam = lt.ParticleBeam.from_astra(astra_beam_path)

    segment.AREABSCR1.resolution = (2448, 2040)
    segment.AREABSCR1.pixel_size = jnp.array((3.3198e-6, 2.4469e-6))
    segment.AREABSCR1.binning = 1
    segment.AREABSCR1.is_active = True

    assert segment.AREABSCR1.reading.shape == (1, 2040, 2448)
    assert np.allclose(np.asarray(segment.AREABSCR1.reading), 0.0)

    _ = segment.track(beam)

    assert segment.AREABSCR1.reading.shape == (1, 2040, 2448)
    assert bool(jnp.all(segment.AREABSCR1.reading >= 0.0))
    assert bool(jnp.any(segment.AREABSCR1.reading > 0.0))


def test_screen_binning_shrinks_image():
    screen = lt.Screen(
        resolution=(128, 64), pixel_size=jnp.array((1e-5, 1e-5)), binning=2,
        is_active=True,
    )
    assert screen.effective_resolution == (64, 32)
    assert screen.reading.shape == (1, 32, 64)


def test_screen_histogram_conserves_particles():
    """All particles inside the field of view land in the image."""
    screen = lt.Screen(
        resolution=(64, 64), pixel_size=jnp.array((1e-4, 1e-4)), is_active=True
    )
    beam = lt.ParticleBeam.from_parameters(
        num_particles=5000, sigma_x=jnp.array([1e-4]), sigma_y=jnp.array([1e-4])
    )
    segment = lt.Segment([screen])
    out = segment.track(beam)
    assert out is lt.Beam.empty
    # 64*1e-4/2 = 3.2 mm half-extent >> 4 sigma; everything lands on screen.
    assert np.isclose(float(screen.reading.sum()), 5000.0)


def test_screen_weighted_by_survival():
    """Dead particles (survival 0) do not appear in the image."""
    segment = lt.Segment(
        [
            lt.Aperture(
                x_max=jnp.array([5e-5]), y_max=jnp.array([1.0]), name="ap"
            ),
            lt.Screen(
                resolution=(64, 64),
                pixel_size=jnp.array((1e-4, 1e-4)),
                is_active=True,
                name="scr",
            ),
        ]
    )
    beam = lt.ParticleBeam.from_parameters(
        num_particles=5000, sigma_x=jnp.array([1e-4]), sigma_y=jnp.array([1e-4])
    )
    _ = segment.track(beam)
    total = float(segment.scr.reading.sum())
    assert 0 < total < 5000


def test_parameter_and_particle_images_agree_on_orientation():
    """An off-center beam must peak in the same image region for both the
    particle histogram and the analytic Gaussian image (guards against
    flipped/transposed camera axes)."""
    screen = lt.Screen(
        resolution=(64, 48), pixel_size=jnp.array((2e-5, 2e-5)), is_active=True,
        name="s",
    )
    kwargs = dict(
        mu_x=jnp.array([3e-4]),     # right of center
        mu_y=jnp.array([2e-4]),     # above center
        sigma_x=jnp.array([5e-5]),
        sigma_y=jnp.array([5e-5]),
        energy=jnp.array([1e8]),
    )
    particle = lt.ParticleBeam.from_parameters(num_particles=200_000, **kwargs)
    parameter = lt.ParameterBeam.from_parameters(**kwargs)

    seg_a = lt.Segment([screen])
    seg_a.track(particle)
    particle_image = np.asarray(screen.reading[0])

    screen.set_read_beam(None)
    seg_a.track(parameter)
    parameter_image = np.asarray(screen.reading[0])

    assert particle_image.shape == parameter_image.shape == (48, 64)
    peak_particle = np.unravel_index(np.argmax(particle_image), particle_image.shape)
    peak_parameter = np.unravel_index(
        np.argmax(parameter_image), parameter_image.shape
    )
    # Same pixel neighborhood (within 1 px of each other).
    assert abs(peak_particle[0] - peak_parameter[0]) <= 1
    assert abs(peak_particle[1] - peak_parameter[1]) <= 1
    # +x offset -> right half (column > W/2); +y offset -> upper half (row < H/2).
    assert peak_particle[1] > 32
    assert peak_particle[0] < 24


def test_misaligned_screen_shifts_both_beam_types_identically():
    """A screen misalignment shifts the image center of mass by the same
    pixel offset for the particle histogram and the analytic Gaussian image
    (guards the ParticleBeam y-index fix, ``docs/deviations.md`` §2)."""

    def center_of_mass(image):
        h, w = image.shape
        total = image.sum()
        rows = (image.sum(axis=1) * np.arange(h)).sum() / total
        cols = (image.sum(axis=0) * np.arange(w)).sum() / total
        return np.array([rows, cols])

    kwargs = dict(
        sigma_x=jnp.array([5e-5]),
        sigma_y=jnp.array([5e-5]),
        energy=jnp.array([1e8]),
    )
    particle = lt.ParticleBeam.from_parameters(
        num_particles=500_000, key=jax.random.PRNGKey(2), **kwargs
    )
    parameter = lt.ParameterBeam.from_parameters(**kwargs)

    shifts = {}
    for label, beam in [("particle", particle), ("parameter", parameter)]:
        images = {}
        for mis in [(0.0, 0.0), (2e-4, -1e-4)]:
            screen = lt.Screen(
                resolution=(64, 48),
                pixel_size=jnp.array((2e-5, 2e-5)),
                misalignment=jnp.array([mis]),
                is_active=True,
                name="s",
            )
            lt.Segment([screen]).track(beam)
            images[mis] = np.asarray(screen.reading[0])
        shifts[label] = center_of_mass(images[(2e-4, -1e-4)]) - center_of_mass(
            images[(0.0, 0.0)]
        )

    # Both beam types move by the same (row, col) pixel shift...
    np.testing.assert_allclose(
        shifts["particle"], shifts["parameter"], atol=0.25
    )
    # ...and in the physically right direction: screen moved +x -> beam
    # appears at lower x (columns decrease); screen moved -y -> beam
    # appears HIGHER in y, and the camera flip maps +y to lower row index.
    assert shifts["parameter"][1] < -1
    assert shifts["parameter"][0] < -1
