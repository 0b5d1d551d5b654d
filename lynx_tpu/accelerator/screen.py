"""Diagnostic screen producing camera images.

Reference behavior: ``lynx/accelerator/screen.py``.  The reading for a
``ParticleBeam`` is a (survival-weighted) 2D histogram of (x, y) over the
pixel grid, computed with a fused scatter-add under jit
(``lynx_tpu.ops.histogram``); for a ``ParameterBeam`` it is the analytic
Gaussian PDF evaluated on the pixel grid.  Images are ``(..., H, W)`` with the
vertical axis flipped like a camera image.

Shape-bearing configuration (``resolution``, ``binning``, ``is_active``) is
static metadata: it participates in jit cache keys and may be reassigned on
the element (triggering recompilation), matching the reference's mutable
usage (e.g. ``segment.AREABSCR1.binning = 1``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from lynx_tpu.accelerator.element import Element
from lynx_tpu.ops.histogram import weighted_histogram_2d
from lynx_tpu.particles import Beam, ParameterBeam, ParticleBeam

Array = jax.Array


def _as_int_tuple(value) -> Tuple[int, ...]:
    import numpy as np

    if isinstance(value, (int, float)):
        return (int(value),)
    # via numpy: never bounce through the device for static config
    return tuple(int(v) for v in np.asarray(value).ravel().tolist())


def screen_reading_particle(
    beam: ParticleBeam,
    resolution: Tuple[int, int],
    pixel_size: Array,
    binning: int,
    dtype=jnp.float32,
) -> Array:
    """(..., H, W) histogram image of a particle beam."""
    w_bins = int(resolution[0] // binning)
    h_bins = int(resolution[1] // binning)
    half_w = resolution[0] * pixel_size[..., 0] / 2
    half_h = resolution[1] * pixel_size[..., 1] / 2
    weights = (
        beam.survival
        if beam.survival is not None
        else jnp.ones_like(beam.xs)
    ).astype(dtype)
    # Histogram (-y, x) straight into camera orientation: row r of the
    # image is the flipped y bin, so binning -y over the symmetric range
    # IS the flip, and putting y first IS the transpose: no full-image
    # swapaxes + flip passes after the scatter.  Values exactly ON an
    # interior y-bin edge land one bin off versus bin-then-flip — a
    # measure-zero float event.
    image = weighted_histogram_2d(
        -beam.ys,
        beam.xs,
        weights,
        x_range=(-half_h, half_h),
        y_range=(-half_w, half_w),
        bins=(h_bins, w_bins),
    )  # (..., H, W), flipped like a camera image
    return image


def screen_reading_parameter(
    beam: ParameterBeam,
    resolution: Tuple[int, int],
    pixel_size: Array,
    binning: int,
) -> Array:
    """(..., H, W) analytic transverse Gaussian PDF image of a moment beam."""
    w_bins = int(resolution[0] // binning)
    h_bins = int(resolution[1] // binning)
    dtype = beam._mu.dtype
    half_w = resolution[0] * pixel_size[..., 0] / 2
    half_h = resolution[1] * pixel_size[..., 1] / 2

    # Pixel-center grids (camera orientation: row 0 = +y).
    tx = (jnp.arange(w_bins, dtype=dtype) + 0.5) / w_bins  # left -> right
    ty = (jnp.arange(h_bins, dtype=dtype) + 0.5) / h_bins
    x = (-half_w)[..., None] + tx * (2 * half_w)[..., None]  # (..., W)
    y = (half_h)[..., None] - ty * (2 * half_h)[..., None]  # (..., H), flipped

    mu = jnp.stack([beam.mu_x, beam.mu_y], axis=-1)
    c00 = beam._cov[..., 0, 0]
    c02 = beam._cov[..., 0, 2]
    c22 = beam._cov[..., 2, 2]
    det = c00 * c22 - c02**2
    det = jnp.maximum(det, jnp.finfo(dtype).tiny)

    dx = x[..., None, :] - mu[..., 0, None, None]  # (..., 1, W)
    dy = y[..., :, None] - mu[..., 1, None, None]  # (..., H, 1)
    # Quadratic form of the inverse covariance.
    quad = (
        c22[..., None, None] * dx**2
        - 2 * c02[..., None, None] * dx * dy
        + c00[..., None, None] * dy**2
    ) / det[..., None, None]
    norm = 1.0 / (2 * jnp.pi * jnp.sqrt(det))
    return norm[..., None, None] * jnp.exp(-0.5 * quad)


class Screen(Element):
    """Diagnostic screen.

    :param resolution: Camera resolution ``(width, height)`` in pixels.
    :param pixel_size: Pixel size ``(width, height)`` in meters.
    :param binning: Camera binning factor.
    :param misalignment: ``(..., 2)`` x/y misalignment in meters.
    :param is_active: If ``True`` the screen records (and absorbs) the beam.
    :param name: Unique identifier of the element.
    """

    _data_fields = ("pixel_size", "misalignment")
    _static_fields = ("_resolution", "_binning", "is_active")

    # Defaults for non-pytree state (instances rebuilt by tree_unflatten
    # inside transformations fall back to these class attributes).
    _read_beam = None
    cached_reading = None

    def __init__(
        self,
        resolution: Optional[Array] = None,
        pixel_size: Optional[Array] = None,
        binning: Optional[int] = None,
        misalignment: Optional[Array] = None,
        is_active: bool = False,
        name: Optional[str] = None,
        dtype=jnp.float32,
    ) -> None:
        super().__init__(name=name, dtype=dtype)
        self._resolution = (
            tuple(_as_int_tuple(resolution)) if resolution is not None else (1024, 1024)
        )
        self.pixel_size = (
            jnp.asarray(pixel_size, dtype=dtype)
            if pixel_size is not None
            else jnp.array((1e-3, 1e-3), dtype=dtype)
        )
        self._binning = int(binning) if binning is not None else 1
        self.misalignment = (
            jnp.asarray(misalignment, dtype=dtype)
            if misalignment is not None
            else jnp.array([(0.0, 0.0)], dtype=dtype)  # (1,)-batched default
        )
        self.length = jnp.zeros(self.misalignment.shape[:-1], dtype=dtype)
        self.is_active = is_active

        self._read_beam = None
        self.cached_reading = None

    # resolution / binning are static (shape-bearing) but stay assignable.
    @property
    def resolution(self) -> Tuple[int, int]:
        return self._resolution

    @resolution.setter
    def resolution(self, value) -> None:
        self._resolution = tuple(_as_int_tuple(value))
        self.cached_reading = None

    @property
    def binning(self) -> int:
        return self._binning

    @binning.setter
    def binning(self, value) -> None:
        self._binning = int(value)
        self.cached_reading = None

    @property
    def is_skippable(self) -> bool:
        return not self.is_active

    @property
    def effective_resolution(self) -> Tuple[int, int]:
        return (
            self._resolution[0] // self._binning,
            self._resolution[1] // self._binning,
        )

    @property
    def effective_pixel_size(self) -> Array:
        return self.pixel_size * self._binning

    @property
    def extent(self) -> Array:
        return jnp.stack(
            [
                -self._resolution[0] * self.pixel_size[..., 0] / 2,
                self._resolution[0] * self.pixel_size[..., 0] / 2,
                -self._resolution[1] * self.pixel_size[..., 1] / 2,
                self._resolution[1] * self.pixel_size[..., 1] / 2,
            ]
        )

    @property
    def pixel_bin_edges(self) -> Tuple[Array, Array]:
        return (
            jnp.linspace(
                -self._resolution[0] * self.pixel_size[..., 0] / 2,
                self._resolution[0] * self.pixel_size[..., 0] / 2,
                self.effective_resolution[0] + 1,
            ),
            jnp.linspace(
                -self._resolution[1] * self.pixel_size[..., 1] / 2,
                self._resolution[1] * self.pixel_size[..., 1] / 2,
                self.effective_resolution[1] + 1,
            ),
        )

    def transfer_map(self, energy: Array) -> Array:
        energy = jnp.asarray(energy)
        return jnp.broadcast_to(
            jnp.eye(7, dtype=self.misalignment.dtype), (*energy.shape, 7, 7)
        )


    def transfer_map_table(self, energy: Array):
        from lynx_tpu.ops.table import identity_table

        return identity_table()

    def misaligned_beam(self, incoming: Beam) -> Beam:
        """The beam as seen by the screen (shifted by its misalignment)."""
        if isinstance(incoming, ParameterBeam):
            mu = incoming._mu
            mu = mu.at[..., 0].add(-self.misalignment[..., 0])
            mu = mu.at[..., 2].add(-self.misalignment[..., 1])
            return ParameterBeam(
                mu, incoming._cov, incoming.energy, incoming.total_charge
            )
        elif isinstance(incoming, ParticleBeam):
            # NOTE reference quirk: the y-misalignment is subtracted from the
            # x'-column for particle beams (``screen.py:133-135`` shifts
            # particles[:, :, 1]); we shift y (index 2), the physically
            # meaningful behavior, matching the ParameterBeam branch.
            # One broadcast subtract over the whole (..., N, 7) cloud, one
            # fused elementwise pass (a per-column ``.at[..., c].add``
            # lowers to column-strided dynamic-update-slices instead).
            mis = self.misalignment
            zero = jnp.zeros_like(mis[..., 0])
            shift = jnp.stack(
                [mis[..., 0], zero, mis[..., 1], zero, zero, zero, zero],
                axis=-1,
            ).astype(incoming.particles.dtype)  # never promote the cloud
            particles = incoming.particles - shift[..., None, :]
            return ParticleBeam(
                particles,
                incoming.energy,
                particle_charges=incoming.particle_charges,
                survival=incoming.survival,
            )
        return incoming

    def track(self, incoming: Beam) -> Beam:
        if not self.is_active:
            return incoming
        read_beam = (
            incoming if incoming is Beam.empty else self.misaligned_beam(incoming)
        )
        is_traced = any(
            isinstance(leaf, jax.core.Tracer)
            for leaf in jax.tree_util.tree_leaves(read_beam)
        )
        if not is_traced:
            self.set_read_beam(read_beam)
        else:
            # The reference stores the read beam on EVERY active-screen
            # track (``screen.py:126-141``); under jit/vmap/grad tracing
            # that side effect cannot exist, so ``.reading`` would silently
            # stay zeros.  Warn once per screen instead of failing silently
            # (docs/deviations.md §8); the supported traced route is
            # ``lynx_tpu.functional.track``'s diagnostics output.
            import warnings

            warnings.warn(
                f"Screen {self.name!r} was tracked with traced values"
                " (inside jit/vmap/grad): the stateful '.reading' cannot"
                " be updated and will NOT reflect this track. Use"
                " lynx_tpu.functional.track(segment, beam) and read the"
                " image from its diagnostics dict instead"
                " (docs/deviations.md §8).",
                stacklevel=2,
            )
        return Beam.empty  # the screen absorbs the beam (reference ``:139``)

    @property
    def reading(self) -> Array:
        if self.cached_reading is not None:
            return self.cached_reading

        read_beam = self.get_read_beam()
        batch_shape = self.misalignment.shape[:-1]
        h = self.effective_resolution[1]
        w = self.effective_resolution[0]
        if read_beam is Beam.empty or read_beam is None:
            image = jnp.zeros((*batch_shape, h, w))
        elif isinstance(read_beam, ParameterBeam):
            image = screen_reading_parameter(
                read_beam, self._resolution, self.pixel_size, self._binning
            )
        elif isinstance(read_beam, ParticleBeam):
            image = screen_reading_particle(
                read_beam,
                self._resolution,
                self.pixel_size,
                self._binning,
            )
        else:
            raise TypeError(f"Read beam is of invalid type {type(read_beam)}")

        self.cached_reading = image
        return image

    def get_read_beam(self) -> Beam:
        return self._read_beam

    def set_read_beam(self, value: Beam) -> None:
        self._read_beam = value
        self.cached_reading = None

    def broadcast(self, shape: tuple) -> Element:
        new_screen = self.__class__(
            resolution=self._resolution,
            pixel_size=self.pixel_size,
            binning=self._binning,
            misalignment=jnp.broadcast_to(self.misalignment, (*shape, 2)),
            is_active=self.is_active,
            name=self.name,
        )
        new_screen.length = jnp.broadcast_to(self.length, shape)
        return new_screen

    def split(self, resolution: float) -> list[Element]:
        return [self]

    def plot(self, ax, s: float) -> None:
        from matplotlib.patches import Rectangle

        alpha = 1 if self.is_active else 0.2
        patch = Rectangle(
            (s, -0.6), 0, 0.6 * 2, color="tab:green", alpha=alpha, zorder=2
        )
        ax.add_patch(patch)

    @property
    def defining_features(self) -> list[str]:
        return super().defining_features + [
            "resolution",
            "pixel_size",
            "binning",
            "misalignment",
            "is_active",
        ]

    def __repr__(self) -> str:
        return (
            f"{self.__class__.__name__}(resolution={self._resolution!r}, "
            f"pixel_size={self.pixel_size!r}, binning={self._binning!r}, "
            f"misalignment={self.misalignment!r}, "
            f"is_active={self.is_active!r}, name={self.name!r})"
        )
