"""Speed-optimization walkthrough on a 1058-element lattice.

The lynx-tpu version of the reference's ``optimize_speed.ipynb``: a long FODO
lattice (150 x [Q, D, Q, D, M, Q, D] + steerers), tracked (1) naively,
(2) with inert elements removed/replaced, (3) with transfer maps merged
ahead of time, (4) merged + batched over 1000 concurrent settings.

Reference CPU numbers to compare against (BASELINE.md): 138 ms unoptimized,
440 us merged, 1.9 us/sample batched.

Run: python examples/optimize_speed.py
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp

import lynx_tpu as lt


def build_lattice(num_cells: int = 150) -> lt.Segment:
    from lynx_tpu.models import fodo_lattice

    return fodo_lattice(num_cells=num_cells)


def timed(label, fn, *args, iters=20):
    out = fn(*args)
    jax.block_until_ready(out)
    start = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    jax.block_until_ready(out)
    elapsed = (time.perf_counter() - start) / iters
    print(f"{label:45s} {elapsed * 1e3:10.3f} ms")
    return elapsed


def main() -> None:
    lattice = build_lattice()
    print(f"lattice: {len(lattice.elements)} elements")
    beam = lt.ParameterBeam.from_parameters(
        sigma_x=jnp.array([1.75e-4]), energy=jnp.array([1e8])
    )

    track = jax.jit(lambda seg, b: seg.track(b)._mu)
    timed("unoptimized track", track, lattice, beam)

    no_markers = lattice.without_inactive_markers()
    timed("without_inactive_markers", track, no_markers, beam)

    as_drifts = no_markers.inactive_elements_as_drifts()
    timed("inactive_elements_as_drifts", track, as_drifts, beam)

    merged = as_drifts.transfer_maps_merged(incoming_beam=beam)
    print(f"merged lattice: {len(merged.elements)} elements")
    timed("transfer_maps_merged", track, merged, beam)

    batch = 1000
    merged_batched = merged.broadcast((batch,))
    beam_batched = beam.broadcast((batch,))
    elapsed = timed(
        f"merged + broadcast(({batch},))", track, merged_batched, beam_batched
    )
    print(
        f"{'':45s} {elapsed / batch * 1e6:10.3f} us/sample"
        f"  ({batch / elapsed:,.0f} tracks/s)"
    )


if __name__ == "__main__":
    from lynx_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    main()
