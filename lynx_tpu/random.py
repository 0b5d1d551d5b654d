"""PRNG key management.

JAX randomness is explicit (``jax.random.PRNGKey``), while the reference
relies on torch's implicit global RNG (e.g. ``ParticleBeam.from_parameters``
sampling, reference ``lynx/particles/particle_beam.py:162-170``).  All lynx-tpu
sampling APIs take an optional ``key=`` argument; when it is omitted we fall
back to a module-level default key that is split on every use, mirroring the
convenience of a global RNG while remaining reproducible via :func:`seed`.
"""

from __future__ import annotations

from typing import Optional

import jax


# Created lazily: a module-level PRNGKey would initialize the device backend
# at import time, making ``import lynx_tpu`` choose (and lock) the device
# backend before the caller could configure it.
_default_key: Optional[jax.Array] = None


def seed(value: int) -> None:
    """Reset the global default PRNG key (analog of ``torch.manual_seed``)."""
    global _default_key
    _default_key = jax.random.PRNGKey(value)


def next_key(key: Optional[jax.Array] = None) -> jax.Array:
    """Return ``key`` if given, else split and advance the global default key."""
    global _default_key
    if key is not None:
        return key
    if _default_key is None:
        _default_key = jax.random.PRNGKey(0)
    _default_key, sub = jax.random.split(_default_key)
    return sub
