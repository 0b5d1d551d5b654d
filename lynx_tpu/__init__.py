"""lynx-tpu: a JAX-first differentiable beam-dynamics framework.

Capabilities mirror the reference (jank324/lynx, a fork of desy-ml/cheetah):
fast, differentiable, vectorized linear beam optics for RL and gradient-based
accelerator tuning — redesigned for JAX/XLA: functional pytree core,
branch-free kernels, explicit-output diagnostics, mesh sharding.
"""

from lynx_tpu import converters  # noqa: F401
from lynx_tpu import functional  # noqa: F401
from lynx_tpu.accelerator import (  # noqa: F401
    BPM,
    Aperture,
    Cavity,
    CustomTransferMap,
    Dipole,
    Drift,
    Element,
    HorizontalCorrector,
    Marker,
    Quadrupole,
    RBend,
    Screen,
    Segment,
    Solenoid,
    Undulator,
    VerticalCorrector,
)
from lynx_tpu.functional import moment_sufficient, track  # noqa: F401
from lynx_tpu.particles import Beam, ParameterBeam, ParticleBeam  # noqa: F401
from lynx_tpu.random import seed  # noqa: F401
from lynx_tpu.tuning import make_tuner, tune  # noqa: F401

__version__ = "0.4.0"
