from lynx_tpu.ops.rmatrix import (  # noqa: F401
    base_rmatrix,
    cavity_rmatrix,
    drift_rmatrix,
    misalignment_matrix,
    rotation_matrix,
)
from lynx_tpu.ops.folding import fold_transfer_maps  # noqa: F401
from lynx_tpu.ops.histogram import weighted_histogram_2d  # noqa: F401
