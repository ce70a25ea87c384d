"""Device compute kernels: Hamming matching, FAST/ORB frontend, image ops."""

from ucoslam_tpu.ops.hamming import (  # noqa: F401
    hamming_matrix,
    hamming_matrix_mxu,
    unpack_descriptor_bits,
    match_best2,
    mutual_best,
    filter_ambiguous_train_sized,
    INVALID_DIST,
)
