"""Engine-wide f32 matmul precision (the accuracy floor).

On the GPU, XLA may run float32 matmul/einsum/dot in TF32 on the tensor
cores (about three decimal digits) unless told otherwise. The geometry and
optimization paths (pose LM, triangulation, Schur solves) are small,
latency-bound contractions whose accuracy the whole SLAM state depends on:
at reduced (bf16) input precision the mono head-to-head ATE degraded ~11x
(0.0088 -> 0.0977 on identical frames) while everything still "worked".
The reference's Eigen/g2o math is full f32/f64 throughout (3rdparty/g2o),
so full-precision f32 -- no TF32 -- is the parity default.

The descriptor Hamming bit-matmuls are exact at any precision (+-1 bf16
products, f32 accumulation). Scoping the pin per op is an open item
(ROADMAP, Speed).

Call force_f32_matmuls() before tracing any program (precision is baked
in at trace time); UcoSlam/System and every app entry do.
"""

from __future__ import annotations


def force_f32_matmuls() -> None:
    import jax

    try:
        jax.config.update("jax_default_matmul_precision", "highest")
    except Exception:  # pragma: no cover - very old jax
        pass
