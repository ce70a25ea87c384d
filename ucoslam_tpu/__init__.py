"""ucoslam_tpu — a keypoint + fiducial-marker SLAM engine in JAX for the GPU.

A from-scratch JAX/XLA/Pallas implementation of the capability surface of
UcoSLAM (reference: the C++/OpenCV/g2o UcoSLAM 1.0.7): monocular, stereo and
RGB-D keypoint SLAM fully integrated with ArUco fiducial markers for
initialization, tracking, relocalization and real-scale recovery.

Design stance (see SURVEY.md §7): the reference's data model and
accept/reject thresholds are the spec; its architecture (two threads, tree
indices, sparse-graph LM) is replaced with batched, fixed-shape,
functionally-updated device state:

- feature extraction  -> batched FAST/ORB over the whole pyramid at once
- xflann/fbow matching -> bit-matmul Hamming top-k
- kd-tree radius search -> dense windowed candidate masks
- g2o sparse LM        -> vmapped Schur-complement LM, shardable over a mesh
- tracking/mapping threads -> deterministic sequential interleave (the
  reference's `runSequential` mode) with optional async dispatch
"""

__version__ = "0.1.0"

from ucoslam_tpu.config import Params, DescriptorType, Mode, TrackingState  # noqa: F401
