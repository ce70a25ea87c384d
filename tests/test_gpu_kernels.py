"""The fused motion-only LM kernel compiled for the card (marker `gpu`; it
skips where JAX finds no GPU). Run on the card:

    JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu_kernels.py
"""

import os
import sys

import numpy as np
import jax
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("stereo", [False, True])
def test_lm_kernel_matches_xla_on_gpu(gpu, stereo):
    from ucoslam_tpu.ops.pallas.lm_kernel import motion_only_lm_fused
    from ucoslam_tpu.optim.pnp import _motion_only_lm_xla

    args, depth, cam = chip_smoke.lm_inputs(1000, seed=2)
    args, depth = jax.device_put((args, depth), gpu)
    extra = (depth, 50.0) if stereo else (None, None)
    pose, inl = motion_only_lm_fused(
        *args, cam.fx, cam.fy, cam.cx, cam.cy, depth=extra[0], bf=extra[1],
        has_depth=stereo,
    )
    rp, ri = jax.jit(lambda *a: _motion_only_lm_xla(*a, cam, iters=10, rounds=4))(
        *args, *extra
    )
    assert float(np.abs(np.asarray(pose) - np.asarray(rp)).max()) <= chip_smoke.LM_POSE_ATOL
    np.testing.assert_array_equal(np.asarray(inl), np.asarray(ri))
