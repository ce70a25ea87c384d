"""Dispatch between the fused motion-only LM kernel and the plain XLA
path, on the CPU: the kernel lowers to Triton for CUDA, `auto` takes the
XLA path off the GPU, and no path falls back to interpret mode by itself."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.export import DisabledSafetyCheck, export

from ucoslam_tpu.geometry import CameraParams
from ucoslam_tpu.ops.pallas import lm_kernel
from ucoslam_tpu.optim import pnp

CAM = CameraParams.create(500.0, 500.0, 320.0, 240.0, width=640, height=480)
TRITON_CALL = "__gpu$xla.gpu.triton"


def _lower_for_cuda(fn, *specs):
    exp = export(
        jax.jit(fn), platforms=["cuda"],
        disabled_checks=[DisabledSafetyCheck.custom_call(TRITON_CALL)],
    )(*specs)
    return exp.mlir_module()


def _spec(shape, dtype=jnp.float32):
    return jax.ShapeDtypeStruct(shape, dtype)


@pytest.mark.parametrize("stereo", [False, True])
def test_kernel_lowers_to_triton_for_cuda(stereo):
    """The Triton lowering runs without a card: it rejects what the route
    cannot express (unsupported primitives, dot shapes) before any chip."""
    B = 2112

    def fn(pose, X, uv, s2, valid, depth):
        return lm_kernel.motion_only_lm_fused(
            pose, X, uv, s2, valid, CAM.fx, CAM.fy, CAM.cx, CAM.cy,
            depth=depth if stereo else None, bf=50.0 if stereo else None,
            has_depth=stereo,
        )

    text = _lower_for_cuda(
        fn, _spec((4, 4)), _spec((B, 3)), _spec((B, 2)), _spec((B,)),
        _spec((B,), jnp.bool_), _spec((B,)),
    )
    assert TRITON_CALL in text


def _lm_args(n=300, seed=3):
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(3, 10, n)
    uv = np.asarray(CAM.project(jnp.asarray(X))) + rng.normal(0, 0.5, (n, 2))
    return (jnp.eye(4), jnp.asarray(X), jnp.asarray(uv.astype(np.float32)),
            jnp.ones(n), jnp.ones(n, bool))


def test_auto_lm_takes_xla_path_off_gpu():
    args = _lm_args()
    try:
        pnp.set_lm_backend("xla")
        ref = pnp.motion_only_lm(*args, CAM)
        pnp.set_lm_backend("auto")
        got = pnp.motion_only_lm(*args, CAM)
        hlo = pnp.motion_only_lm.lower(*args, CAM).as_text()
    finally:
        pnp.set_lm_backend("auto")
    np.testing.assert_array_equal(np.asarray(got.pose_f2g), np.asarray(ref.pose_f2g))
    np.testing.assert_array_equal(np.asarray(got.inliers), np.asarray(ref.inliers))
    assert TRITON_CALL not in hlo


def test_triton_backend_never_interprets_by_itself():
    """Forcing the kernel where it cannot compile fails loudly."""
    try:
        pnp.set_lm_backend("triton")
        with pytest.raises(Exception, match="interpret"):
            pnp.motion_only_lm(*_lm_args(), CAM)
    finally:
        pnp.set_lm_backend("auto")


def test_unknown_backend_rejected():
    with pytest.raises(ValueError):
        pnp.set_lm_backend("pallas")


def test_kernel_shape_choice():
    """The kernel pads the point axis to a power of two of at least 16."""
    assert lm_kernel.padded_points(2112) == 4096
    assert lm_kernel.padded_points(2048) == 2048
    assert lm_kernel.padded_points(5) == 16
