"""Test configuration: the CPU backend with 8 virtual devices.

Tests must run without a card. JAX_PLATFORMS defaults to cpu here; on a
machine with an NVIDIA GPU, `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu`
runs the tests that need the card (the `gpu` fixture skips them elsewhere).
"""

import os

import pytest

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = flags + " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

jax.config.update("jax_enable_x64", False)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX finds none."""
    try:
        devices = jax.devices("gpu")
    except RuntimeError:
        devices = []
    if not devices:
        pytest.skip("needs an NVIDIA GPU (run with -m gpu on the card)")
    # the engine's f32 matmul pin (utils/precision.py): without it XLA's
    # reference paths run their f32 contractions in TF32 on the card
    from ucoslam_tpu.utils.precision import force_f32_matmuls

    force_f32_matmuls()
    return devices[0]
