"""chip_smoke.py rehearsed on the CPU: its phase functions at tiny sizes,
and its refusal to run without a GPU or outside a checkout."""

import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402


def _run_script(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env, capture_output=True,
        text=True, timeout=300,
    )


def test_exits_nonzero_without_gpu():
    r = _run_script(ROOT, os.path.join(ROOT, "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_exits_nonzero_outside_checkout(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    r = _run_script(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_device_check_refuses_cpu():
    with pytest.raises(SystemExit):
        chip_smoke.device_check(1)


def test_kernel_phase_interpreted(monkeypatch):
    from functools import partial

    from ucoslam_tpu.ops.pallas import lm_kernel

    monkeypatch.setattr(lm_kernel, "motion_only_lm_fused",
                        partial(lm_kernel.motion_only_lm_fused, interpret=True))
    times = chip_smoke.kernel_phase(B=50, reps=1)
    assert set(times) == {
        "lm_mono_fused_ms", "lm_mono_xla_ms", "lm_stereo_fused_ms", "lm_stereo_xla_ms",
    }


def test_ba_phase_tiny():
    out = chip_smoke.ba_phase(sizes=((16, 1024),), iters=3, stages=1)
    (res,) = out.values()
    assert res["cost"] < res["cost0"]
    assert abs(res["cost"] - res["cost_cpu"]) <= chip_smoke.BA_COST_RTOL * res["cost_cpu"]


def test_four_phase_on_virtual_devices():
    """The four-card path on 4 of the 8 virtual CPU devices."""
    from ucoslam_tpu.parallel import make_mesh

    out = chip_smoke.four_phase(
        mesh=make_mesh(4), n_kf=128, n_pt=2048, iters=3, stages=1,
        pg_keyframes=12, pg_iters=5,
    )
    assert out["ba_rel"] <= chip_smoke.BA_COST_RTOL
    assert out["posegraph_err"] <= chip_smoke.POSEGRAPH_ATOL


def test_run_scenario_rgbd_tiny(tmp_path):
    import jax

    # test_sequence turns the persistent compile cache on for the process
    saved = jax.config.jax_compilation_cache_dir
    try:
        s = chip_smoke.run_scenario(
            "rgbd", str(tmp_path), frames=10,
            params_overrides=dict(maxMapPoints=2048, maxKeyPointsPerFrame=512,
                                  maxKeyFrames=16),
        )
    finally:
        jax.config.update("jax_compilation_cache_dir", saved)
    assert s["tracked"] >= chip_smoke.MIN_TRACKED
    assert s["ate"] < 0.05
