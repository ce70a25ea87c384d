"""Smoke test of the SLAM engine's main path on an NVIDIA GPU.

    python chip_smoke.py           # one card: every phase below
    python chip_smoke.py --four    # four cards: sharded global BA and pose
                                   # graph against one card, nothing else

Phases (one card):
  1. device check: JAX must find a GPU; prints the card and its power limit;
  2. native marker detector: built here from native/ into build/native;
  3. kernel: the fused motion-only LM compiled at full width (mono and
     stereo), checked against the plain XLA path on the card and on the
     CPU, and timed against it;
  4. end to end: apps.test_sequence (SLAM, global BA + save, LOCALIZATION)
     at the full width of Params() for mono, stereo, RGB-D and markers;
  5. global BA at 128 and 1024 keyframes, the 128-kf result against the CPU.

Any failing phase raises, so the script exits non-zero; the last line of a
passing run is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# Tolerances (each with its reason):
#: LM pose entries: the kernel solves the damped 6x6 system by Cholesky,
#: the XLA path by LU, and sums in another order -- f32 round-off only
LM_POSE_ATOL = 1e-4
#: BA final cost vs another device/mesh: reductions in another order over
#: 10^5-10^6 residuals, amplified by the LM's accept/reject decisions
BA_COST_RTOL = 1e-3
#: sharded pose graph vs one card: psum order changes the f32 sums
POSEGRAPH_ATOL = 1e-4
#: end to end, every scenario must track this share of all its frames in
#: each pass (SLAM and LOCALIZATION)
MIN_TRACKED = 0.95
#: ATE (m) of each scenario below from the same commands on the CPU backend;
#: the card may differ by summation order and XLA's algorithm choices, and
#: may not be worse than 1.5x of these
CPU_ATE = {"mono": 0.005888, "stereo": 0.003692, "rgbd": 0.003548,
           "markers": 0.003865}
ATE_FACTOR = 1.5

#: end-to-end scenarios: test_sequence arguments and Params overrides
SCENARIOS = {
    "mono": (["--synthetic", "60"], {}),
    "stereo": (["--synthetic", "40", "--stereo"], {}),
    "rgbd": (["--synthetic", "40", "--rgbd"], {}),
    # the renderer's markers are 0.5 m squares
    "markers": (["--synthetic", "40", "--synthetic-markers", "8"],
                {"aruco_markerSize": 0.5}),
}


def _say(*parts) -> None:
    print(*parts, flush=True)


def _check_checkout() -> None:
    """The package must come from this checkout, never from elsewhere."""
    import ucoslam_tpu

    pkg = os.path.dirname(os.path.abspath(ucoslam_tpu.__file__))
    if os.path.dirname(pkg) != ROOT:
        raise SystemExit(f"ucoslam_tpu imported from {pkg}, not from {ROOT}")


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip()


def device_check(count: int) -> dict:
    """Phase 1: a GPU with `count` devices, or exit."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {devs[0].platform} devices only")
    if len(devs) != count:
        raise SystemExit(f"expected {count} GPUs, JAX found {len(devs)}")
    card = nvidia_smi()
    _say(f"[device] {devs[0].device_kind} x{len(devs)}, jax {jax.__version__}")
    _say(card)
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs), "card": card.splitlines()[0]}


def native_phase() -> str:
    """Phase 2: compile the marker detector here and make sure it is used."""
    from ucoslam_tpu.markers import native
    from ucoslam_tpu.markers.detector import ArucoDetector

    path = native.build(force=True)
    backend = ArucoDetector().backend
    if backend != "native":
        raise AssertionError(f"marker detector backend is {backend}, not native")
    _say(f"[native] built {os.path.relpath(path, ROOT)}; detector backend {backend}")
    return backend


def _timed(fn, reps: int) -> float:
    """Mean ms per call of fn() after one warm-up call."""
    import jax

    jax.block_until_ready(fn())
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn()
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps * 1e3


def _on_cpu(fn, *args):
    import jax

    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        return jax.block_until_ready(jax.jit(fn)(*jax.device_put(args, cpu)))


def lm_inputs(B: int, seed: int = 0):
    """Seeded LM scene: B points, 20% gross outliers, 40% without depth."""
    import numpy as np
    import jax.numpy as jnp

    from ucoslam_tpu.geometry import CameraParams, se3_apply, se3_exp

    cam = CameraParams.create(500.0, 500.0, 320.0, 240.0, width=640, height=480)
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (B, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(3, 10, B)
    T = se3_exp(jnp.asarray([0.1, -0.05, 0.02, 0.03, -0.02, 0.01]))
    q = np.asarray(se3_apply(T, jnp.asarray(X)))
    uv = np.asarray(cam.project(jnp.asarray(q))) + rng.normal(0, 0.4, (B, 2))
    out = rng.random(B) < 0.2
    uv[out] += rng.uniform(25, 90, (int(out.sum()), 2))
    depth = np.where(rng.random(B) < 0.4, 0.0, q[:, 2]).astype(np.float32)
    T0 = se3_exp(jnp.asarray([0.08, -0.03, 0.0, 0.02, 0.0, 0.0]))
    args = (T0, jnp.asarray(X), jnp.asarray(uv.astype(np.float32)),
            jnp.ones(B), jnp.asarray(rng.random(B) < 0.95))
    return args, jnp.asarray(depth), cam


def kernel_phase(B: int = 2112, reps: int = 50) -> dict:
    """Phase 3: the fused motion-only LM at full width against the plain path.

    B defaults to the tracker's LM width: maxKeyPointsPerFrame rows plus
    the 64 marker-corner rows (slam/tracker.py _MK_ROWS).
    """
    import numpy as np
    import jax
    import jax.numpy as jnp

    from ucoslam_tpu.ops.pallas import lm_kernel
    from ucoslam_tpu.optim.pnp import _motion_only_lm_xla

    times = {}
    args, depth, cam = lm_inputs(B)
    for mode in ("mono", "stereo"):
        stereo = mode == "stereo"
        extra = (depth, jnp.float32(50.0)) if stereo else (None, None)

        def fused(*a, stereo=stereo):
            return lm_kernel.motion_only_lm_fused(
                *a[:5], cam.fx, cam.fy, cam.cx, cam.cy, depth=a[5], bf=a[6],
                has_depth=stereo,
            )

        def plain(*a):
            return _motion_only_lm_xla(*a, cam, iters=10, rounds=4)

        full = args + extra
        compiled = jax.jit(fused).lower(*full).compile()
        _say(f"[kernel] motion_only_lm {mode} B={B} memory {compiled.memory_analysis()}")
        pose, inl = compiled(*full)
        plain_j = jax.jit(plain)
        for where, (rp, ri) in (("xla", plain_j(*full)), ("cpu", _on_cpu(plain, *full))):
            err = float(np.abs(np.asarray(pose) - np.asarray(rp)).max())
            if err > LM_POSE_ATOL:
                raise AssertionError(f"LM {mode} pose differs from {where} by {err}")
            if not np.array_equal(np.asarray(inl), np.asarray(ri)):
                raise AssertionError(f"LM {mode} inlier mask differs from {where}")
        times[f"lm_{mode}_fused_ms"] = _timed(lambda: compiled(*full), reps)
        times[f"lm_{mode}_xla_ms"] = _timed(lambda: plain_j(*full), reps)
        _say(f"[kernel] motion_only_lm {mode} matches xla and cpu; fused "
             f"{times[f'lm_{mode}_fused_ms']:.4f} ms, "
             f"xla {times[f'lm_{mode}_xla_ms']:.4f} ms")
    return times


_SUMMARY = {
    "steady_fps": r"steadyFPS=([\d.]+) \(median frame ([\d.]+)ms\)",
    "tracked": r" tracked=(\d+)/(\d+)",
    "pass1_tracked": r"pass1_tracked=(\d+)/(\d+)",
    "markers": r" markers=(\d+)",
    "ate": r"ATE=([\d.]+)",
    "detector": r"markerDetector=(\w+)",
}


def run_scenario(name: str, out_dir: str, frames: int | None = None,
                 params_overrides: dict | None = None) -> dict:
    """One test_sequence run (both passes) -> its parsed summary."""
    from ucoslam_tpu.apps import test_sequence
    from ucoslam_tpu.config import Params

    argv, over = SCENARIOS[name]
    argv = list(argv)
    if frames is not None:
        argv[1] = str(frames)
    os.makedirs(out_dir, exist_ok=True)
    params = os.path.join(out_dir, "params.yml")
    Params().replace(**over, **(params_overrides or {})).save_yml(params)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        rc = test_sequence.main(argv + ["--params", params, "--out-dir", out_dir])
    text = log.getvalue()
    with open(os.path.join(out_dir, "log.txt"), "w") as f:
        f.write(text)
    if rc != 0:
        raise AssertionError(f"{name}: test_sequence exited {rc}")
    got = {}
    for key, pat in _SUMMARY.items():
        m = re.search(pat, text)
        if m is None:
            raise AssertionError(f"{name}: no {key} in the test_sequence output")
        got[key] = m.groups() if len(m.groups()) > 1 else m.group(1)
    s = {
        "steady_fps": float(got["steady_fps"][0]),
        "median_frame_ms": float(got["steady_fps"][1]),
        "tracked": int(got["tracked"][0]) / int(got["tracked"][1]),
        "pass1_tracked": int(got["pass1_tracked"][0]) / int(got["pass1_tracked"][1]),
        "ate": float(got["ate"]),
        "markers": int(got["markers"]),
        "detector": got["detector"],
    }
    for key in ("pass1_tracked", "tracked"):
        if s[key] < MIN_TRACKED:
            raise AssertionError(f"{name}: {key} {s[key]:.3f} < {MIN_TRACKED}")
    if name == "markers" and (s["detector"] != "native" or s["markers"] < 1):
        raise AssertionError(f"markers: detector {s['detector']}, {s['markers']} markers mapped")
    return s


def memory_report() -> None:
    """memory_analysis() of the per-frame programs at the Params() width."""
    import numpy as np
    import jax
    import jax.numpy as jnp

    from ucoslam_tpu.config import Params
    from ucoslam_tpu.features.orb import ORBExtractor
    from ucoslam_tpu.geometry.camera import CameraParams
    from ucoslam_tpu.io.synthetic import SyntheticSequence
    from ucoslam_tpu.mapping.frame import empty_frame
    from ucoslam_tpu.mapping.map import Map
    from ucoslam_tpu.slam.tracker import _track_step

    p = Params()
    P, N = p.maxMapPoints, p.maxKeyPointsPerFrame
    img = jnp.asarray(SyntheticSequence(n_frames=1).render(0))
    orb = ORBExtractor(max_features=N, n_levels=p.nOctaveLevels)
    c = jax.jit(orb._detect_and_compute).lower(img, jnp.float32(orb.fast_threshold)).compile()
    _say(f"[e2e] ORBExtractor.detect_and_compute {img.shape} memory {c.memory_analysis()}")
    cam = CameraParams.create(500.0, 500.0, 320.0, 240.0)
    rng = np.random.default_rng(0)
    X = rng.uniform(-3, 3, (P, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(3, 10, P)
    dist = np.linalg.norm(X, axis=1)
    m = Map(p)
    m.add_points(X, X / dist[:, None], rng.integers(0, 2**32, (P, 8), dtype=np.uint32),
                 dist / 1.2**7, dist * 1.05, np.zeros(P, np.int32), 0)
    args = (m.state, empty_frame(N), cam, jnp.eye(4), jnp.float32(15.0),
            jnp.float32(60.0), jnp.float32(1.2))
    c = _track_step.lower(*args).compile()
    _say(f"[e2e] _track_step P={P} N={N} memory {c.memory_analysis()}")


def e2e_phase(out_root: str) -> dict:
    """Phase 4: the two-pass protocol through apps.test_sequence for every
    scenario, each ATE held to ATE_FACTOR x its CPU_ATE."""
    import jax

    from ucoslam_tpu.config import Params

    p = Params()
    _say(f"[e2e] Params: 640x480, {p.nOctaveLevels} levels, "
         f"maxKeyPointsPerFrame={p.maxKeyPointsPerFrame}, "
         f"maxMapPoints={p.maxMapPoints}, maxKeyFrames={p.maxKeyFrames}")
    memory_report()
    card = jax.devices()[0].device_kind
    out = {}
    for name in SCENARIOS:
        t0 = time.perf_counter()
        s = run_scenario(name, os.path.join(out_root, name))
        s["wall_s"] = time.perf_counter() - t0
        out[name] = s
        _say(f"[e2e] {name} on {card}: tracked {s['pass1_tracked']:.3f} (SLAM) "
             f"{s['tracked']:.3f} (localization), "
             f"ATE {s['ate']:.6f}, steadyFPS "
             f"{s['steady_fps']:.2f}, median frame {s['median_frame_ms']:.1f} ms, "
             f"markers {s['markers']} ({s['detector']}), {s['wall_s']:.1f} s")
        if s["ate"] > ATE_FACTOR * CPU_ATE[name]:
            raise AssertionError(
                f"{name}: ATE {s['ate']} > {ATE_FACTOR} x CPU {CPU_ATE[name]}"
            )
    stats = jax.devices()[0].memory_stats() or {}
    if "peak_bytes_in_use" in stats:
        _say(f"[e2e] peak_bytes_in_use {stats['peak_bytes_in_use']} on {card}")
    return out


def _ba_problem(n_kf: int, n_pt: int, obs_per_pt: int = 8):
    import jax.numpy as jnp

    sys.path.insert(0, ROOT)
    from bench import _make_ba_problem

    return _make_ba_problem(jnp, n_kf=n_kf, n_pt=n_pt, obs_per_pt=obs_per_pt)


def _ba_memory(problem, cam, iters: int, stages: int) -> str:
    """memory_analysis() of the jitted solver ba_solve dispatches to."""
    import jax

    from ucoslam_tpu.optim.ba import _ba_solve_general
    from ucoslam_tpu.optim.schur_pm import pm_problem_for, pm_staged_lm

    pm = pm_problem_for(problem)[0] if problem.cam_pose.shape[0] >= 128 else None
    if pm is not None:
        c = pm_staged_lm.lower(pm, cam, iters=iters, stages=stages).compile()
    else:
        c = _ba_solve_general.lower(problem, cam, iters=iters, stages=stages).compile()
    return str(c.memory_analysis())


def ba_phase(sizes=((128, 16384), (1024, 131072)), iters: int = 10,
             stages: int = 2) -> dict:
    """Phase 5: global BA at each (keyframes, points) size, 8 obs per point;
    the first size is also solved on the CPU and compared."""
    import numpy as np
    import jax

    from ucoslam_tpu.optim.ba import ba_solve

    out = {}
    for k, (n_kf, n_pt) in enumerate(sizes):
        problem, cam = _ba_problem(n_kf, n_pt)
        tag = f"{n_kf}kf x {n_pt}pt x {8 * n_pt}obs"
        _say(f"[ba] {tag} memory {_ba_memory(problem, cam, iters, stages)}")
        r = jax.block_until_ready(ba_solve(problem, cam, iters=iters, stages=stages))
        t0 = time.perf_counter()
        r = jax.block_until_ready(ba_solve(problem, cam, iters=iters, stages=stages))
        dt = time.perf_counter() - t0
        costs = np.asarray(r.cost_history)
        if not (np.isfinite(costs).all() and costs[-1] < costs[0]):
            raise AssertionError(f"BA {tag}: cost did not decrease ({costs[0]} -> {costs[-1]})")
        out[tag] = {"cost0": float(costs[0]), "cost": float(costs[-1]), "solve_s": dt}
        _say(f"[ba] {tag}: cost {costs[0]:.6g} -> {costs[-1]:.6g}, "
             f"{iters * stages} LM steps in {dt * 1e3:.2f} ms on {jax.devices()[0].device_kind}")
        if k == 0:
            cpu = jax.devices("cpu")[0]
            with jax.default_device(cpu):
                p_cpu = jax.device_put(problem, cpu)
                rc = ba_solve(p_cpu, cam, iters=iters, stages=stages)
                c_cpu = float(np.asarray(rc.cost_history)[-1])
            rel = abs(c_cpu - costs[-1]) / abs(c_cpu)
            if rel > BA_COST_RTOL:
                raise AssertionError(f"BA {tag}: final cost {costs[-1]} vs cpu {c_cpu}")
            out[tag]["cost_cpu"] = c_cpu
            _say(f"[ba] {tag}: final cost vs cpu {c_cpu:.6g}, relative {rel:.3g}")
    return out


def loop_pose_graph(K: int, seed: int = 0):
    """Circular K-keyframe pose graph with drift and one loop edge."""
    import numpy as np
    import jax.numpy as jnp

    from ucoslam_tpu.geometry.se3 import se3_exp
    from ucoslam_tpu.optim.posegraph import PoseGraphProblem

    rng = np.random.default_rng(seed)
    true, noisy = [], []
    for k in range(K):
        a = 2 * np.pi * k / K
        xi = np.array([2 * np.sin(a), 0.0, 2 - 2 * np.cos(a), 0.0, a, 0.0], np.float32)
        T = np.asarray(se3_exp(jnp.asarray(xi)))
        d = np.asarray(se3_exp(jnp.asarray(rng.normal(0, 0.05 * k / K, 6).astype(np.float32))))
        true.append(T)
        noisy.append(d @ T)
    ei = list(range(K - 1)) + [K - 1]
    ej = list(range(1, K)) + [0]
    meas = [true[i] @ np.linalg.inv(true[j]) for i, j in zip(ei, ej)]
    w = [50.0] * (K - 1) + [200.0]
    return PoseGraphProblem(
        poses=jnp.asarray(np.stack(noisy)), fixed=jnp.asarray(np.arange(K) == 0),
        edge_i=jnp.asarray(ei, jnp.int32), edge_j=jnp.asarray(ej, jnp.int32),
        edge_meas=jnp.asarray(np.stack(meas).astype(np.float32)),
        edge_weight=jnp.asarray(w, jnp.float32), edge_valid=jnp.ones(K, bool),
    )


def four_phase(mesh=None, n_kf: int = 1024, n_pt: int = 131072, iters: int = 10,
               stages: int = 2, pg_keyframes: int = 128, pg_iters: int = 15) -> dict:
    """The multi-card path: global BA through the mesh dispatch
    (set_ba_mesh -> parallel/sharded_pm.py) and the sharded Sim3 pose
    graph, each against one device of this process. mesh defaults to every
    local device."""
    import numpy as np
    import jax

    from ucoslam_tpu.optim import ba
    from ucoslam_tpu.optim.posegraph import pose_graph_solve
    from ucoslam_tpu.parallel import make_mesh
    from ucoslam_tpu.parallel.sharded_posegraph import (
        shard_pose_graph_problem, sharded_pose_graph_solve,
    )

    problem, cam = _ba_problem(n_kf, n_pt)
    sharded = make_mesh() if mesh is None else mesh
    n = sharded.devices.size
    if n < 2:
        raise AssertionError(f"the mesh has {n} device(s)")
    costs = {}
    try:
        for label, m in (("sharded", sharded), ("one device", None)):
            ba.set_ba_mesh(m)
            run = lambda: jax.block_until_ready(  # noqa: E731
                ba._solve_dispatch(problem, cam, iters, stages=stages)[0]
            )
            run()
            # the second call must reuse the first one's compiled program
            t0 = time.perf_counter()
            c = np.asarray(run().cost_history)
            dt = time.perf_counter() - t0
            if not (np.isfinite(c).all() and c[-1] < c[0]):
                raise AssertionError(f"BA on {label}: cost did not decrease")
            costs[label] = float(c[-1])
            _say(f"[four] BA {n_kf}kf on {n if m is not None else 1} device(s): "
                 f"cost {c[0]:.6g} -> {c[-1]:.6g}, {iters * stages} LM steps "
                 f"in {dt * 1e3:.2f} ms")
    finally:
        ba.set_ba_mesh(None)
    rel = abs(costs["sharded"] - costs["one device"]) / abs(costs["one device"])
    if rel > BA_COST_RTOL:
        raise AssertionError(f"sharded BA final cost off by {rel} relative")
    _say(f"[four] BA sharded vs one device: relative {rel:.3g}")

    pg = loop_pose_graph(pg_keyframes)
    single = np.asarray(pose_graph_solve(pg, iters=pg_iters))
    multi = np.asarray(sharded_pose_graph_solve(
        shard_pose_graph_problem(pg, n), sharded, iters=pg_iters
    ))
    err = float(np.abs(multi - single).max())
    if not np.isfinite(multi).all() or err > POSEGRAPH_ATOL:
        raise AssertionError(f"sharded pose graph off by {err}")
    _say(f"[four] pose graph {pg_keyframes} keyframes on {n} devices vs one: max abs {err:.3g}")
    return {"ba_costs": costs, "ba_rel": rel, "posegraph_err": err}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card path (sharded BA, pose graph)")
    ap.add_argument("--out-dir", default=None,
                    help="where the end-to-end runs write (default: a temp dir)")
    args = ap.parse_args(argv)
    count = 4 if args.four else 1
    if not args.four and "CUDA_VISIBLE_DEVICES" not in os.environ:
        # one card by default, so the multi-device BA dispatch is not
        # reached by accident on a multi-GPU host
        os.environ["CUDA_VISIBLE_DEVICES"] = "0"
    _check_checkout()
    from ucoslam_tpu.utils.cache import enable_compile_cache
    from ucoslam_tpu.utils.precision import force_f32_matmuls

    dev = device_check(count)
    enable_compile_cache()
    force_f32_matmuls()
    t0 = time.perf_counter()
    if args.four:
        four_phase()
    else:
        native_phase()
        kernel_phase()
        with contextlib.ExitStack() as stack:
            out_dir = args.out_dir or stack.enter_context(tempfile.TemporaryDirectory())
            e2e_phase(out_dir)
        ba_phase()
    _say(f"[done] {time.perf_counter() - t0:.1f} s on {dev['card']}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["kind"], "count": dev["count"]}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
