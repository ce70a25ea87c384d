"""Single-GPU benchmark: SLAM pipeline throughput on the card.

Measures the per-frame hot stages at full width plus the global-BA
optimizer:
  - ORB frontend: 640x480, 8 pyramid levels, 2048 keypoints + descriptors
  - tracking step: 16384-point map x 2048-keypoint frame projection
    matching and 4x10-iteration motion-only LM (both fused kernels on the
    GPU, ops/pallas/)
  - global BA: LM iteration time at 128 / 512 / 1024 keyframes

Baseline: the reference (UcoSLAM 1.0.7, C++/AVX/OpenMP) advertises
real-time operation and publishes no numbers (BASELINE.md); the canonical
real-time budget for its benchmark suites is 30 fps camera rate, so
vs_baseline = fps / 30.

Fails without a GPU. Prints ONE JSON line: {"metric", "value", "unit",
"vs_baseline", "detail"}, the detail naming the card and its power limit.
"""

import json
import subprocess
import time

import numpy as np


def bench_frame_pipeline(jnp):
    from ucoslam_tpu.config import Params
    from ucoslam_tpu.features.orb import ORBExtractor
    from ucoslam_tpu.geometry.camera import CameraParams
    from ucoslam_tpu.io.synthetic import SyntheticSequence
    from ucoslam_tpu.mapping.frame import empty_frame
    from ucoslam_tpu.mapping.map import Map
    from ucoslam_tpu.slam.tracker import _track_step

    rng = np.random.default_rng(0)

    # ---------- ORB frontend ----------
    seq = SyntheticSequence(n_frames=4, n_points=1500)
    img = jnp.asarray(seq.render(0))
    orb = ORBExtractor(max_features=2048, n_levels=8)
    kp = orb.detect_and_compute(img)
    kp.xy.block_until_ready()  # compile
    n_rep = 20
    t0 = time.perf_counter()
    for _ in range(n_rep):
        kp = orb.detect_and_compute(img)
    kp.xy.block_until_ready()
    t_extract = (time.perf_counter() - t0) / n_rep

    # ---------- tracking step ----------
    P, N = 16384, 2048
    params = Params().replace(maxMapPoints=P, maxKeyFrames=64, maxKeyPointsPerFrame=N)
    cam = CameraParams.create(500.0, 500.0, 320.0, 240.0)
    X = rng.uniform(-3, 3, (P, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(3, 10, P)
    desc = rng.integers(0, 2**32, (P, 8), dtype=np.uint32)
    dist = np.linalg.norm(X, axis=1)
    m = Map(params)
    m.add_points(X, X / dist[:, None], desc, dist / 1.2**7, dist * 1.05,
                 np.zeros(P, np.int32), 0)
    uv = np.asarray(cam.project(jnp.asarray(X)))[:N] + rng.normal(0, 0.3, (N, 2))
    frame = empty_frame(N)._replace(
        und_xy=jnp.asarray(uv.astype(np.float32)),
        desc=jnp.asarray(desc[:N]),
        valid=jnp.ones(N, bool),
    )
    args = (m.state, frame, cam, jnp.eye(4), jnp.float32(15.0), jnp.float32(60.0),
            jnp.float32(1.2))
    out = _track_step(*args)
    out[0].block_until_ready()
    t0 = time.perf_counter()
    for _ in range(n_rep):
        out = _track_step(*args)
    out[0].block_until_ready()
    t_track = (time.perf_counter() - t0) / n_rep

    return t_extract, t_track, int(out[4])


def _make_ba_problem(jnp, n_kf=128, n_pt=16384, obs_per_pt=8):
    """Production-scale synthetic BA problem (sliding-window visibility)."""
    from ucoslam_tpu.geometry import se3_exp
    from ucoslam_tpu.geometry.camera import CameraParams
    from ucoslam_tpu.optim.ba import BAProblem

    cam = CameraParams.create(500.0, 500.0, 320.0, 240.0)
    rng = np.random.default_rng(7)
    X = rng.uniform(-4, 4, (n_pt, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(6, 16, n_pt)
    poses = []
    for k in range(n_kf):
        xi = np.array(
            [0.1 * np.sin(k * 0.1), 0.05 * np.cos(k * 0.13), 0.002 * k,
             0.005 * np.sin(k * 0.2), 0.005 * np.cos(k * 0.1), 0.0],
            np.float32,
        )
        poses.append(np.asarray(se3_exp(jnp.asarray(xi))))
    poses = np.stack(poses).astype(np.float32)
    base = (np.arange(n_pt, dtype=np.int64) * n_kf // n_pt).astype(np.int32)
    obs_cam2 = ((base[:, None] + np.arange(obs_per_pt, dtype=np.int32)) % n_kf)
    T = poses[obs_cam2]  # (P, MO, 4, 4)
    Xc = np.einsum("pmij,pj->pmi", T[:, :, :3, :3], X) + T[:, :, :3, 3]
    uv = np.stack(
        [500.0 * Xc[..., 0] / Xc[..., 2] + 320.0,
         500.0 * Xc[..., 1] / Xc[..., 2] + 240.0], -1
    ).astype(np.float32)
    uv += rng.normal(0, 0.5, uv.shape).astype(np.float32)

    O = n_pt * obs_per_pt
    poses_init = poses.copy()
    xi_n = rng.normal(0, 0.01, (n_kf, 6)).astype(np.float32)
    for k in range(1, n_kf):
        poses_init[k] = np.asarray(se3_exp(jnp.asarray(xi_n[k]))) @ poses[k]
    X_init = X + rng.normal(0, 0.05, X.shape).astype(np.float32)
    problem = BAProblem(
        cam_pose=jnp.asarray(poses_init),
        cam_fixed=jnp.asarray(np.arange(n_kf) == 0),
        cam_valid=jnp.ones(n_kf, bool),
        pt_pos=jnp.asarray(X_init),
        pt_valid=jnp.ones(n_pt, bool),
        obs_cam=jnp.asarray(obs_cam2.reshape(-1)),
        obs_pt=jnp.asarray(np.repeat(np.arange(n_pt, dtype=np.int32), obs_per_pt)),
        obs_uv=jnp.asarray(uv.reshape(O, 2)),
        obs_sigma2=jnp.ones(O),
        obs_depth=jnp.zeros(O, jnp.float32),
        obs_valid=jnp.ones(O, bool),
        pt_obs=jnp.asarray(np.arange(O, dtype=np.int32).reshape(n_pt, obs_per_pt)),
        bf=jnp.float32(50.0),
        cam_obs=jnp.asarray(
            __import__("ucoslam_tpu.optim.ba", fromlist=["_build_cam_obs"])
            ._build_cam_obs(obs_cam2.reshape(-1), n_kf, O)
        ),
    )
    return problem, cam


def _ba_iter_time(problem, cam):
    """Marginal LM-iteration time + convergence check for one problem."""
    from ucoslam_tpu.optim.ba import ba_solve

    # multiples of the pm solver's relinearization cadence (6) so the
    # marginal cost measures steady-state macro steps
    lo, hi = 6, 24
    r = ba_solve(problem, cam, iters=lo, stages=1)
    r.cam_pose.block_until_ready()  # compile iters=lo
    r = ba_solve(problem, cam, iters=hi, stages=1)
    r.cam_pose.block_until_ready()  # compile iters=hi
    t0 = time.perf_counter()
    r = ba_solve(problem, cam, iters=lo, stages=1)
    r.cam_pose.block_until_ready()
    t_lo = time.perf_counter() - t0
    t0 = time.perf_counter()
    r = ba_solve(problem, cam, iters=hi, stages=1)
    r.cam_pose.block_until_ready()
    t_hi = time.perf_counter() - t0
    t_iter = (t_hi - t_lo) / (hi - lo)  # marginal cost per LM iteration
    converged = float(np.asarray(r.cost_history)[-1]) < float(
        np.asarray(r.cost_history)[0]
    )
    return t_iter, converged


def bench_global_ba(jnp):
    """Global-BA LM iteration time at the mapping-rate window (128 kf), an
    intermediate map (512 kf) and the reference-suite map (1024 kf x 131k
    points x 1M observations, KITTI-00 scale)."""
    out = {}
    for n_kf, n_pt in ((128, 16384), (512, 65536), (1024, 131072)):
        problem, cam = _make_ba_problem(jnp, n_kf=n_kf, n_pt=n_pt, obs_per_pt=8)
        t_iter, converged = _ba_iter_time(problem, cam)
        out[f"ba_{n_kf}"] = {
            "problem": f"{n_kf}kf x {n_pt}pt x {8 * n_pt}obs",
            "t_iter_ms": t_iter * 1e3,
            "cost_decreased": bool(converged),
        }
    return out


def main():
    import jax
    import jax.numpy as jnp

    from ucoslam_tpu.utils.cache import enable_compile_cache
    from ucoslam_tpu.utils.precision import force_f32_matmuls

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX found {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    enable_compile_cache()
    # bench at the precision production runs (utils/precision.py)
    force_f32_matmuls()
    t_extract, t_track, n_inliers = bench_frame_pipeline(jnp)
    ba = bench_global_ba(jnp)

    fps = 1.0 / (t_extract + t_track)
    result = {
        "metric": "slam_frame_pipeline_fps",
        "value": fps,
        "unit": "frames/s (ORB 2048kp@640x480x8L + track 16k-pt map)",
        "vs_baseline": fps / 30.0,
        "detail": {
            "t_extract_ms": t_extract * 1e3,
            "t_track_ms": t_track * 1e3,
            "n_inliers": n_inliers,
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
            "card": card,
            **ba,
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
