"""Single-frame pose estimation: motion-only LM + vmapped RANSAC.

Counterpart of the reference PnPSolver (src/optimization/pnpsolver.cpp):

- `motion_only_lm`  <-> PnPSolver::solvePnp (pnpsolver.cpp:116): g2o
  motion-only BA with one SE3 vertex, run as `rounds` x `iters` LM with
  outlier re-classification between rounds at chi2(2D) = 5.99 (mono) and
  chi2(3D) = 7.815 (stereo) (pnpsolver.cpp:179-186,353-386). Here the
  graph solver is replaced by an analytic 6x6 normal-equation LM, fully
  jitted with fixed iteration counts.

- `pnp_ransac`      <-> PnPSolver::solvePnPRansac (pnpsolver.cpp:36):
  the reference draws 4-point subsets for cv P3P; we vmap a 6-point DLT
  minimal solver over many hypotheses at once (a batch of tiny eigh
  problems beats a sequential P3P loop on the device), then score inliers with
  the same 5.99 px^2 gate and viewCos > 0.5 (pnpsolver.cpp:62-106).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ucoslam_tpu.config import CHI2_2D, CHI2_3D
from ucoslam_tpu.geometry.camera import CameraParams
from ucoslam_tpu.geometry.se3 import _hat, se3_exp
from ucoslam_tpu.optim.robust import huber_weight


class PnPResult(NamedTuple):
    pose_f2g: jnp.ndarray  # (4, 4)
    inliers: jnp.ndarray  # (B,) bool per input observation
    n_inliers: jnp.ndarray  # () int32


def _reproj_residual_jac(pose, X, cam: CameraParams):
    """Residual r = proj(R X + t) - uv and 2x6 Jacobian wrt left-perturbation.

    Returns (q (B,3) camera pts, r-producer uses caller's uv), J (B, 2, 6).
    """
    R = pose[:3, :3]
    t = pose[:3, 3]
    q = X @ R.T + t
    z = q[:, 2:3].clip(1e-6)
    inv_z = 1.0 / z
    u = cam.fx * q[:, 0:1] * inv_z + cam.cx
    v = cam.fy * q[:, 1:2] * inv_z + cam.cy
    uv = jnp.concatenate([u, v], -1)
    # d(uv)/dq
    zero = jnp.zeros_like(inv_z[:, 0])
    J_proj = jnp.stack(
        [
            jnp.stack([cam.fx * inv_z[:, 0], zero, -cam.fx * q[:, 0] * inv_z[:, 0] ** 2], -1),
            jnp.stack([zero, cam.fy * inv_z[:, 0], -cam.fy * q[:, 1] * inv_z[:, 0] ** 2], -1),
        ],
        -2,
    )  # (B, 2, 3)
    # dq/dxi for xi = [rho, phi] left perturbation: [I | -hat(q)]
    J_pose = jnp.concatenate(
        [jnp.broadcast_to(jnp.eye(3), q.shape[:1] + (3, 3)), -_hat(q)], -1
    )  # (B, 3, 6)
    J = J_proj @ J_pose  # (B, 2, 6)
    return q, uv, J


_LM_BACKEND = "auto"  # "auto" | "xla" | "triton"


def set_lm_backend(backend: str) -> None:
    """Select the motion-only-LM backend: "triton" (one fused Pallas
    program, ops/pallas/lm_kernel.py; GPU only), "xla" (jnp op-by-op), or
    "auto" (the fused kernel when compiled for a CUDA device and the point
    count fits it, xla otherwise). Every jitted program retraces
    after a change."""
    global _LM_BACKEND
    if backend not in ("auto", "xla", "triton"):
        raise ValueError(f"unknown LM backend {backend!r}")
    _LM_BACKEND = backend
    # jitted callers (the tracker's _track_step) cache their traces too
    jax.clear_caches()


@partial(jax.jit, static_argnames=("iters", "rounds"))
def motion_only_lm(
    pose_init: jnp.ndarray,  # (4, 4)
    pts3d: jnp.ndarray,  # (B, 3) world points
    uv: jnp.ndarray,  # (B, 2) undistorted observations
    sigma2: jnp.ndarray,  # (B,) per-observation variance
    valid: jnp.ndarray,  # (B,) bool
    cam: CameraParams,
    depth: jnp.ndarray | None = None,  # (B,) stereo/rgbd depth (0 = mono obs)
    bf: jnp.ndarray | None = None,  # () baseline*fx for stereo residual
    iters: int = 10,
    rounds: int = 4,
) -> PnPResult:
    """Fixed-iteration robust motion-only bundle adjustment.

    Stereo observations (depth > 0) add the disparity residual
    u_r = u - bf/z as in EdgeStereoSE3ProjectXYZOnlyPose (pnpsolver.cpp:246),
    gated at chi2(3D).
    """
    from ucoslam_tpu.ops.pallas.lm_kernel import MAX_POINTS, motion_only_lm_fused

    def xla(*a):
        return _motion_only_lm_xla(*a, cam, iters=iters, rounds=rounds)

    def fused(pose_init, pts3d, uv, sigma2, valid, depth, bf):
        return motion_only_lm_fused(
            pose_init, pts3d, uv, sigma2, valid, cam.fx, cam.fy, cam.cx,
            cam.cy, depth=depth, bf=bf, iters=iters, rounds=rounds,
            has_depth=depth is not None,
        )

    args = (pose_init, pts3d, uv, sigma2, valid, depth, bf)
    if _LM_BACKEND == "triton":
        pose, inliers = fused(*args)
    elif _LM_BACKEND == "auto" and pts3d.shape[0] <= MAX_POINTS:
        pose, inliers = jax.lax.platform_dependent(*args, cuda=fused, default=xla)
    else:
        pose, inliers = xla(*args)
    return PnPResult(pose_f2g=pose, inliers=inliers, n_inliers=jnp.sum(inliers))


def _motion_only_lm_xla(
    pose_init, pts3d, uv, sigma2, valid, depth, bf, cam: CameraParams,
    iters: int, rounds: int,
):
    """motion_only_lm as plain jnp ops -> (pose (4, 4), inliers (B,))."""
    has_depth = depth is not None
    if depth is None:
        depth = jnp.zeros(pts3d.shape[0])
    if bf is None:
        bf = jnp.float32(0.0)
    w_obs = 1.0 / sigma2.clip(1e-9)

    def chi2_of(pose, inlier_mask):
        q, uv_hat, _ = _reproj_residual_jac(pose, pts3d, cam)
        r = uv_hat - uv
        c2 = jnp.sum(r * r, -1) * w_obs
        if has_depth:
            ur_obs = uv[:, 0] - bf / depth.clip(1e-6)
            ur_hat = uv_hat[:, 0] - bf / q[:, 2].clip(1e-6)
            rs = ur_hat - ur_obs
            c2 = c2 + jnp.where(depth > 0, rs * rs * w_obs, 0.0)
        return c2, q

    def gn_round(pose, inlier_mask):
        def body(i, carry):
            pose, lam = carry
            q, uv_hat, J = _reproj_residual_jac(pose, pts3d, cam)
            r = uv_hat - uv  # (B, 2)
            c2 = jnp.sum(r * r, -1) * w_obs
            delta2 = CHI2_3D if has_depth else CHI2_2D
            w_huber = huber_weight(c2, delta2)
            w = w_obs * w_huber * inlier_mask
            # stack stereo residual as an extra row when present
            if has_depth:
                z = q[:, 2].clip(1e-6)
                ur_obs = uv[:, 0] - bf / depth.clip(1e-6)
                ur_hat = uv_hat[:, 0] - bf / z
                rs = (ur_hat - ur_obs)[:, None]  # (B, 1)
                # d(ur)/dq = d(u)/dq + bf/z^2 * dz/dq
                dz = jnp.concatenate(
                    [jnp.zeros_like(q[:, :2]), jnp.ones_like(q[:, 2:3])], -1
                )  # (B, 3)
                J_pose = jnp.concatenate(
                    [jnp.broadcast_to(jnp.eye(3), q.shape[:1] + (3, 3)), -_hat(q)], -1
                )
                J_u = J[:, 0:1, :]  # du/dxi
                J_z = (dz[:, None, :] @ J_pose)  # (B, 1, 6)
                J_s = J_u + (bf / (z * z))[:, None, None] * J_z
                has_s = (depth > 0).astype(jnp.float32) * w
                H_s = jnp.einsum("bij,bik,b->jk", J_s, J_s, has_s)
                b_s = jnp.einsum("bij,bi,b->j", J_s, rs, has_s)
            else:
                H_s = jnp.zeros((6, 6))
                b_s = jnp.zeros((6,))
            H = jnp.einsum("bij,bik,b->jk", J, J, w) + H_s
            g = jnp.einsum("bij,bi,b->j", J, r, w) + b_s
            H = H + lam * jnp.eye(6)
            delta = jnp.linalg.solve(H, g)
            new_pose = se3_exp(-delta) @ pose
            # simple LM: accept if chi2 decreased
            c2_new, _ = chi2_of(new_pose, inlier_mask)
            c2_old, _ = chi2_of(pose, inlier_mask)
            cost_new = jnp.sum(jnp.where(inlier_mask > 0, jnp.minimum(c2_new, delta2 * 4), 0.0))
            cost_old = jnp.sum(jnp.where(inlier_mask > 0, jnp.minimum(c2_old, delta2 * 4), 0.0))
            improved = cost_new < cost_old
            pose = jnp.where(improved, new_pose, pose)
            lam = jnp.where(improved, lam * 0.5, lam * 4.0).clip(1e-8, 1e4)
            return pose, lam

        pose, _ = jax.lax.fori_loop(0, iters, body, (pose, jnp.float32(1e-3)))
        return pose

    pose = pose_init
    inlier_mask = valid.astype(jnp.float32)
    delta2 = CHI2_3D if has_depth else CHI2_2D
    for _ in range(rounds):
        pose = gn_round(pose, inlier_mask)
        c2, q = chi2_of(pose, inlier_mask)
        inlier_mask = (valid & (c2 < delta2) & (q[:, 2] > 0)).astype(jnp.float32)
    return pose, inlier_mask > 0


def _dlt_pose(X: jnp.ndarray, uv_norm: jnp.ndarray) -> jnp.ndarray:
    """6+ point DLT for [R|t] from world points and *normalized* image coords.

    X: (S, 3), uv_norm: (S, 2) with K already removed. Returns (4, 4) pose.
    """
    s = X.shape[0]
    zeros = jnp.zeros((s, 4))
    Xh = jnp.concatenate([X, jnp.ones((s, 1))], -1)  # (S, 4)
    row_u = jnp.concatenate([Xh, zeros, -uv_norm[:, 0:1] * Xh], -1)  # (S, 12)
    row_v = jnp.concatenate([zeros, Xh, -uv_norm[:, 1:2] * Xh], -1)
    A = jnp.concatenate([row_u, row_v], 0)  # (2S, 12)
    AtA = A.T @ A
    _, vecs = jnp.linalg.eigh(AtA)
    p = vecs[:, 0].reshape(3, 4)
    M = p[:, :3]
    # Orthonormalize M -> R via SVD; fix sign so that depths are positive.
    U, S, Vt = jnp.linalg.svd(M)
    det = jnp.linalg.det(U @ Vt)
    D = jnp.diag(jnp.array([1.0, 1.0, 0.0]) + jnp.array([0.0, 0.0, 1.0]) * det)
    R = U @ D @ Vt
    scale = jnp.sum(S) / 3.0 * det  # signed mean singular value
    t = p[:, 3] / scale
    # If most depths negative, flip (DLT sign ambiguity).
    q = X @ R.T + t
    flip = jnp.sum(q[:, 2] < 0) > (s // 2)
    R = jnp.where(flip, -R, R)
    t = jnp.where(flip, -t, t)
    T = jnp.eye(4).at[:3, :3].set(R).at[:3, 3].set(t)
    return T


@partial(jax.jit, static_argnames=("n_hypotheses", "sample_size", "refine_iters"))
def pnp_ransac(
    pts3d: jnp.ndarray,  # (B, 3)
    uv: jnp.ndarray,  # (B, 2) undistorted pixels
    sigma2: jnp.ndarray,  # (B,)
    valid: jnp.ndarray,  # (B,) bool
    cam: CameraParams,
    key: jnp.ndarray,  # jax PRNG key
    n_hypotheses: int = 512,
    sample_size: int = 6,
    refine_iters: int = 10,
    min_inliers: int = 15,
) -> PnPResult:
    """Vmapped RANSAC pose (relocalization). Deterministic given `key`."""
    b = pts3d.shape[0]
    # Sample only from valid rows: draw with probability proportional to valid.
    logits = jnp.where(valid, 0.0, -1e9)
    keys = jax.random.split(key, n_hypotheses)

    uv_norm = jnp.stack(
        [(uv[:, 0] - cam.cx) / cam.fx, (uv[:, 1] - cam.cy) / cam.fy], -1
    )

    def one_hypothesis(k):
        idx = jax.random.categorical(k, logits, shape=(sample_size,))
        T = _dlt_pose(pts3d[idx], uv_norm[idx])
        return T

    poses = jax.vmap(one_hypothesis)(keys)  # (H, 4, 4)

    def score(T):
        q = pts3d @ T[:3, :3].T + T[:3, 3]
        uv_hat = cam.project(q)
        r = uv_hat - uv
        c2 = jnp.sum(r * r, -1) / sigma2.clip(1e-9)
        ok = valid & (c2 < CHI2_2D) & (q[:, 2] > 0)
        return jnp.sum(ok), ok

    n_in, inl = jax.vmap(score)(poses)
    best = jnp.argmax(n_in)
    best_pose = poses[best]
    best_inl = inl[best]
    # Refine on inliers with the LM (fixed iterations).
    res = motion_only_lm(
        best_pose, pts3d, uv, sigma2, best_inl, cam, iters=refine_iters, rounds=2
    )
    ok = res.n_inliers >= min_inliers
    return PnPResult(
        pose_f2g=res.pose_f2g,
        inliers=res.inliers & ok,
        n_inliers=jnp.where(ok, res.n_inliers, 0),
    )
