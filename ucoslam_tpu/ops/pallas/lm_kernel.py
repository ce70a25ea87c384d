"""Fused motion-only LM as one Pallas kernel on the Triton route (GPU).

The jnp implementation (optim/pnp.py motion_only_lm, counterpart of the
reference PnPSolver::solvePnp, pnpsolver.cpp:116-409) runs rounds x iters
dependent LM steps of ~40 small ops each, so under XLA the refine is
latency-bound: one loop trip is several kernel launches. This kernel runs
the ENTIRE rounds x iters loop -- residuals, Jacobians, 6x6 normal
equations, Cholesky solve, SE3 retraction, LM damping, Huber weights and the
per-round outlier reclassification -- in one program (grid (1,)), so the
only fixed costs are one launch and one (8, B) input read.

Layout: per-point data is coordinate-major, one (B,) vector per quantity
with B padded to a power of two (Triton blocks are powers of two); the pose,
camera and 6x6 system are scalars held in registers. H and g are built as
the 21 + 6 weighted sums over the points (no dot: Triton's dot wants every
dimension >= 16, and a 6-wide contraction would waste the tensor cores
anyway).

Semantics match motion_only_lm: same Huber weighting, same lambda schedule
(init 1e-3, x0.5 / x4, clipped to [1e-8, 1e4]), same capped-cost acceptance
test, same chi2(2D)=5.99 / chi2(3D)=7.815 reclassification, same stereo
disparity row (EdgeStereoSE3ProjectXYZOnlyPose, pnpsolver.cpp:246), same
SE3 exponential (geometry/se3.py). The XLA path solves the damped system
with LU, this kernel with Cholesky (the system is SPD by construction), so
poses agree to f32 round-off, not bit for bit.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pl_triton

from ucoslam_tpu.config import CHI2_2D, CHI2_3D

#: largest point count the one-program kernel takes (wider -> XLA path)
MAX_POINTS = 4096
#: warps of the single program (measured best on the H100, PERF.md)
NUM_WARPS = 8

_EPS = 1e-8  # geometry/se3.py _EPS: Taylor switch of the SO3/SE3 series

# rows of the (8, B) per-point input
_X, _Y, _Z, _U, _V, _W, _VALID, _DEPTH = range(8)


def _se3_exp(xi):
    """geometry.se3.se3_exp on 6 scalars -> (R 3x3 nested lists, t 3)."""
    rho, phi = xi[:3], xi[3:]
    x, y, z = phi
    theta2 = x * x + y * y + z * z
    theta = jnp.sqrt(theta2 + _EPS * _EPS)
    small = theta2 < _EPS
    sin_t, cos_t = jnp.sin(theta), jnp.cos(theta)
    a = jnp.where(small, 1.0 - theta2 / 6.0, sin_t / theta)
    b = jnp.where(
        small, 0.5 - theta2 / 24.0,
        (1.0 - cos_t) / jnp.maximum(theta2, _EPS * _EPS),
    )
    c = jnp.where(
        small, 1.0 / 6.0 - theta2 / 120.0,
        (theta - sin_t) / jnp.maximum(theta2 * theta, _EPS * _EPS * _EPS),
    )
    K = [[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]]
    KK = [[sum(K[i][k] * K[k][j] for k in range(3)) for j in range(3)]
          for i in range(3)]
    eye = [[1.0 if i == j else 0.0 for j in range(3)] for i in range(3)]
    R = [[eye[i][j] + a * K[i][j] + b * KK[i][j] for j in range(3)]
         for i in range(3)]
    V = [[eye[i][j] + b * K[i][j] + c * KK[i][j] for j in range(3)]
         for i in range(3)]
    t = [V[i][0] * rho[0] + V[i][1] * rho[1] + V[i][2] * rho[2]
         for i in range(3)]
    return R, t


def _solve_spd6(H, g):
    """Cholesky solve of the SPD 6x6 system H x = g, all scalars."""
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = H[j][j] - sum(L[j][k] * L[j][k] for k in range(j))
        L[j][j] = jnp.sqrt(jnp.maximum(s, 1e-30))
        for i in range(j + 1, n):
            L[i][j] = (H[i][j] - sum(L[i][k] * L[j][k] for k in range(j))) / L[j][j]
    y = [None] * n
    for i in range(n):
        y[i] = (g[i] - sum(L[i][k] * y[k] for k in range(i))) / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        x[i] = (y[i] - sum(L[k][i] * x[k] for k in range(i + 1, n))) / L[i][i]
    return x


def _lm_kernel(cam_ref, pose_ref, data_ref, pose_out, mask_out, *,
               iters: int, rounds: int, has_depth: bool, delta2: float):
    fx, fy, cx, cy, bf = (cam_ref[k] for k in range(5))
    X, Y, Z = data_ref[_X, :], data_ref[_Y, :], data_ref[_Z, :]
    u_obs, v_obs = data_ref[_U, :], data_ref[_V, :]
    w_obs = data_ref[_W, :]
    valid = data_ref[_VALID, :] > 0.0
    depth = data_ref[_DEPTH, :]
    has_s = depth > 0.0
    ur_obs = u_obs - bf / jnp.maximum(depth, 1e-6)
    cap = 4.0 * delta2

    def project(pose):
        R, t = pose
        qx = R[0][0] * X + R[0][1] * Y + R[0][2] * Z + t[0]
        qy = R[1][0] * X + R[1][1] * Y + R[1][2] * Z + t[1]
        qz = R[2][0] * X + R[2][1] * Y + R[2][2] * Z + t[2]
        iz = 1.0 / jnp.maximum(qz, 1e-6)
        u = fx * qx * iz + cx
        v = fy * qy * iz + cy
        return qx, qy, qz, iz, u - u_obs, v - v_obs

    def chi2_of(qz, ru, rv, u_hat):
        c2 = (ru * ru + rv * rv) * w_obs
        if has_depth:
            rs = (u_hat - bf / jnp.maximum(qz, 1e-6)) - ur_obs
            c2 = c2 + jnp.where(has_s, rs * rs * w_obs, 0.0)
        return c2

    def capped_cost(c2, mask):
        return jnp.sum(jnp.where(mask, jnp.minimum(c2, cap), 0.0))

    def lm_iter(_, carry):
        R, t, lam, mask = carry
        qx, qy, qz, iz, ru, rv = project((R, t))
        u_hat = ru + u_obs
        c2_mono = (ru * ru + rv * rv) * w_obs
        w_hub = jnp.minimum(1.0, jnp.sqrt(delta2 / jnp.maximum(c2_mono, 1e-12)))
        w = jnp.where(mask, w_obs * w_hub, 0.0)
        a = fx * iz
        b = fy * iz
        cu = -fx * qx * iz * iz
        dv = -fy * qy * iz * iz
        # rows of dr/dxi for xi = [rho, phi] (left perturbation); None = 0
        Ju = [a, None, cu, cu * qy, a * qz - cu * qx, -a * qy]
        Jv = [None, b, dv, dv * qy - b * qz, -dv * qx, b * qx]
        blocks = [(Ju, ru, w), (Jv, rv, w)]
        if has_depth:
            # stereo disparity row J_s = J_u + bf/z^2 * [0, 0, 1 | qy, -qx, 0]
            z = jnp.maximum(qz, 1e-6)
            s = bf / (z * z)
            Js = [a, None, cu + s, cu * qy + s * qy, a * qz - cu * qx - s * qx,
                  -a * qy]
            rs = (u_hat - bf / z) - ur_obs
            blocks.append((Js, rs, jnp.where(has_s, w, 0.0)))
        wJ = [[None if J[k] is None else wb * J[k] for k in range(6)]
              for J, _, wb in blocks]

        def wsum(terms):
            terms = [p * q for p, q in terms if p is not None and q is not None]
            return jnp.sum(sum(terms[1:], terms[0])) if terms else 0.0

        H = [[None] * 6 for _ in range(6)]
        for j in range(6):
            for k in range(j, 6):
                H[j][k] = H[k][j] = wsum(
                    [(wJb[j], J[k]) for wJb, (J, _, _) in zip(wJ, blocks)]
                )
            H[j][j] = H[j][j] + lam
        g = [wsum([(wJb[j], r) for wJb, (_, r, _) in zip(wJ, blocks)])
             for j in range(6)]
        delta = _solve_spd6(H, g)
        Re, te = _se3_exp([-d for d in delta])
        R_new = [[sum(Re[i][k] * R[k][j] for k in range(3)) for j in range(3)]
                 for i in range(3)]
        t_new = [sum(Re[i][k] * t[k] for k in range(3)) + te[i]
                 for i in range(3)]
        _, _, qz_n, _, ru_n, rv_n = project((R_new, t_new))
        cost_new = capped_cost(chi2_of(qz_n, ru_n, rv_n, ru_n + u_obs), mask)
        cost_old = capped_cost(chi2_of(qz, ru, rv, u_hat), mask)
        better = cost_new < cost_old
        R = [[jnp.where(better, R_new[i][j], R[i][j]) for j in range(3)]
             for i in range(3)]
        t = [jnp.where(better, t_new[i], t[i]) for i in range(3)]
        lam = jnp.clip(jnp.where(better, lam * 0.5, lam * 4.0), 1e-8, 1e4)
        return R, t, lam, mask

    def round_body(_, carry):
        R, t, mask = carry
        R, t, _, _ = jax.lax.fori_loop(
            0, iters, lm_iter, (R, t, jnp.float32(1e-3), mask)
        )
        _, _, qz, _, ru, rv = project((R, t))
        c2 = chi2_of(qz, ru, rv, ru + u_obs)
        mask = valid & (c2 < delta2) & (qz > 0.0)
        return R, t, mask

    R0 = [[pose_ref[4 * i + j] for j in range(3)] for i in range(3)]
    t0 = [pose_ref[4 * i + 3] for i in range(3)]
    R, t, mask = jax.lax.fori_loop(0, rounds, round_body, (R0, t0, valid))
    flat = [R[0][0], R[0][1], R[0][2], t[0], R[1][0], R[1][1], R[1][2], t[1],
            R[2][0], R[2][1], R[2][2], t[2], 0.0, 0.0, 0.0, 1.0]
    slot = jnp.arange(16, dtype=jnp.int32)
    out = jnp.zeros((16,), jnp.float32)
    for k, v in enumerate(flat):
        out = jnp.where(slot == k, v, out)
    pose_out[...] = out
    mask_out[...] = mask.astype(jnp.float32)


def padded_points(b: int) -> int:
    """Power-of-two block width for b points (Triton blocks are 2^k)."""
    return max(16, 1 << (b - 1).bit_length())


@functools.partial(
    jax.jit,
    static_argnames=("iters", "rounds", "has_depth", "interpret"),
)
def motion_only_lm_fused(
    pose_init: jnp.ndarray,  # (4, 4)
    pts3d: jnp.ndarray,  # (B, 3)
    uv: jnp.ndarray,  # (B, 2)
    sigma2: jnp.ndarray,  # (B,)
    valid: jnp.ndarray,  # (B,) bool
    fx,
    fy,
    cx,
    cy,
    depth: jnp.ndarray | None = None,
    bf=None,
    iters: int = 10,
    rounds: int = 4,
    has_depth: bool = False,
    interpret: bool = False,
):
    """Fused motion_only_lm. Returns (pose (4,4), inliers (B,) bool)."""
    B = pts3d.shape[0]
    Bp = padded_points(B)
    pad = Bp - B
    f32 = jnp.float32
    rows = [
        pts3d[:, 0], pts3d[:, 1], pts3d[:, 2], uv[:, 0], uv[:, 1],
        1.0 / jnp.maximum(sigma2, 1e-9), valid,
        depth if depth is not None else jnp.zeros((B,)),
    ]
    data = jnp.pad(jnp.stack([r.astype(f32) for r in rows]), ((0, 0), (0, pad)))
    cam_vec = jnp.stack(
        [f32(fx), f32(fy), f32(cx), f32(cy), f32(bf if bf is not None else 0.0)]
        + [f32(0)] * 3
    )
    kernel = functools.partial(
        _lm_kernel, iters=iters, rounds=rounds, has_depth=has_depth,
        delta2=float(CHI2_3D if has_depth else CHI2_2D),
    )
    pose, maskf = pl.pallas_call(
        kernel,
        out_shape=[
            jax.ShapeDtypeStruct((16,), f32),
            jax.ShapeDtypeStruct((Bp,), f32),
        ],
        backend="triton",
        compiler_params=pl_triton.CompilerParams(num_warps=NUM_WARPS, num_stages=1),
        interpret=interpret,
        name="motion_only_lm",
    )(cam_vec, pose_init.astype(f32).reshape(16), data)
    return pose.reshape(4, 4), maskf[:B] > 0.5
