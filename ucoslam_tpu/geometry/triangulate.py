"""Batched two-view triangulation with chi-square acceptance gates.

Counterpart of the reference `Triangulate` (misc.cpp:923) and the gated
`triangulate_` (misc.cpp:1043). DLT on the 4x4 system built from two
projection equations; the nullspace vector is taken from an eigendecomposition
of A^T A (4x4 symmetric — cheap and batched on the device, avoiding general SVD).
"""

from __future__ import annotations

import jax.numpy as jnp

from ucoslam_tpu.config import CHI2_2D
from ucoslam_tpu.geometry.camera import CameraParams
from ucoslam_tpu.geometry.se3 import se3_apply


def _projection_rows(T_g2c: jnp.ndarray, cam: CameraParams) -> jnp.ndarray:
    """3x4 projection matrix P = K [R|t] for pose global->camera."""
    return cam.K @ T_g2c[..., :3, :4]


def triangulate_dlt(
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    P1: jnp.ndarray,
    P2: jnp.ndarray,
) -> jnp.ndarray:
    """DLT triangulation.

    uv1, uv2: (..., 2) undistorted pixel observations.
    P1, P2: (..., 3, 4) projection matrices (broadcastable).
    Returns world points (..., 3).
    """
    rows = [
        uv1[..., 0:1, None] * P1[..., 2:3, :] - P1[..., 0:1, :],
        uv1[..., 1:2, None] * P1[..., 2:3, :] - P1[..., 1:2, :],
        uv2[..., 0:1, None] * P2[..., 2:3, :] - P2[..., 0:1, :],
        uv2[..., 1:2, None] * P2[..., 2:3, :] - P2[..., 1:2, :],
    ]
    A = jnp.concatenate(rows, axis=-2)  # (..., 4, 4)
    # Nullspace via smallest eigenvector of A^T A (symmetric 4x4).
    AtA = jnp.swapaxes(A, -1, -2) @ A
    _, vecs = jnp.linalg.eigh(AtA)
    X_h = vecs[..., :, 0]  # eigenvector of the smallest eigenvalue
    w = X_h[..., 3]
    w = jnp.where(jnp.abs(w) < 1e-12, 1e-12, w)
    return X_h[..., :3] / w[..., None]


def triangulate_checked(
    uv1: jnp.ndarray,
    uv2: jnp.ndarray,
    T1_g2c: jnp.ndarray,
    T2_g2c: jnp.ndarray,
    cam1: CameraParams,
    cam2: CameraParams,
    sigma2_1: jnp.ndarray,
    sigma2_2: jnp.ndarray,
    min_cos_parallax: float = 0.9998,
):
    """Triangulate + acceptance gates of the reference's triangulate_
    (misc.cpp:1043): positive depth in both views, reprojection chi2 below
    CHI2_2D * sigma^2 in both views, and sufficient parallax.

    Returns (X (..., 3), ok (...,) bool).
    """
    P1 = _projection_rows(T1_g2c, cam1)
    P2 = _projection_rows(T2_g2c, cam2)
    X = triangulate_dlt(uv1, uv2, P1, P2)

    Xc1 = se3_apply(T1_g2c, X)
    Xc2 = se3_apply(T2_g2c, X)
    z_ok = (Xc1[..., 2] > 0) & (Xc2[..., 2] > 0)

    r1 = cam1.project(Xc1) - uv1
    r2 = cam2.project(Xc2) - uv2
    chi1 = jnp.sum(r1 * r1, -1) / jnp.maximum(sigma2_1, 1e-12)
    chi2 = jnp.sum(r2 * r2, -1) / jnp.maximum(sigma2_2, 1e-12)
    reproj_ok = (chi1 < CHI2_2D) & (chi2 < CHI2_2D)

    # Parallax: angle between the two viewing rays.
    c1 = -jnp.swapaxes(T1_g2c[..., :3, :3], -1, -2) @ T1_g2c[..., :3, 3:4]
    c2 = -jnp.swapaxes(T2_g2c[..., :3, :3], -1, -2) @ T2_g2c[..., :3, 3:4]
    ray1 = X - c1[..., 0]
    ray2 = X - c2[..., 0]
    cosp = jnp.sum(ray1 * ray2, -1) / (
        jnp.linalg.norm(ray1, axis=-1) * jnp.linalg.norm(ray2, axis=-1)
    ).clip(1e-12)
    parallax_ok = cosp < min_cos_parallax

    return X, z_ok & reproj_ok & parallax_ok
