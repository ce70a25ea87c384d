"""Sim3 pose-graph relaxation for loop closure.

Counterpart of the reference `loopClosurePathOptimizationg2o`
(graphoptsim3.{h:32,cpp:74-168}): one Sim3 vertex per keyframe (scale fixed
for stereo/RGB-D via the fix-scale switch :108), loop-old side fixed (:105),
relative-Sim3 edges weighted by covisibility (:116-145), LM (:85-153),
poses written back as SE3 = [sR t]/s (:156-165).

Device-native: per-edge 7x7 Jacobian blocks from vmapped forward-mode autodiff
through the Sim3 exp/log chain; Hessian scattered into (K, K, 7, 7) and the
dense 7K system solved in one dense solve (K is keyframe count — small).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ucoslam_tpu.geometry.sim3 import sim3_exp, sim3_inverse, sim3_log


class PoseGraphProblem(NamedTuple):
    poses: jnp.ndarray  # (K, 4, 4) Sim3 (or SE3 with s=1) world->kf
    fixed: jnp.ndarray  # (K,) bool
    edge_i: jnp.ndarray  # (E,) int32
    edge_j: jnp.ndarray  # (E,) int32
    edge_meas: jnp.ndarray  # (E, 4, 4) measured S_i S_j^-1 (Sim3)
    edge_weight: jnp.ndarray  # (E,)
    edge_valid: jnp.ndarray  # (E,) bool


def _edge_residual(di, dj, Si, Sj, meas):
    """r = log( meas^-1 · exp(di) Si · (exp(dj) Sj)^-1 ) — 7-vector."""
    Si_new = sim3_exp(di) @ Si
    Sj_new = sim3_exp(dj) @ Sj
    rel = Si_new @ sim3_inverse(Sj_new)
    return sim3_log(sim3_inverse(meas) @ rel)


@partial(jax.jit, static_argnames=("iters", "fix_scale"))
def pose_graph_solve(
    problem: PoseGraphProblem,
    iters: int = 20,
    fix_scale: bool = False,
) -> jnp.ndarray:
    """Levenberg-Marquardt on the Sim3 pose graph; returns (K, 4, 4).

    Damped steps with cost-based accept/reject (the reference runs LM,
    graphoptsim3.cpp:85-153; a plain GN step on a bad loop hypothesis can
    tear the graph apart and survive only via the caller's chi2 rollback).
    """
    K = problem.poses.shape[0]
    free = ~problem.fixed
    zero7 = jnp.zeros(7)
    w = problem.edge_weight * problem.edge_valid

    def residuals(poses):
        Si = poses[problem.edge_i]
        Sj = poses[problem.edge_j]
        return jax.vmap(
            lambda Si_e, Sj_e, meas_e: _edge_residual(zero7, zero7, Si_e, Sj_e, meas_e)
        )(Si, Sj, problem.edge_meas)

    def cost_of(poses):
        r = residuals(poses)
        return jnp.sum(w * jnp.sum(r * r, -1))

    mask = free[:, None] & jnp.ones((K, 7), bool)
    if fix_scale:
        mask = mask & (jnp.arange(7)[None, :] != 6)
    mflat = mask.reshape(-1)

    def lm_step(carry, _):
        poses, lam = carry
        Si = poses[problem.edge_i]
        Sj = poses[problem.edge_j]

        def per_edge(Si_e, Sj_e, meas_e):
            r = _edge_residual(zero7, zero7, Si_e, Sj_e, meas_e)
            Ji = jax.jacfwd(lambda d: _edge_residual(d, zero7, Si_e, Sj_e, meas_e))(zero7)
            Jj = jax.jacfwd(lambda d: _edge_residual(zero7, d, Si_e, Sj_e, meas_e))(zero7)
            return r, Ji, Jj

        r, Ji, Jj = jax.vmap(per_edge)(Si, Sj, problem.edge_meas)  # (E,7),(E,7,7)x2
        if fix_scale:
            # zero out the scale tangent column (7th dof frozen)
            scale_mask = jnp.ones(7).at[6].set(0.0)
            Ji = Ji * scale_mask[None, None, :]
            Jj = Jj * scale_mask[None, None, :]

        H = jnp.zeros((K, K, 7, 7))
        H = H.at[problem.edge_i, problem.edge_i].add(
            jnp.einsum("eri,erj,e->eij", Ji, Ji, w)
        )
        H = H.at[problem.edge_j, problem.edge_j].add(
            jnp.einsum("eri,erj,e->eij", Jj, Jj, w)
        )
        H = H.at[problem.edge_i, problem.edge_j].add(
            jnp.einsum("eri,erj,e->eij", Ji, Jj, w)
        )
        H = H.at[problem.edge_j, problem.edge_i].add(
            jnp.einsum("eri,erj,e->eij", Jj, Ji, w)
        )
        b = jnp.zeros((K, 7))
        b = b.at[problem.edge_i].add(jnp.einsum("eri,er,e->ei", Ji, r, w))
        b = b.at[problem.edge_j].add(jnp.einsum("eri,er,e->ei", Jj, r, w))

        # freeze fixed vertices (and the scale dof when fix_scale):
        # zero rows/cols of frozen dofs, identity on their diagonal
        H_full = H.transpose(0, 2, 1, 3).reshape(7 * K, 7 * K)
        H_full = jnp.where(mflat[:, None] & mflat[None, :], H_full, 0.0)
        diag = jnp.diag(H_full)
        # LM damping on the (free-dof) diagonal
        H_damped = H_full + jnp.diag(
            jnp.where(mflat, 1e-6 + lam * jnp.maximum(diag, 1e-8), 1.0)
        )
        b_flat = jnp.where(mflat, b.reshape(-1), 0.0)
        delta = jnp.linalg.solve(H_damped, b_flat).reshape(K, 7)
        delta = jnp.where(mask, delta, 0.0)
        cand = jnp.where(free[:, None, None], sim3_exp(-delta) @ poses, poses)
        cur_cost = jnp.sum(w * jnp.sum(r * r, -1))
        new_cost = cost_of(cand)
        accept = new_cost < cur_cost
        poses = jnp.where(accept, cand, poses)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e6)
        return (poses, lam), jnp.where(accept, new_cost, cur_cost)

    init = (problem.poses, jnp.float32(1e-4))
    (poses, _), _ = jax.lax.scan(lm_step, init, None, length=iters)
    return poses


def sim3_to_se3(poses: jnp.ndarray) -> jnp.ndarray:
    """Normalize Sim3 -> SE3: [sR t] -> [R t/s] (graphoptsim3.cpp:156-165)."""
    from ucoslam_tpu.geometry.sim3 import sim3_parts

    s, R, t = sim3_parts(poses)
    out = jnp.zeros_like(poses)
    out = out.at[..., :3, :3].set(R)
    out = out.at[..., :3, 3].set(t / s[..., None])
    out = out.at[..., 3, 3].set(1.0)
    return out
