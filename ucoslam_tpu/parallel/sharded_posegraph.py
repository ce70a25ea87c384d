"""Distributed Sim3 pose-graph relaxation over a device mesh.

Companion of parallel/sharded_ba.py for the loop-closure solver (reference
`loopClosurePathOptimizationg2o`, graphoptsim3.cpp:74-168 — single-threaded
g2o there; SURVEY.md §2.3: the distributed axis is NEW capability):

- relative-Sim3 EDGES shard across the mesh axis ("pt");
- keyframe Sim3 vertices replicate (K is small);
- each device scatters its edge shard's 7x7 LM blocks into a local
  (K, K, 7, 7) Hessian, `psum`s H/b/cost, solves the damped dense 7K
  system redundantly, and `psum`s the candidate cost for the LM
  accept/reject — two collectives per iteration;
- the whole fixed-iteration loop runs inside ONE shard_map'd lax.scan, so
  a solve is a single dispatch regardless of iteration count.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ucoslam_tpu.geometry.sim3 import sim3_exp
from ucoslam_tpu.optim.posegraph import PoseGraphProblem, _edge_residual


def shard_pose_graph_problem(problem: PoseGraphProblem, n_shards: int) -> PoseGraphProblem:
    """Pad the edge arrays so they split evenly across `n_shards`."""
    E = problem.edge_i.shape[0]
    per = -(-E // n_shards)
    pad = per * n_shards - E

    def pad_e(x, fill=0):
        arr = np.asarray(x)
        padding = np.full((pad,) + arr.shape[1:], fill, arr.dtype)
        return jnp.asarray(np.concatenate([arr, padding]))

    eye = np.tile(np.eye(4, dtype=np.float32), (pad, 1, 1))
    return problem._replace(
        edge_i=pad_e(problem.edge_i),
        edge_j=pad_e(problem.edge_j),
        edge_meas=jnp.asarray(
            np.concatenate([np.asarray(problem.edge_meas), eye])
        ),
        edge_weight=pad_e(problem.edge_weight),
        edge_valid=pad_e(np.asarray(problem.edge_valid), fill=False),
    )


@partial(jax.jit, static_argnames=("mesh", "iters", "fix_scale"))
def sharded_pose_graph_solve(
    problem: PoseGraphProblem,
    mesh: Mesh,
    iters: int = 20,
    fix_scale: bool = False,
) -> jnp.ndarray:
    """Distributed Gauss-Newton; returns optimized (K, 4, 4) Sim3 poses.

    `problem` must come from shard_pose_graph_problem(mesh size). One
    program is compiled per mesh, shapes and settings.
    """
    K = problem.poses.shape[0]
    zero7 = jnp.zeros(7)
    axis = mesh.axis_names[0]

    def _residuals(poses, edge_i, edge_j, edge_meas):
        Si = poses[edge_i]
        Sj = poses[edge_j]
        return jax.vmap(
            lambda Si_e, Sj_e, meas_e: _edge_residual(
                zero7, zero7, Si_e, Sj_e, meas_e
            )
        )(Si, Sj, edge_meas)

    def local_step(carry, free, edge_i, edge_j, edge_meas, edge_w, edge_valid):
        poses, lam = carry
        Si = poses[edge_i]
        Sj = poses[edge_j]

        def per_edge(Si_e, Sj_e, meas_e):
            r = _edge_residual(zero7, zero7, Si_e, Sj_e, meas_e)
            Ji = jax.jacfwd(lambda d: _edge_residual(d, zero7, Si_e, Sj_e, meas_e))(zero7)
            Jj = jax.jacfwd(lambda d: _edge_residual(zero7, d, Si_e, Sj_e, meas_e))(zero7)
            return r, Ji, Jj

        r, Ji, Jj = jax.vmap(per_edge)(Si, Sj, edge_meas)
        w = edge_w * edge_valid
        if fix_scale:
            scale_mask = jnp.ones(7).at[6].set(0.0)
            Ji = Ji * scale_mask[None, None, :]
            Jj = Jj * scale_mask[None, None, :]

        H = jax.lax.pcast(jnp.zeros((K, K, 7, 7)), (axis,), to="varying")
        H = H.at[edge_i, edge_i].add(jnp.einsum("eri,erj,e->eij", Ji, Ji, w))
        H = H.at[edge_j, edge_j].add(jnp.einsum("eri,erj,e->eij", Jj, Jj, w))
        H = H.at[edge_i, edge_j].add(jnp.einsum("eri,erj,e->eij", Ji, Jj, w))
        H = H.at[edge_j, edge_i].add(jnp.einsum("eri,erj,e->eij", Jj, Ji, w))
        b = jax.lax.pcast(jnp.zeros((K, 7)), (axis,), to="varying")
        b = b.at[edge_i].add(jnp.einsum("eri,er,e->ei", Ji, r, w))
        b = b.at[edge_j].add(jnp.einsum("eri,er,e->ei", Jj, r, w))
        local_cost = jnp.sum(w * jnp.sum(r * r, -1))

        # collective 1/2: reduced system + current cost
        H = jax.lax.psum(H, axis)
        b = jax.lax.psum(b, axis)
        cur_cost = jax.lax.psum(local_cost, axis)

        mask = free[:, None] & jnp.ones((K, 7), bool)
        if fix_scale:
            mask = mask & (jnp.arange(7)[None, :] != 6)
        mflat = mask.reshape(-1)
        H_full = H.transpose(0, 2, 1, 3).reshape(7 * K, 7 * K)
        H_full = jnp.where(mflat[:, None] & mflat[None, :], H_full, 0.0)
        diag = jnp.diag(H_full)
        # LM damping (matches optim.posegraph.pose_graph_solve)
        H_full = H_full + jnp.diag(
            jnp.where(mflat, 1e-6 + lam * jnp.maximum(diag, 1e-8), 1.0)
        )
        b_flat = jnp.where(mflat, b.reshape(-1), 0.0)
        delta = jnp.linalg.solve(H_full, b_flat).reshape(K, 7)
        delta = jnp.where(mask, delta, 0.0)
        cand = jnp.where(free[:, None, None], sim3_exp(-delta) @ poses, poses)
        # collective 2/2: candidate cost for the LM accept/reject
        r_new = _residuals(cand, edge_i, edge_j, edge_meas)
        new_cost = jax.lax.psum(jnp.sum(w * jnp.sum(r_new * r_new, -1)), axis)
        accept = new_cost < cur_cost
        poses = jnp.where(accept, cand, poses)
        lam = jnp.clip(jnp.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e6)
        return (poses, lam), jnp.where(accept, new_cost, cur_cost)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P(axis), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P()),
    )
    def run(poses, fixed, edge_i, edge_j, edge_meas, edge_w, edge_valid):
        free = ~fixed

        def body(carry, _):
            return local_step(carry, free, edge_i, edge_j, edge_meas, edge_w, edge_valid)

        (poses, _), costs = jax.lax.scan(
            body, (poses, jnp.float32(1e-4)), None, length=iters
        )
        return poses, costs

    poses, costs = run(
        problem.poses, problem.fixed, problem.edge_i, problem.edge_j,
        problem.edge_meas, problem.edge_weight,
        problem.edge_valid.astype(jnp.float32),
    )
    return poses
