"""Distributed Schur-complement bundle adjustment over a device mesh.

The genuinely new capability vs the reference (which is single-process,
SURVEY.md §2.3): map-point blocks and their observations shard across the
"pt" mesh axis; keyframe poses and marker vertices replicate. Each device:

1. computes residuals/Jacobians for its observation shard,
2. marginalizes its own 3x3 point blocks locally (no communication),
3. assembles its partial reduced camera system S_local (6V x 6V) and rhs,
4. `psum`s S and rhs over ICI — the ONLY collective per LM step
   (plus the scalar acceptance-cost psum),
5. adds the replicated marker / planar edge blocks once, post-reduction,
6. solves the (replicated) dense reduced system redundantly on every
   device — cheaper than sharding a 6V x 6V solve at SLAM-scale V,
7. back-substitutes its own point shard locally.

The LM loop itself (adaptive damping with accept/reject, two-stage
outlier demotion — the reference's protocol, globaloptimizer_g2o.cpp
:418-461) is `optim.ba._staged_lm`, the SAME implementation the
single-device `ba_solve` runs: this file only provides the observation
regrouping and the shard_map harness, so the sharded path can never drift
behaviorally from the production solver.

Observations must be grouped so all observations of a point live on that
point's device — `shard_ba_problem` reorders and pads per shard.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ucoslam_tpu.geometry.camera import CameraParams
from ucoslam_tpu.optim.ba import BAProblem, BAResult, _staged_lm


def _bucket(n: int, quantum: int) -> int:
    return max(quantum, -(-n // quantum) * quantum)


def shard_ba_problem(problem: BAProblem, n_shards: int) -> BAProblem:
    """Regroup a BAProblem so points (and their obs) block-shard evenly.

    Points keep their order (padded to a multiple of n_shards);
    observations are re-ordered by point shard and padded so each shard
    holds exactly the observations of its own point block. Padding rows
    are invalid observations pointing at in-shard indices. Marker and
    planar edge fields pass through unchanged (replicated).
    """
    P_ = problem.pt_pos.shape[0]
    pt_per = -(-P_ // n_shards)
    P_pad = pt_per * n_shards

    obs_pt = np.asarray(problem.obs_pt)
    shard_of_pt = np.arange(P_pad) // pt_per
    obs_shard = shard_of_pt[obs_pt]

    counts = np.bincount(obs_shard, minlength=n_shards)
    o_per = _bucket(int(counts.max()) if len(counts) else 1, 128)
    by_shard = np.argsort(obs_shard, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)])
    order = np.zeros(n_shards * o_per, np.int64)  # pad rows reuse obs 0
    pad_mask = np.zeros(n_shards * o_per, bool)
    for s in range(n_shards):
        ix = by_shard[starts[s] : starts[s + 1]]
        order[s * o_per : s * o_per + len(ix)] = ix
        pad_mask[s * o_per : s * o_per + len(ix)] = True

    def pad_pts(x, fill=0):
        x = np.asarray(x)
        pad = np.full((P_pad - P_,) + x.shape[1:], fill, x.dtype)
        return jnp.asarray(np.concatenate([x, pad]))

    new_obs_pt = obs_pt[order]
    # padded invalid obs must reference a point INSIDE the shard they sit in
    row_shard = np.repeat(np.arange(n_shards), o_per)
    new_obs_pt = np.where(pad_mask, new_obs_pt, row_shard * pt_per)

    # rebuild the per-point obs table in the new (sharded-global) ordering
    MO = problem.pt_obs.shape[1]
    pt_obs = np.full((P_pad, MO), -1, np.int32)
    rows = np.nonzero(pad_mask)[0]
    pts = new_obs_pt[rows]
    order2 = np.argsort(pts, kind="stable")
    rows_s, pts_s = rows[order2], pts[order2]
    if len(pts_s):
        first = np.concatenate([[True], pts_s[1:] != pts_s[:-1]])
        grp_start = np.maximum.accumulate(
            np.where(first, np.arange(len(pts_s)), 0)
        )
        rank = np.arange(len(pts_s)) - grp_start
        keep = rank < MO
        pt_obs[pts_s[keep], rank[keep]] = rows_s[keep]

    def reorder(x):
        return jnp.asarray(np.asarray(x)[order])

    # per-shard camera->local-obs tables, stacked on axis 0 so the "pt"
    # sharding hands each device its own (K, CO) block
    from ucoslam_tpu.optim.ba import _build_cam_obs

    K = problem.cam_pose.shape[0]
    new_obs_cam = np.asarray(problem.obs_cam)[order]
    new_obs_valid = np.asarray(problem.obs_valid)[order] & pad_mask
    tables = []
    for s in range(n_shards):
        lo = s * o_per
        loc_cam = new_obs_cam[lo : lo + o_per].copy()
        loc_cam[~new_obs_valid[lo : lo + o_per]] = -1  # pad rows excluded
        tables.append(_build_cam_obs(loc_cam, K, o_per))
    co_max = max(t.shape[1] for t in tables)
    cam_obs = np.full((n_shards * K, co_max), -1, np.int32)
    for s, t in enumerate(tables):
        cam_obs[s * K : (s + 1) * K, : t.shape[1]] = t

    return problem._replace(
        pt_pos=pad_pts(problem.pt_pos),
        pt_valid=pad_pts(np.asarray(problem.pt_valid), fill=False),
        obs_cam=jnp.asarray(new_obs_cam),
        obs_pt=jnp.asarray(new_obs_pt.astype(np.int32)),
        obs_uv=reorder(problem.obs_uv),
        obs_sigma2=reorder(problem.obs_sigma2),
        obs_depth=reorder(problem.obs_depth),
        obs_valid=jnp.asarray(new_obs_valid),
        pt_obs=jnp.asarray(pt_obs),
        cam_obs=jnp.asarray(cam_obs),
    )


@partial(jax.jit, static_argnames=("mesh", "iters", "stages", "solver", "cg_iters"))
def sharded_ba_solve(
    problem: BAProblem,
    cam: CameraParams,
    mesh: Mesh,
    iters: int = 20,
    stages: int = 2,
    solver: str = "auto",
    cg_iters: int = 32,
) -> BAResult:
    """Run the full staged-LM Schur BA distributed over `mesh`.

    `problem` must come from shard_ba_problem(mesh size). Returns a
    BAResult whose obs_chi2 / obs_bad are in the SHARDED observation order
    (pair them with the sharded problem, as apply_ba_result does). One
    program is compiled per mesh, shapes and LM settings.
    """
    n = mesh.devices.size
    axis = mesh.axis_names[0]
    has_mk = problem.mk_pose is not None
    has_plan = has_mk and problem.plan_ref is not None

    O = problem.obs_cam.shape[0]
    P_ = problem.pt_pos.shape[0]
    o_per = O // n
    pt_per = P_ // n

    # convert global (sharded-order) indices to per-shard local indices
    obs_shard = jnp.arange(O, dtype=jnp.int32) // o_per
    pt_shard = jnp.arange(P_, dtype=jnp.int32) // pt_per
    prob = problem._replace(
        obs_pt=(problem.obs_pt - obs_shard * pt_per).astype(jnp.int32),
        pt_obs=jnp.where(
            problem.pt_obs >= 0,
            problem.pt_obs - (pt_shard * o_per)[:, None],
            -1,
        ).astype(jnp.int32),
    )

    sh, repl = P(axis), P()
    mk_specs = {}
    if has_mk:
        mk_specs = dict(
            mk_pose=repl, mk_fixed=repl, mk_valid=repl, mk_obj=repl,
            mobs_cam=repl, mobs_mk=repl, mobs_uv=repl, mobs_w=repl,
            mobs_valid=repl,
        )
        if has_plan:
            mk_specs.update(
                plan_ref=repl, plan_other=repl, plan_w=repl, plan_valid=repl
            )
    in_spec = BAProblem(
        cam_pose=repl, cam_fixed=repl, cam_valid=repl,
        pt_pos=sh, pt_valid=sh,
        obs_cam=sh, obs_pt=sh, obs_uv=sh, obs_sigma2=sh,
        obs_depth=sh, obs_valid=sh, pt_obs=sh, bf=repl,
        cam_obs=None if problem.cam_obs is None else sh,
        **mk_specs,
    )

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(in_spec, repl),
        out_specs=(repl, repl, sh, repl, sh, sh),
    )
    def run(local, cam):
        return _staged_lm(
            local, cam, iters, stages,
            psum=lambda x: jax.lax.psum(x, axis),
            solver=solver, cg_iters=cg_iters,
        )

    cam_pose, mk_pose, pt_pos, costs, c2, bad = run(prob, cam)
    return BAResult(
        cam_pose=cam_pose,
        pt_pos=pt_pos,
        obs_chi2=c2,
        obs_bad=bad,
        cost_history=costs,
        mk_pose=mk_pose if has_mk else None,
    )
