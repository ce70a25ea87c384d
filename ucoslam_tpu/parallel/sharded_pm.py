"""Distributed point-major Schur BA — the big-map solver over a mesh.

Communication-avoiding by construction (the general sharded solver's
matrix-free CG pays one latency-bound (V, 6) psum per CG iteration):

- point rows (and every per-point quantity: the (P, MO) observation
  grid, Hpp marginalization, back-substitution) shard across the "pt"
  mesh axis with NO communication — an observation lives on its point's
  shard by the point-major layout itself;
- the block-sparse reduced camera system (the unique-camera-pair S
  blocks of optim/schur_pm.py) is psum'd ONCE PER RELINEARIZATION
  (every `relin_every` LM steps), payload NP x 36 floats;
- each LM step psums only the packed (V, 12) gradient reduction and the
  scalar acceptance cost — two latency-bound collectives per step;
- the PCG loop runs on fully REPLICATED V-sized data: zero collectives
  per CG iteration.

The LM/CG implementation is optim.schur_pm.pm_staged_lm itself (psum
parameter) — the sharded path can never drift from the single-chip
solver (same pattern as parallel/sharded_ba.py).
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from ucoslam_tpu.geometry.camera import CameraParams
from ucoslam_tpu.optim.schur_pm import PMProblem, pm_staged_lm


class ShardedPM(NamedTuple):
    """A PMProblem regrouped for `n_shards` devices.

    Point-indexed arrays are padded so the P axis divides evenly; the
    camera->obs table and the pair-contribution tables are rebuilt as
    per-shard LOCAL tables stacked on axis 0 (sharding hands each device
    its own block). V-indexed arrays (cam_*, vp_*) replicate.
    """

    pm: PMProblem  # with padded P rows; cam_obs/pair tables = stacked locals
    n_shards: int


def shard_pm_problem(pm: PMProblem, n_shards: int) -> ShardedPM:
    """Regroup a PMProblem for a point-sharded mesh (host-side numpy)."""
    P_, MO = pm.o_cam.shape
    V = pm.cam_pose.shape[0]
    p_per = -(-P_ // n_shards)
    P_pad = p_per * n_shards

    def pad_rows(x, fill=0):
        x = np.asarray(x)
        if P_pad == P_:
            return x
        pad = np.full((P_pad - P_,) + x.shape[1:], fill, x.dtype)
        return np.concatenate([x, pad])

    o_cam = pad_rows(pm.o_cam, fill=V)  # V = pad sentinel
    o_valid = pad_rows(pm.o_valid, fill=False)

    # ---- per-shard camera->local-flat-obs tables ----------------------
    cam_obs_g = np.asarray(pm.cam_obs)  # (V, CO) global flat ids (-1 pad)
    flat_shard = cam_obs_g // (p_per * MO)  # shard of each referenced obs
    tables = []
    co_max = 1
    for s in range(n_shards):
        mine = (cam_obs_g >= 0) & (flat_shard == s)
        counts = mine.sum(1)
        co = max(int(counts.max()) if counts.size else 1, 1)
        co_max = max(co_max, co)
        tables.append(mine)
    co_max = 1 << (co_max - 1).bit_length()  # power-of-two bucket
    cam_obs_loc = np.full((n_shards * V, co_max), -1, np.int64)
    for s in range(n_shards):
        mine = tables[s]
        for v in range(V):
            ids = cam_obs_g[v][mine[v]] - s * p_per * MO
            cam_obs_loc[s * V + v, : len(ids)] = ids

    # ---- per-shard pair-contribution tables ---------------------------
    # contributions (both slots of a pair contribution belong to the SAME
    # point, hence the same shard); out-of-shard contributions mask to -1
    # and the cross-shard sum happens in the S_blocks psum
    pair_m1 = np.asarray(pm.pair_m1)
    pair_m2 = np.asarray(pm.pair_m2)
    NPb, CP = pair_m1.shape
    m_shard = np.where(pair_m1 >= 0, pair_m1 // (p_per * MO), -1)
    pair_m1_loc = np.full((n_shards * NPb, CP), -1, np.int64)
    pair_m2_loc = np.full((n_shards * NPb, CP), -1, np.int64)
    for s in range(n_shards):
        mine = m_shard == s
        off = s * p_per * MO
        pair_m1_loc[s * NPb : (s + 1) * NPb] = np.where(mine, pair_m1 - off, -1)
        pair_m2_loc[s * NPb : (s + 1) * NPb] = np.where(mine, pair_m2 - off, -1)

    new_pm = pm._replace(
        pt_pos=jnp.asarray(pad_rows(pm.pt_pos)),
        pt_valid=jnp.asarray(pad_rows(pm.pt_valid, fill=False)),
        o_cam=jnp.asarray(o_cam.astype(np.int32)),
        o_uv=jnp.asarray(pad_rows(pm.o_uv)),
        o_sigma2=jnp.asarray(pad_rows(pm.o_sigma2, fill=1.0)),
        o_depth=jnp.asarray(pad_rows(pm.o_depth)),
        o_valid=jnp.asarray(o_valid),
        o_src=jnp.asarray(pad_rows(pm.o_src, fill=-1)),
        cam_obs=jnp.asarray(cam_obs_loc.astype(np.int32)),
        pair_m1=jnp.asarray(pair_m1_loc.astype(np.int32)),
        pair_m2=jnp.asarray(pair_m2_loc.astype(np.int32)),
    )
    return ShardedPM(pm=new_pm, n_shards=n_shards)


def sharded_pm_solve(
    spm: ShardedPM,
    cam: CameraParams,
    mesh: Mesh,
    iters: int = 20,
    stages: int = 2,
    cg_iters: int = 32,
    relin_every: int = 6,
):
    """Run the point-major staged LM over `mesh`.

    Returns (cam_pose, pt_pos, costs, c2, bad) with pt_pos/c2/bad in the
    PADDED point order of spm.pm (rows beyond the original P are pads).
    """
    return _sharded_pm_lm(
        spm.pm, cam, mesh=mesh, iters=iters, stages=stages,
        cg_iters=cg_iters, relin_every=relin_every,
    )


@partial(jax.jit, static_argnames=("mesh", "iters", "stages", "cg_iters", "relin_every"))
def _sharded_pm_lm(pm, cam, *, mesh, iters, stages, cg_iters, relin_every):
    """One compiled program per (mesh, shapes, LM settings); later calls
    with the same ones reuse it."""
    axis = mesh.axis_names[0]
    sh, repl = P(axis), P()
    in_spec = PMProblem(
        cam_pose=repl, cam_fixed=repl, cam_valid=repl,
        pt_pos=sh, pt_valid=sh,
        o_cam=sh, o_uv=sh, o_sigma2=sh, o_depth=sh, o_valid=sh, o_src=sh,
        bf=repl,
        cam_obs=sh,  # stacked per-shard local tables
        pair_m1=sh, pair_m2=sh,
        vp_pair=repl, vp_other=repl, vp_trans=repl,
    )

    def local_psum(x):
        return jax.tree_util.tree_map(lambda y: jax.lax.psum(y, axis), x)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(in_spec, repl),
        out_specs=(repl, sh, repl, sh, sh),
    )
    def run(local, cam):
        return pm_staged_lm(
            local, cam, iters=iters, stages=stages, cg_iters=cg_iters,
            relin_every=relin_every, psum=local_psum,
        )

    return run(pm, cam)
