"""Distributed BA over the 8-device virtual CPU mesh.

The sharded solver runs the SAME staged-LM core as the single-device
ba_solve (optim.ba._staged_lm), so these tests gate on equivalence:
same convergence, same outlier demotion, same marker refinement, and the
production global_bundle_adjustment entry point dispatching to the mesh.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from ucoslam_tpu.parallel import make_mesh, shard_ba_problem, sharded_ba_solve
from ucoslam_tpu.optim.ba import (
    ba_solve,
    build_ba_problem,
    global_bundle_adjustment,
    set_ba_mesh,
)

from test_ba import CAM, centers, make_problem, build_marker_map


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    return make_mesh(8)


def test_sharded_matches_single_device(mesh):
    from ucoslam_tpu.geometry import ate_rmse

    problem, poses_true, X = make_problem(n_kf=6, n_pt=160, noise_px=0.3)
    sharded = shard_ba_problem(problem, 8)
    res_sh = sharded_ba_solve(sharded, CAM, mesh, iters=12, stages=1)
    costs = np.asarray(res_sh.cost_history)
    assert costs[-1] < costs[0]
    ate = ate_rmse(centers(np.asarray(res_sh.cam_pose)), centers(poses_true))
    assert ate < 3e-3, f"sharded BA aligned ATE {ate}"
    # agreement with the single-device solver
    res = ba_solve(problem, CAM, iters=12, stages=1)
    ate_ref = ate_rmse(
        centers(np.asarray(res.cam_pose)), centers(np.asarray(res_sh.cam_pose))
    )
    assert ate_ref < 2e-3, f"sharded vs single disagreement {ate_ref}"


def test_sharded_two_stage_outlier_demotion(mesh):
    """Outliers must be demoted between stages on the sharded path too."""
    problem, poses_true, X = make_problem(
        n_kf=6, n_pt=160, noise_px=0.3, outlier_frac=0.1
    )
    sharded = shard_ba_problem(problem, 8)
    res_sh = sharded_ba_solve(sharded, CAM, mesh, iters=10, stages=2)
    res = ba_solve(problem, CAM, iters=10, stages=2)
    # both paths flag (almost exactly) the same bad associations
    n_bad_sh = int(np.asarray(res_sh.obs_bad).sum())
    n_bad = int(np.asarray(res.obs_bad).sum())
    assert abs(n_bad_sh - n_bad) <= max(2, 0.05 * n_bad), (n_bad_sh, n_bad)
    from ucoslam_tpu.geometry import ate_rmse

    ate = ate_rmse(centers(np.asarray(res_sh.cam_pose)), centers(poses_true))
    assert ate < 5e-3, f"sharded BA with outliers ATE {ate}"


def test_sharded_marker_vertices_match_single(mesh):
    """Map WITH markers: the sharded production path refines marker SE3
    vertices identically to the single-device solver."""
    m, mk_true, obj, _ = build_marker_map()
    problem, kf_slots, pt_slots, mk_slots = build_ba_problem(m, CAM)
    assert len(mk_slots) == 2
    res = ba_solve(problem, CAM, iters=20)
    sharded = shard_ba_problem(problem, 8)
    res_sh = sharded_ba_solve(sharded, CAM, mesh, iters=20)
    # marker poses agree between paths and approach the truth
    for i in range(2):
        d = np.abs(np.asarray(res.mk_pose[i]) - np.asarray(res_sh.mk_pose[i]))
        assert d.max() < 5e-3, (i, d.max())
        w_est = obj @ np.asarray(res_sh.mk_pose[i])[:3, :3].T + np.asarray(
            res_sh.mk_pose[i]
        )[:3, 3]
        w_true = obj @ mk_true[i][:3, :3].T + mk_true[i][:3, 3]
        assert np.linalg.norm(w_est - w_true, axis=-1).mean() < 0.01


def test_global_ba_dispatches_to_mesh(mesh):
    """Production entry point: global_bundle_adjustment runs the sharded
    solver when a mesh is forced, and improves the map like single-device."""
    m, mk_true, obj, _ = build_marker_map()
    m2, _, _, _ = build_marker_map()

    def corner_err(m):
        mk_pose = np.asarray(m.state.mk_pose)[:2]
        errs = []
        for i in range(2):
            w_est = obj @ mk_pose[i][:3, :3].T + mk_pose[i][:3, 3]
            w_true = obj @ mk_true[i][:3, :3].T + mk_true[i][:3, 3]
            errs.append(np.linalg.norm(w_est - w_true, axis=-1).mean())
        return float(np.mean(errs))

    err0 = corner_err(m)
    try:
        set_ba_mesh(mesh)
        n_bad_sh = global_bundle_adjustment(m, CAM, n_iters=20)
    finally:
        set_ba_mesh(None)
    n_bad = global_bundle_adjustment(m2, CAM, n_iters=20)
    err_sh, err_single = corner_err(m), corner_err(m2)
    assert err_sh < err0 * 0.2, (err0, err_sh)
    assert abs(err_sh - err_single) < 2e-3, (err_sh, err_single)
    assert abs(n_bad_sh - n_bad) <= max(2, 0.1 * max(n_bad, 1))
    pose_d = np.abs(
        np.asarray(m.state.kf_pose)[:6] - np.asarray(m2.state.kf_pose)[:6]
    )
    assert pose_d.max() < 1e-2, pose_d.max()


def test_shard_problem_preserves_observations(mesh):
    problem, _, _ = make_problem(n_kf=4, n_pt=100)
    sharded = shard_ba_problem(problem, 8)
    assert int(sharded.obs_valid.sum()) == int(problem.obs_valid.sum())
    # every valid obs points at a point in its own shard
    n = 8
    o_per = sharded.obs_cam.shape[0] // n
    p_per = sharded.pt_pos.shape[0] // n
    obs_shard = np.arange(sharded.obs_cam.shape[0]) // o_per
    pt_shard = np.asarray(sharded.obs_pt) // p_per
    v = np.asarray(sharded.obs_valid)
    assert (obs_shard[v] == pt_shard[v]).all()
    # the per-point obs table references each valid obs exactly once
    tbl = np.asarray(sharded.pt_obs)
    entries = tbl[tbl >= 0]
    assert len(entries) == len(set(entries.tolist()))
    assert set(entries.tolist()) == set(np.nonzero(v)[0].tolist())


def test_sharded_cg_matches_single(mesh):
    """The at-scale CG path under shard_map: one (V, 6) psum per CG iter."""
    from ucoslam_tpu.geometry import ate_rmse

    problem, poses_true, X = make_problem(n_kf=6, n_pt=160, noise_px=0.3)
    sharded = shard_ba_problem(problem, 8)
    res_sh = sharded_ba_solve(
        sharded, CAM, mesh, iters=12, stages=1, solver="cg", cg_iters=40
    )
    costs = np.asarray(res_sh.cost_history)
    assert costs[-1] < costs[0]
    res = ba_solve(problem, CAM, iters=12, stages=1, solver="dense")
    ate = ate_rmse(
        centers(np.asarray(res.cam_pose)), centers(np.asarray(res_sh.cam_pose))
    )
    assert ate < 2e-3, f"sharded-CG vs single-dense disagreement {ate}"
