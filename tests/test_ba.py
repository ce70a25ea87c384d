"""Bundle adjustment tests: Schur LM convergence, map integration."""

import numpy as np
import pytest
import jax.numpy as jnp

from ucoslam_tpu.config import Params
from ucoslam_tpu.geometry import CameraParams, se3_exp, se3_apply
from ucoslam_tpu.mapping import Map
from ucoslam_tpu.mapping.frame import empty_frame
from ucoslam_tpu.optim.ba import (
    BAProblem,
    ba_solve,
    build_ba_problem,
    global_bundle_adjustment,
    local_bundle_adjustment,
)

RNG = np.random.default_rng(51)
CAM = CameraParams.create(500.0, 500.0, 320.0, 240.0)


def make_problem(n_kf=6, n_pt=150, noise_px=0.5, pose_noise=0.02, pt_noise=0.05,
                 depth_frac=0.0, outlier_frac=0.0):
    """Synthetic BA problem with every point seen by every keyframe."""
    X = RNG.uniform(-2, 2, (n_pt, 3)).astype(np.float32)
    X[:, 2] = RNG.uniform(4, 9, n_pt)
    poses_true, obs = [], []
    for k in range(n_kf):
        xi = np.array([0.4 * k / n_kf - 0.2, 0.02 * k, 0.0, 0.0, -0.04 * k / n_kf, 0.0])
        T = np.asarray(se3_exp(jnp.asarray(xi, jnp.float32)))
        poses_true.append(T)
        uv = np.asarray(CAM.project(se3_apply(jnp.asarray(T), jnp.asarray(X))))
        obs.append(uv + RNG.normal(0, noise_px, uv.shape))
    poses_true = np.stack(poses_true)

    obs_cam = np.repeat(np.arange(n_kf, dtype=np.int32), n_pt)
    obs_pt = np.tile(np.arange(n_pt, dtype=np.int32), n_kf)
    obs_uv = np.concatenate(obs, 0).astype(np.float32)
    if outlier_frac > 0:
        out = RNG.random(len(obs_uv)) < outlier_frac
        obs_uv[out] += RNG.uniform(20, 60, (int(out.sum()), 2))
    obs_depth = np.zeros(len(obs_cam), np.float32)
    if depth_frac > 0:
        z = np.concatenate(
            [np.asarray(se3_apply(jnp.asarray(T), jnp.asarray(X)))[:, 2] for T in poses_true]
        )
        sel = RNG.random(len(obs_cam)) < depth_frac
        obs_depth[sel] = z[sel]

    # perturbed initial state (first kf fixed at truth)
    poses_init = poses_true.copy()
    for k in range(1, n_kf):
        xi = RNG.normal(0, pose_noise, 6).astype(np.float32)
        poses_init[k] = np.asarray(se3_exp(jnp.asarray(xi))) @ poses_true[k]
    X_init = X + RNG.normal(0, pt_noise, X.shape).astype(np.float32)

    MO = n_kf
    pt_obs = np.stack(
        [np.arange(n_pt, dtype=np.int32) + k * n_pt for k in range(n_kf)], -1
    )
    problem = BAProblem(
        cam_pose=jnp.asarray(poses_init),
        cam_fixed=jnp.asarray(np.arange(n_kf) == 0),
        cam_valid=jnp.ones(n_kf, bool),
        pt_pos=jnp.asarray(X_init),
        pt_valid=jnp.ones(n_pt, bool),
        obs_cam=jnp.asarray(obs_cam),
        obs_pt=jnp.asarray(obs_pt),
        obs_uv=jnp.asarray(obs_uv),
        obs_sigma2=jnp.ones(len(obs_cam)),
        obs_depth=jnp.asarray(obs_depth),
        obs_valid=jnp.ones(len(obs_cam), bool),
        pt_obs=jnp.asarray(pt_obs),
        bf=jnp.float32(50.0),
    )
    return problem, poses_true, X


def centers(poses):
    return np.stack([-T[:3, :3].T @ T[:3, 3] for T in poses])


class TestBASolve:
    def test_converges_mono(self):
        from ucoslam_tpu.geometry import ate_rmse

        problem, poses_true, X = make_problem()
        res = ba_solve(problem, CAM, iters=20)
        cost = np.asarray(res.cost_history)
        # ~noise floor: 900 obs x 0.5 px^2 expected chi2, minus absorbed dof
        assert cost[-1] < 450
        assert cost[-1] < cost[0] * 0.99
        # mono BA has a scale gauge: compare Horn-aligned camera centers
        ate = ate_rmse(centers(np.asarray(res.cam_pose)), centers(poses_true))
        assert ate < 2e-3, f"aligned center ATE {ate}"

    def test_fixed_camera_stays(self):
        problem, poses_true, _ = make_problem()
        res = ba_solve(problem, CAM, iters=10)
        np.testing.assert_array_equal(
            np.asarray(res.cam_pose[0]), np.asarray(problem.cam_pose[0])
        )

    def test_outliers_flagged(self):
        from ucoslam_tpu.geometry import ate_rmse

        problem, poses_true, X = make_problem(outlier_frac=0.1)
        res = ba_solve(problem, CAM, iters=25)
        bad = np.asarray(res.obs_bad)
        ate = ate_rmse(centers(np.asarray(res.cam_pose)), centers(poses_true))
        assert ate < 5e-3, f"aligned center ATE {ate}"
        assert bad.sum() > 0

    def test_stereo_fixes_scale(self):
        from ucoslam_tpu.geometry import ate_rmse

        problem, poses_true, X = make_problem(depth_frac=0.5, noise_px=0.2)
        res = ba_solve(problem, CAM, iters=20)
        # stereo observations pin the scale: compare WITHOUT scale alignment
        ate = ate_rmse(
            centers(np.asarray(res.cam_pose)), centers(poses_true), with_scale=False
        )
        assert ate < 5e-3, f"metric center ATE {ate}"


class TestMapIntegration:
    def _build_map(self, n_kf=5, n_pt=200):
        params = Params().replace(
            maxMapPoints=1024, maxKeyFrames=16, maxKeyPointsPerFrame=256
        )
        m = Map(params)
        X = RNG.uniform(-2, 2, (n_pt, 3)).astype(np.float32)
        X[:, 2] = RNG.uniform(4, 9, n_pt)
        desc = RNG.integers(0, 2**32, (n_pt, 8), dtype=np.uint32)
        dist = np.linalg.norm(X, axis=1)
        slots = m.add_points(
            X, X / dist[:, None], desc, dist / 1.2**7, dist * 1.1,
            np.zeros(n_pt, np.int32), 0,
        )
        poses = []
        for k in range(n_kf):
            xi = np.array([0.5 * k / n_kf, 0.0, 0.0, 0.0, -0.05 * k / n_kf, 0.0], np.float32)
            T = np.asarray(se3_exp(jnp.asarray(xi)))
            poses.append(T)
            uv = np.asarray(CAM.project(se3_apply(jnp.asarray(T), jnp.asarray(X)))).copy()
            uv += RNG.normal(0, 0.3, uv.shape)
            f = empty_frame(256)._replace(
                fseq=jnp.int32(k),
                und_xy=jnp.asarray(np.pad(uv, ((0, 56), (0, 0))).astype(np.float32)),
                desc=jnp.asarray(np.vstack([desc, np.zeros((56, 8), np.uint32)])),
                valid=jnp.asarray(np.arange(256) < n_pt),
                ids=jnp.asarray(np.concatenate([slots, np.full(56, -1)]).astype(np.int32)),
                pose_f2g=jnp.asarray(T),
            )
            m.add_keyframe(f)
        return m, np.stack(poses), X, slots

    def test_global_ba_reduces_chi2_after_corruption(self):
        m, poses, X, slots = self._build_map()
        # corrupt the map: jiggle points and poses 1..n
        st = m.state
        pt = np.asarray(st.pt_pos).copy()
        pt[slots] += RNG.normal(0, 0.05, (len(slots), 3))
        kf = np.asarray(st.kf_pose).copy()
        for k in range(1, 5):
            kf[k] = np.asarray(se3_exp(jnp.asarray(RNG.normal(0, 0.01, 6).astype(np.float32)))) @ kf[k]
        m.state = st._replace(pt_pos=jnp.asarray(pt), kf_pose=jnp.asarray(kf))
        chi_before = m.global_reproj_chi2(CAM)
        n_bad = global_bundle_adjustment(m, CAM, n_iters=25)
        chi_after = m.global_reproj_chi2(CAM)
        assert chi_after < chi_before * 0.05, (chi_before, chi_after)
        assert chi_after < 1.0

    def test_local_ba_runs(self):
        m, poses, X, slots = self._build_map()
        st = m.state
        pt = np.asarray(st.pt_pos).copy()
        pt[slots] += RNG.normal(0, 0.03, (len(slots), 3))
        m.state = st._replace(pt_pos=jnp.asarray(pt))
        chi_before = m.global_reproj_chi2(CAM)
        local_bundle_adjustment(m, CAM, center_kf=4)
        chi_after = m.global_reproj_chi2(CAM)
        assert chi_after < chi_before


def build_marker_map(in_plane=False, tilt=0.0):
    from ucoslam_tpu.markers.ippe import marker_object_points
    from ucoslam_tpu.geometry.se3 import se3_apply

    params = Params().replace(
        maxMapPoints=1024, maxKeyFrames=16, maxKeyPointsPerFrame=256,
        detectMarkers=True, inPlaneMarkers=in_plane,
    )
    m = Map(params)
    rng = np.random.default_rng(7)
    n_pt = 180
    X = rng.uniform(-2, 2, (n_pt, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(4, 9, n_pt)
    desc = rng.integers(0, 2**32, (n_pt, 8), dtype=np.uint32)
    dist = np.linalg.norm(X, axis=1)
    slots = m.add_points(
        X, X / dist[:, None], desc, dist / 1.2**7, dist * 1.1,
        np.zeros(n_pt, np.int32), 0,
    )
    # two markers: flat in the z=5 plane (world z-axis normal), the
    # second optionally tilted out of plane by `tilt` radians
    size = 0.5
    mk_true = []
    for i, (cx, cy) in enumerate([(-1.0, 0.0), (1.2, 0.3)]):
        ang = tilt if i == 1 else 0.0
        Rx = np.array(
            [[1, 0, 0], [0, np.cos(ang), -np.sin(ang)], [0, np.sin(ang), np.cos(ang)]],
            np.float32,
        )
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = Rx
        T[:3, 3] = [cx, cy, 5.0]
        mk_true.append(T)
    obj = np.asarray(marker_object_points(jnp.float32(size)))

    poses = []
    for k in range(6):
        xi = np.array(
            [0.5 * k / 6, 0.02 * k, 0.0, 0.0, -0.05 * k / 6, 0.0], np.float32
        )
        T = np.asarray(se3_exp(jnp.asarray(xi)))
        poses.append(T)
        uv = np.asarray(CAM.project(se3_apply(jnp.asarray(T), jnp.asarray(X)))).copy()
        uv += rng.normal(0, 0.3, uv.shape)
        f = empty_frame(256)._replace(
            fseq=jnp.int32(k),
            und_xy=jnp.asarray(np.pad(uv, ((0, 76), (0, 0))).astype(np.float32)),
            desc=jnp.asarray(np.vstack([desc, np.zeros((76, 8), np.uint32)])),
            valid=jnp.asarray(np.arange(256) < n_pt),
            ids=jnp.asarray(np.concatenate([slots, np.full(76, -1)]).astype(np.int32)),
            pose_f2g=jnp.asarray(T),
        )
        m.add_keyframe(f)

    # attach marker observations + (perturbed) marker poses to the state
    st = m.state
    mk_pose = np.asarray(st.mk_pose).copy()
    mk_valid = np.asarray(st.mk_pose_valid).copy()
    mk_size_a = np.asarray(st.mk_size).copy()
    mk_id = np.asarray(st.mk_id).copy()
    kf_mk_slot = np.asarray(st.kf_mk_slot).copy()
    kf_mk_corners = np.asarray(st.kf_mk_corners).copy()
    rng2 = np.random.default_rng(11)
    for i, T_m in enumerate(mk_true):
        xi = rng2.normal(0, 0.03, 6).astype(np.float32)
        mk_pose[i] = np.asarray(se3_exp(jnp.asarray(xi))) @ T_m
        mk_valid[i] = True
        mk_size_a[i] = size
        mk_id[i] = 100 + i
        world = obj @ T_m[:3, :3].T + T_m[:3, 3]
        for k, T_c in enumerate(poses):
            q = world @ T_c[:3, :3].T + T_c[:3, 3]
            uv = np.asarray(CAM.project(jnp.asarray(q.astype(np.float32))))
            kf_mk_slot[k, i] = i
            kf_mk_corners[k, i] = uv + rng2.normal(0, 0.2, uv.shape)
    m.state = st._replace(
        mk_pose=jnp.asarray(mk_pose), mk_pose_valid=jnp.asarray(mk_valid),
        mk_size=jnp.asarray(mk_size_a), mk_id=jnp.asarray(mk_id),
        kf_mk_slot=jnp.asarray(kf_mk_slot),
        kf_mk_corners=jnp.asarray(kf_mk_corners),
    )
    return m, np.stack(mk_true), obj, poses


class TestMarkerVertices:
    """Free marker SE3 vertices in BA (MarkerEdge, globaloptimizer_g2o.cpp
    :305-352) and the planar InPlaneMarkers constraint (:357-398)."""

    def _corner_err(self, m, mk_true, obj):
        mk_pose = np.asarray(m.state.mk_pose)[:2]
        errs = []
        for i in range(2):
            w_est = obj @ mk_pose[i][:3, :3].T + mk_pose[i][:3, 3]
            w_true = obj @ mk_true[i][:3, :3].T + mk_true[i][:3, 3]
            errs.append(np.linalg.norm(w_est - w_true, axis=-1).mean())
        return float(np.mean(errs))

    def test_marker_vertices_refined_by_global_ba(self):
        m, mk_true, obj, _ = build_marker_map()
        err0 = self._corner_err(m, mk_true, obj)
        global_bundle_adjustment(m, CAM, n_iters=25)
        err1 = self._corner_err(m, mk_true, obj)
        assert err0 > 0.005  # perturbation was real
        assert err1 < err0 * 0.2, (err0, err1)
        assert err1 < 0.01

    def test_in_plane_markers_flattened(self):
        # second marker tilted 0.12 rad out of the common plane; with
        # InPlaneMarkers the relative z-axis misalignment must shrink
        m, mk_true, obj, _ = build_marker_map(in_plane=True, tilt=0.12)

        def rel_tilt(m):
            mk = np.asarray(m.state.mk_pose)[:2]
            E = np.linalg.inv(mk[0]) @ mk[1]
            return float(np.arccos(np.clip(E[2, 2], -1, 1)))

        global_bundle_adjustment(m, CAM, n_iters=25)
        t1 = rel_tilt(m)
        # true relative tilt is 0.12 rad; the planar prior pulls it down
        assert t1 < 0.06, t1

    def test_marker_pose_written_back_only_when_free(self):
        m, mk_true, obj, _ = build_marker_map()
        before = np.asarray(m.state.mk_pose)[:2].copy()
        global_bundle_adjustment(m, CAM, n_iters=10)
        after = np.asarray(m.state.mk_pose)[:2]
        assert not np.allclose(before, after)  # vertices were free and moved


class TestCGSolver:
    """Matrix-free PCG Schur path (the at-scale solver) vs exact dense."""

    def _with_table(self, problem):
        from ucoslam_tpu.optim.ba import _build_cam_obs

        oc = np.asarray(problem.obs_cam)
        return problem._replace(
            cam_obs=jnp.asarray(
                _build_cam_obs(oc, problem.cam_pose.shape[0], len(oc))
            )
        )

    def test_cg_matches_dense(self):
        problem, poses_true, X = make_problem(n_kf=8, n_pt=200, pose_noise=0.03)
        problem = self._with_table(problem)
        rd = ba_solve(problem, CAM, iters=12, stages=1, solver="dense")
        rc = ba_solve(problem, CAM, iters=12, stages=1, solver="cg", cg_iters=40)
        assert np.asarray(rc.cost_history)[-1] < np.asarray(rc.cost_history)[0]
        assert float(jnp.abs(rd.cam_pose - rc.cam_pose).max()) < 2e-3
        assert float(jnp.abs(rd.pt_pos - rc.pt_pos).max()) < 2e-2

    def test_cg_with_stereo_and_outliers(self):
        problem, poses_true, X = make_problem(
            n_kf=6, n_pt=150, depth_frac=0.4, outlier_frac=0.05
        )
        problem = self._with_table(problem)
        rc = ba_solve(problem, CAM, iters=15, stages=2, solver="cg")
        bad = np.asarray(rc.obs_bad)
        assert bad.any()  # outliers flagged
        from ucoslam_tpu.geometry import ate_rmse

        ate = ate_rmse(centers(np.asarray(rc.cam_pose)), centers(poses_true))
        assert ate < 5e-3, ate

    def test_build_ba_problem_emits_cam_obs(self):
        m, _, _, _ = TestMapIntegration()._build_map()
        problem, kf_slots, pt_slots, _ = build_ba_problem(m, CAM)
        assert problem.cam_obs is not None
        co = np.asarray(problem.cam_obs)
        oc = np.asarray(problem.obs_cam)
        # every valid obs appears exactly once in its camera's row
        O = int(np.asarray(problem.obs_valid).sum())
        listed = co[co >= 0]
        assert len(listed) == O
        assert np.array_equal(np.sort(listed), np.sort(np.nonzero(np.asarray(problem.obs_valid))[0]))
        for c in range(min(4, len(co))):
            row = co[c][co[c] >= 0]
            assert (oc[row] == c).all()


class TestPointMajorSolver:
    """Point-major block-sparse Schur path (optim/schur_pm.py): the
    big-map fast solver behind ba_solve's V>=128 dispatch (the
    counterpart of the reference's sparse BlockSolver_6_3,
    globaloptimizer_g2o.cpp:176)."""

    def _problem(self, n_kf, n_pt, obs_per_pt, seed=7):
        import sys, os
        sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
        import bench

        return bench._make_ba_problem(jnp, n_kf=n_kf, n_pt=n_pt,
                                      obs_per_pt=obs_per_pt)

    def test_pm_matches_dense_convergence(self):
        from ucoslam_tpu.optim.ba import ba_solve
        from ucoslam_tpu.optim.schur_pm import pm_problem_for, pm_staged_lm

        problem, cam = self._problem(64, 2048, 6)
        rd = ba_solve(problem, cam, iters=12, stages=2, solver="dense")
        pm, _ = pm_problem_for(problem)
        assert pm is not None
        cp, pt, costs, c2, bad = pm_staged_lm(pm, cam, iters=12, stages=2)
        # CG truncation and lazy relinearization allow a modest gap vs the
        # exact dense solve; monotone non-increase is guaranteed by the
        # cost-gated acceptance
        assert float(costs[-1]) <= float(costs[0]) + 1e-3
        assert float(costs[-1]) < 2.0 * float(rd.cost_history[-1])

    def test_ba_solve_dispatches_to_pm_at_scale(self):
        from ucoslam_tpu.optim import ba as ba_mod
        from ucoslam_tpu.optim import schur_pm

        problem, cam = self._problem(512, 4096, 4)
        called = {}
        orig = schur_pm.pm_staged_lm

        def spy(*a, **k):
            called["pm"] = True
            return orig(*a, **k)

        schur_pm.pm_staged_lm = spy
        try:
            r = ba_mod.ba_solve(problem, cam, iters=4, stages=1)
        finally:
            schur_pm.pm_staged_lm = orig
        assert called.get("pm"), "V>=512 did not route to the pm solver"
        assert float(r.cost_history[-1]) < float(r.cost_history[0])
        # per-obs outputs came back in the ORIGINAL observation order
        O = problem.obs_cam.shape[0]
        assert r.obs_chi2.shape == (O,)
        assert r.obs_bad.shape == (O,)
        # chi2 scatter-back sanity: recompute chi2 directly at the solution
        from ucoslam_tpu.optim.ba import _chi2_of

        c2_direct, _ = _chi2_of(problem, r.cam_pose, r.pt_pos, cam)
        np.testing.assert_allclose(
            np.asarray(r.obs_chi2), np.asarray(c2_direct), rtol=1e-3,
            atol=1e-3,
        )

    def test_pm_rejects_marker_problems(self):
        from ucoslam_tpu.optim.schur_pm import build_pm_problem
        from ucoslam_tpu.optim.ba import BAProblem

        problem, cam = self._problem(16, 256, 4)
        mk = problem._replace(
            mk_pose=jnp.eye(4)[None],
            mk_fixed=jnp.zeros(1, bool),
            mk_valid=jnp.ones(1, bool),
            mk_obj=jnp.zeros((1, 4, 3)),
            mobs_cam=jnp.zeros(1, jnp.int32),
            mobs_mk=jnp.zeros(1, jnp.int32),
            mobs_uv=jnp.zeros((1, 4, 2)),
            mobs_w=jnp.ones(1),
            mobs_valid=jnp.ones(1, bool),
        )
        assert build_pm_problem(mk) == (None, 0)

    def test_pm_caps_skewed_graphs_instead_of_bailing(self):
        """A loopy map's hyper-observed points must not silently kick the
        whole solve to the slow CG path (VERDICT r4 weak #7): the builder
        caps per-point observations and reports what it dropped; ba_solve
        still returns honest chi2 for the dropped edges."""
        from ucoslam_tpu.optim.ba import _chi2_of, ba_solve
        from ucoslam_tpu.optim.schur_pm import build_pm_problem, pm_staged_lm

        problem, cam = self._problem(16, 1024, 6)
        rng = np.random.default_rng(0)
        obs_pt = np.asarray(problem.obs_pt).copy()
        hyper = rng.choice(1024, 30, replace=False)
        m = rng.random(len(obs_pt)) < 0.08  # 8% of obs onto 30 points
        obs_pt[m] = rng.choice(hyper, int(m.sum()))
        skewed = problem._replace(obs_pt=jnp.asarray(obs_pt))
        pm, dropped = build_pm_problem(skewed)
        assert pm is not None, "skewed graph bailed instead of capping"
        assert dropped > 0
        cp, pt, costs, _, _ = pm_staged_lm(pm, cam, iters=6, stages=2)
        assert float(costs[-1]) < float(costs[0])
        # the dispatcher path: chi2 of dropped obs is the exact residual
        r = ba_solve(skewed, cam, iters=4, stages=1, solver="auto")
        c2_direct, _ = _chi2_of(skewed, r.cam_pose, r.pt_pos, cam)
        np.testing.assert_allclose(
            np.asarray(r.obs_chi2), np.asarray(c2_direct), rtol=1e-3,
            atol=1e-3,
        )
