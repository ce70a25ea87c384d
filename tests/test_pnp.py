"""Pose estimation tests: motion-only LM, RANSAC, projection matching."""

import numpy as np
import jax
import jax.numpy as jnp

from ucoslam_tpu.geometry import CameraParams, se3_exp, se3_apply, se3_log, se3_inverse
from ucoslam_tpu.optim import motion_only_lm, pnp_ransac
from ucoslam_tpu.matching import match_points_to_frame
from ucoslam_tpu.mapping.frame import empty_frame

RNG = np.random.default_rng(21)
CAM = CameraParams.create(500.0, 500.0, 320.0, 240.0, width=640, height=480)


def scene(n=200, pose_xi=(0.1, -0.05, 0.02, 0.03, -0.02, 0.01)):
    X = RNG.uniform(-2, 2, (n, 3)).astype(np.float32)
    X[:, 2] = RNG.uniform(3, 10, n)
    T = se3_exp(jnp.asarray(pose_xi, jnp.float32))
    uv = CAM.project(se3_apply(T, jnp.asarray(X)))
    return jnp.asarray(X), T, uv


def pose_err(Ta, Tb):
    d = se3_log(se3_inverse(Ta) @ Tb)
    return float(jnp.linalg.norm(d))


class TestMotionOnlyLM:
    def test_converges_from_perturbed_init(self):
        X, T_true, uv = scene()
        uv_noisy = uv + jnp.asarray(RNG.normal(0, 0.3, uv.shape).astype(np.float32))
        T_init = se3_exp(jnp.asarray([0.05, 0.03, -0.04, 0.02, 0.01, -0.02])) @ T_true
        res = motion_only_lm(
            T_init, X, uv_noisy, jnp.ones(X.shape[0]), jnp.ones(X.shape[0], bool), CAM
        )
        assert pose_err(res.pose_f2g, T_true) < 0.01
        assert int(res.n_inliers) > 180

    def test_rejects_outliers(self):
        X, T_true, uv = scene(300)
        uv = np.asarray(uv).copy()
        out = RNG.random(300) < 0.3
        uv[out] += RNG.uniform(30, 100, (int(out.sum()), 2)) * np.sign(RNG.normal(size=(int(out.sum()), 2)))
        T_init = se3_exp(jnp.asarray([0.02, 0.0, 0.0, 0.0, 0.01, 0.0])) @ T_true
        res = motion_only_lm(
            T_init, X, jnp.asarray(uv.astype(np.float32)), jnp.ones(300), jnp.ones(300, bool), CAM
        )
        assert pose_err(res.pose_f2g, T_true) < 0.01
        inl = np.asarray(res.inliers)
        assert inl[~out].mean() > 0.95  # keeps true inliers
        assert inl[out].mean() < 0.05  # drops outliers

    def test_stereo_edges(self):
        X, T_true, uv = scene(150)
        depth = np.asarray(se3_apply(T_true, X))[:, 2].astype(np.float32)
        res = motion_only_lm(
            se3_exp(jnp.asarray([0.04, -0.02, 0.0, 0.01, 0.0, 0.02])) @ T_true,
            X, uv, jnp.ones(150), jnp.ones(150, bool), CAM,
            depth=jnp.asarray(depth), bf=jnp.float32(0.1 * 500.0),
        )
        assert pose_err(res.pose_f2g, T_true) < 0.01


class TestRansac:
    def test_recovers_pose_with_outliers(self):
        X, T_true, uv = scene(200)
        uv = np.asarray(uv).copy()
        out = RNG.random(200) < 0.4
        uv[out] = RNG.uniform(0, 640, (int(out.sum()), 2))
        res = pnp_ransac(
            X, jnp.asarray(uv.astype(np.float32)), jnp.ones(200),
            jnp.ones(200, bool), CAM, jax.random.PRNGKey(0),
        )
        assert int(res.n_inliers) > 100
        assert pose_err(res.pose_f2g, T_true) < 0.02

    def test_fails_gracefully_on_garbage(self):
        X = jnp.asarray(RNG.uniform(-2, 2, (100, 3)).astype(np.float32))
        uv = jnp.asarray(RNG.uniform(0, 640, (100, 2)).astype(np.float32))
        res = pnp_ransac(
            X, uv, jnp.ones(100), jnp.ones(100, bool), CAM, jax.random.PRNGKey(1),
        )
        assert int(res.n_inliers) < 30  # no fake confident pose

    def test_deterministic(self):
        X, T_true, uv = scene(100)
        r1 = pnp_ransac(X, uv, jnp.ones(100), jnp.ones(100, bool), CAM, jax.random.PRNGKey(7))
        r2 = pnp_ransac(X, uv, jnp.ones(100), jnp.ones(100, bool), CAM, jax.random.PRNGKey(7))
        np.testing.assert_array_equal(np.asarray(r1.pose_f2g), np.asarray(r2.pose_f2g))


class TestProjectionMatching:
    def test_matches_projected_points(self):
        n_pts, n_kpt = 100, 256
        X, T_true, uv = scene(n_pts)
        desc = RNG.integers(0, 2**32, (n_pts, 8), dtype=np.uint32)
        f = empty_frame(n_kpt)
        uv_np = np.asarray(uv)
        f = f._replace(
            und_xy=jnp.asarray(np.pad(uv_np, ((0, n_kpt - n_pts), (0, 0))).astype(np.float32)),
            desc=jnp.asarray(np.vstack([desc, RNG.integers(0, 2**32, (n_kpt - n_pts, 8), dtype=np.uint32)])),
            valid=jnp.ones(n_kpt, bool),
        )
        cam_pts = np.asarray(se3_apply(T_true, X))
        dist = np.linalg.norm(cam_pts, axis=1)
        # MapPoint convention: max_dist = creation distance * 1.2^octave
        # (octave 0 here), min_dist = max_dist / 1.2^(nlevels-1).
        m = match_points_to_frame(
            X, jnp.asarray(desc), jnp.zeros((n_pts, 3)),
            jnp.asarray(dist / 1.2**7), jnp.asarray(dist * 1.05),
            jnp.ones(n_pts, bool), f, CAM, T_true,
            jnp.float32(15.0), jnp.float32(50.0),
        )
        acc = np.asarray(m.point_valid)
        idx = np.asarray(m.kpt_idx)
        assert acc.sum() > 90
        assert (idx[acc] == np.arange(n_pts)[acc]).all()

    def test_pose_prior_off_rejects(self):
        n_pts, n_kpt = 50, 64
        X, T_true, uv = scene(n_pts)
        desc = RNG.integers(0, 2**32, (n_pts, 8), dtype=np.uint32)
        f = empty_frame(n_kpt)
        f = f._replace(
            und_xy=jnp.asarray(np.pad(np.asarray(uv), ((0, n_kpt - n_pts), (0, 0))).astype(np.float32)),
            desc=jnp.asarray(np.vstack([desc, RNG.integers(0, 2**32, (n_kpt - n_pts, 8), dtype=np.uint32)])),
            valid=jnp.ones(n_kpt, bool),
        )
        cam_pts = np.asarray(se3_apply(T_true, X))
        dist = np.linalg.norm(cam_pts, axis=1)
        T_far = se3_exp(jnp.asarray([2.0, 1.0, 0.0, 0.3, 0.2, 0.1])) @ T_true
        m = match_points_to_frame(
            X, jnp.asarray(desc), jnp.zeros((n_pts, 3)),
            jnp.asarray(dist / 1.2**7), jnp.asarray(dist * 1.05),
            jnp.ones(n_pts, bool), f, CAM, T_far,
            jnp.float32(15.0), jnp.float32(50.0),
        )
        assert int(m.n_matched) < 20


class TestFusedLMKernel:
    """The fused motion-only LM (ops/pallas/lm_kernel.py) must match the
    jnp implementation (interpret mode on the CPU; the GPU compiles the
    same kernel through Triton)."""

    def _scene(self, n=257, outlier_frac=0.2, seed=7):
        rng = np.random.default_rng(seed)
        X = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
        X[:, 2] = rng.uniform(3, 10, n)
        T_true = se3_exp(jnp.asarray([0.1, -0.05, 0.02, 0.03, -0.02, 0.01]))
        uv = np.asarray(CAM.project(se3_apply(T_true, jnp.asarray(X)))).copy()
        uv += rng.normal(0, 0.4, uv.shape).astype(np.float32)
        out = rng.random(n) < outlier_frac
        uv[out] += rng.uniform(25, 90, (int(out.sum()), 2)).astype(np.float32)
        T0 = se3_exp(jnp.asarray([0.08, -0.03, 0.0, 0.02, 0.0, 0.0]))
        return (
            jnp.asarray(X), jnp.asarray(uv.astype(np.float32)),
            jnp.ones(n), jnp.ones(n, bool), jnp.asarray(T0), T_true,
        )

    def test_matches_xla_mono(self):
        from ucoslam_tpu.ops.pallas.lm_kernel import motion_only_lm_fused

        X, uv, s2, valid, T0, T_true = self._scene()
        ref = motion_only_lm(T0, X, uv, s2, valid, CAM)
        pose, inl = motion_only_lm_fused(
            T0, X, uv, s2, valid, CAM.fx, CAM.fy, CAM.cx, CAM.cy,
            interpret=True,
        )
        assert int(inl.sum()) == int(ref.n_inliers)
        assert (np.asarray(inl) == np.asarray(ref.inliers)).all()
        assert float(jnp.abs(pose - ref.pose_f2g).max()) < 1e-4
        assert pose_err(pose, T_true) < 0.01

    def test_matches_xla_stereo(self):
        from ucoslam_tpu.ops.pallas.lm_kernel import motion_only_lm_fused

        rng = np.random.default_rng(11)
        X, uv, s2, valid, T0, T_true = self._scene(seed=11)
        depth = np.asarray(se3_apply(T_true, X))[:, 2].astype(np.float32)
        depth[rng.random(len(depth)) < 0.4] = 0.0  # mixed mono/stereo rows
        bf = 0.1 * 500.0
        ref = motion_only_lm(
            T0, X, uv, s2, valid, CAM,
            depth=jnp.asarray(depth), bf=jnp.float32(bf),
        )
        pose, inl = motion_only_lm_fused(
            T0, X, uv, s2, valid, CAM.fx, CAM.fy, CAM.cx, CAM.cy,
            depth=jnp.asarray(depth), bf=bf, has_depth=True, interpret=True,
        )
        assert int(inl.sum()) == int(ref.n_inliers)
        assert float(jnp.abs(pose - ref.pose_f2g).max()) < 1e-4
