"""CLI apps + dataset IO + viewer: end-to-end through the command line."""

import os
import subprocess
import sys

import numpy as np
import pytest

from ucoslam_tpu.io.datasets import (
    TumSequence,
    associate_trajectories,
    kitti_to_tum,
    load_trajectory_tum,
    save_trajectory_tum,
    write_synthetic_tum,
    _quat_to_rot,
    _rot_to_quat,
)
from ucoslam_tpu.io.synthetic import SyntheticSequence

ENV = dict(os.environ, JAX_PLATFORMS="cpu")


def test_quat_roundtrip():
    from ucoslam_tpu.geometry.se3 import so3_exp
    import jax.numpy as jnp

    rng = np.random.default_rng(5)
    for _ in range(20):
        R = np.asarray(so3_exp(jnp.asarray(rng.normal(0, 1, 3).astype(np.float32))))
        q = _rot_to_quat(R)
        R2 = _quat_to_rot(q)
        np.testing.assert_allclose(R, R2, atol=1e-5)


def test_trajectory_tum_roundtrip(tmp_path):
    seq = SyntheticSequence(n_frames=5)
    stamps = [i / 30.0 for i in range(5)]
    poses = [seq.gt_pose(i) for i in range(5)]
    p = str(tmp_path / "t.txt")
    save_trajectory_tum(p, stamps, poses)
    st, centers, quats = load_trajectory_tum(p)
    assert len(st) == 5
    gt_centers = seq.gt_positions()[:5]
    np.testing.assert_allclose(centers, gt_centers, atol=1e-4)


def test_associate():
    a = np.asarray([0.0, 0.1, 0.2])
    b = np.asarray([0.001, 0.105, 0.5])
    pairs = associate_trajectories(a, b, max_dt=0.02)
    assert pairs == [(0, 0), (1, 1)]


def test_kitti_to_tum():
    poses = np.tile(np.hstack([np.eye(3), np.zeros((3, 1))])[None], (4, 1, 1))
    poses[:, 0, 3] = np.arange(4)
    st, c, q = kitti_to_tum(poses)
    assert c.shape == (4, 3) and (c[:, 0] == np.arange(4)).all()


def test_write_and_open_tum(tmp_path):
    pytest.importorskip("cv2")
    seq = SyntheticSequence(n_frames=4, n_points=300)
    root = str(tmp_path / "ds")
    write_synthetic_tum(seq, root)
    tum = TumSequence.open(root)
    assert len(tum) == 4
    img = tum.read_rgb(0)
    assert img.shape[:2] == (480, 640)
    assert tum.gt is not None and len(tum.gt[0]) == 4


def test_viewer_snapshot():
    from ucoslam_tpu.config import Params
    from ucoslam_tpu.mapping import Map
    from ucoslam_tpu.viz import MapViewer

    m = Map(Params().replace(maxMapPoints=64, maxKeyFrames=8, maxKeyPointsPerFrame=32))
    m.add_points(
        np.random.default_rng(0).uniform(-1, 1, (10, 3)) + [0, 0, 5],
        np.zeros((10, 3)), np.zeros((10, 8), np.uint32),
        np.zeros(10), np.ones(10), np.zeros(10, np.int32), 0,
    )
    v = MapViewer(320, 240)
    v.set("followCamera", "0")
    img = v.snapshot(m, None)
    assert img.shape == (240, 320, 3)
    assert (img != 24).any()  # something was drawn
    assert v.show(m) == 255  # headless


@pytest.mark.slow
def test_cli_two_pass_protocol(tmp_path):
    """Full test_sequence CLI over a small synthetic run (subprocess)."""
    out = str(tmp_path / "run")
    r = subprocess.run(
        [sys.executable, "-m", "ucoslam_tpu.apps.test_sequence",
         "--synthetic", "10", "--out-dir", out],
        env=ENV, capture_output=True, text=True, timeout=900,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "|@# Image 10/10" in r.stdout
    assert "ATE=" in r.stdout
    ate = float(r.stdout.split("ATE=")[-1].split()[0])
    assert ate < 0.2, f"CLI two-pass ATE {ate}"
    assert os.path.exists(os.path.join(out, "map.slm"))
    assert os.path.exists(os.path.join(out, "trajectory.txt"))


@pytest.mark.slow
def test_cli_compare_logs(tmp_path):
    seq = SyntheticSequence(n_frames=6)
    stamps = [i / 30.0 for i in range(6)]
    poses = [seq.gt_pose(i) for i in range(6)]
    est = str(tmp_path / "est.txt")
    gt = str(tmp_path / "gt.txt")
    save_trajectory_tum(est, stamps, poses)
    save_trajectory_tum(gt, stamps, poses)
    r = subprocess.run(
        [sys.executable, "-m", "ucoslam_tpu.apps.compare_logs", est, gt],
        env=ENV, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0
    assert "ATE=0.000" in r.stdout


def test_stereo_calibrate_synthetic_chessboard(tmp_path):
    """Render a chessboard through a synthetic verged stereo rig; the
    calibration must recover the baseline and focal length."""
    import cv2
    from ucoslam_tpu.apps.stereo_calibrate import (
        calibrate_stereo_pairs, write_stereo_yml,
    )

    W, H = 640, 480
    fx = 500.0
    K = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1]])
    board = (9, 6)
    square = 0.03
    objp = np.zeros((board[0] * board[1], 3), np.float32)
    objp[:, :2] = np.mgrid[0:board[0], 0:board[1]].T.reshape(-1, 2) * square
    baseline = 0.12
    rng = np.random.default_rng(2)
    pairs = []
    for i in range(8):
        rvec = rng.uniform(-0.3, 0.3, 3)
        tvec = np.array([rng.uniform(-0.1, 0.1), rng.uniform(-0.05, 0.05),
                         rng.uniform(0.6, 1.0)])
        # canonical pattern: (bw+1)x(bh+1) squares + 2-square white margin,
        # warped into each eye by the plane homography -> a physically
        # correct chessboard image with the white border cv2 requires
        px = 40
        bw, bh = board
        ny, nx = bh + 1 + 4, bw + 1 + 4
        cells = (np.indices((ny, nx)).sum(0) % 2) * 255
        cells[:2, :] = cells[-2:, :] = 255
        cells[:, :2] = cells[:, -2:] = 255
        pattern = np.kron(cells, np.ones((px, px))).astype(np.uint8)
        # pattern pixel of inner corner (0,0) is at (3*px, 3*px)
        src = np.float32([[3 * px, 3 * px], [(3 + bw - 1) * px, 3 * px],
                          [(3 + bw - 1) * px, (3 + bh - 1) * px],
                          [3 * px, (3 + bh - 1) * px]])
        obj4 = np.float32([[0, 0, 0], [(bw - 1) * square, 0, 0],
                           [(bw - 1) * square, (bh - 1) * square, 0],
                           [0, (bh - 1) * square, 0]])
        imgs = []
        for eye in range(2):
            t_eye = tvec - np.array([baseline * eye, 0, 0])
            uv, _ = cv2.projectPoints(obj4, rvec, t_eye, K, None)
            Hm = cv2.getPerspectiveTransform(src, uv.reshape(4, 2).astype(np.float32))
            img = cv2.warpPerspective(
                pattern, Hm, (W, H), flags=cv2.INTER_LINEAR,
                borderMode=cv2.BORDER_CONSTANT, borderValue=255,
            )
            imgs.append(img)
        pairs.append((imgs[0], imgs[1]))
    calib = calibrate_stereo_pairs(pairs, board, square)
    if calib is None:
        import pytest

        pytest.skip("synthetic chessboard not detected by cv2")
    assert abs(np.linalg.norm(calib["T"]) - baseline) < 0.01
    assert abs(calib["M1"][0, 0] - fx) / fx < 0.05
    out = str(tmp_path / "stereo.yml")
    write_stereo_yml(out, calib)
    fs = cv2.FileStorage(out, cv2.FILE_STORAGE_READ)
    assert fs.getNode("M1").mat().shape == (3, 3)
    assert fs.getNode("Q").mat().shape == (4, 4)
    fs.release()


def test_euroc_loader_roundtrip(tmp_path):
    """EuRoC mav0/ layout: write synthetic, open, read images + calib + gt
    (reference: euroc_stereoRectification.cpp / test_generator_stereo.sh)."""
    from ucoslam_tpu.io.datasets import EurocSequence, write_synthetic_euroc

    seq = SyntheticSequence(n_frames=4, n_points=200)
    root = str(tmp_path / "euroc")
    write_synthetic_euroc(seq, root, stereo=True)
    ds = EurocSequence.open(root)
    assert len(ds) == 4
    img = ds.read(0)
    assert img.shape == (480, 640)
    right = ds.read(0, 1)
    assert right.shape == (480, 640)
    cam = ds.camera()
    assert abs(float(cam.fx) - 500.0) < 1e-3
    assert abs(cam.bl - seq.cam.bl) < 1e-6
    assert ds.gt is not None and len(ds.gt[0]) == 4


def test_kitti_loader_roundtrip(tmp_path):
    """KITTI odometry layout: image_0/ + times.txt + calib.txt P0/P1."""
    from ucoslam_tpu.io.datasets import KittiSequence, write_synthetic_kitti

    seq = SyntheticSequence(n_frames=4, n_points=200)
    root = str(tmp_path / "kitti")
    write_synthetic_kitti(seq, root, stereo=True)
    ds = KittiSequence.open(root, poses_file=os.path.join(root, "poses.txt"))
    assert len(ds) == 4
    assert ds.read(0).shape == (480, 640)
    cam = ds.camera()
    assert abs(float(cam.fx) - 500.0) < 1e-3
    assert abs(cam.bl - seq.cam.bl) < 1e-4
    assert ds.gt is not None and len(ds.gt[0]) == 4
    # gt centers match the synthetic trajectory
    np.testing.assert_allclose(ds.gt[1], seq.gt_positions(), atol=1e-4)


def test_dataset_format_detection_and_presets(tmp_path):
    from ucoslam_tpu.io.datasets import (
        dataset_preset,
        detect_dataset_format,
        write_synthetic_euroc,
        write_synthetic_kitti,
        write_synthetic_tum,
    )

    seq = SyntheticSequence(n_frames=2, n_points=100)
    e, k, t = str(tmp_path / "e"), str(tmp_path / "k"), str(tmp_path / "t")
    write_synthetic_euroc(seq, e, stereo=False)
    write_synthetic_kitti(seq, k, stereo=False)
    write_synthetic_tum(seq, t)
    assert detect_dataset_format(e) == "euroc"
    assert detect_dataset_format(k) == "kitti"
    assert detect_dataset_format(t) == "tum"
    over, harness = dataset_preset("kitti")
    # the reference preset: -KFMinConfidence 0.8 -KFCulling 0.8 -recovery
    assert over == {"KFMinConfidence": 0.8, "KFCulling": 0.8}
    assert harness.get("recovery") is True


@pytest.mark.slow
def test_cli_two_pass_on_euroc_tree(tmp_path):
    """test_sequence --dataset pointed at a synthetic EuRoC tree runs both
    passes and emits ATE (VERDICT round-1 item 4's done-criterion)."""
    from ucoslam_tpu.io.datasets import write_synthetic_euroc

    seq = SyntheticSequence(n_frames=8, n_points=500)
    root = str(tmp_path / "euroc")
    write_synthetic_euroc(seq, root, stereo=False)
    out = str(tmp_path / "run")
    r = subprocess.run(
        [sys.executable, "-m", "ucoslam_tpu.apps.test_sequence",
         "--dataset", root, "--out-dir", out],
        env=ENV, capture_output=True, text=True, timeout=900,
    )
    assert r.returncode == 0, r.stderr[-2000:]
    assert "ATE=" in r.stdout, r.stdout[-2000:]
