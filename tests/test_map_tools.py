"""Map utility tests: median depth, unused-keypoint strip, PLY/PCD export."""

import numpy as np
import jax.numpy as jnp

from ucoslam_tpu.config import Params
from ucoslam_tpu.geometry import CameraParams
from ucoslam_tpu.mapping import Map
from ucoslam_tpu.mapping.frame import empty_frame

SMALL = Params().replace(maxMapPoints=64, maxKeyFrames=8, maxKeyPointsPerFrame=32)


def build_small_map():
    m = Map(SMALL)
    rng = np.random.default_rng(1)
    X = rng.uniform(-1, 1, (10, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(2, 8, 10)
    slots = m.add_points(
        X, np.zeros((10, 3)), np.zeros((10, 8), np.uint32),
        np.zeros(10), np.ones(10) * 100, np.zeros(10, np.int32), 0,
    )
    ids = np.full(32, -1, np.int32)
    ids[:10] = slots
    f = empty_frame(32)._replace(
        valid=jnp.ones(32, bool), ids=jnp.asarray(ids)
    )
    m.add_keyframe(f)
    return m, X


def test_frame_median_depth():
    m, X = build_small_map()
    assert abs(m.frame_median_depth(0) - np.median(X[:, 2])) < 1e-4


def test_remove_unused_keypoints():
    m, _ = build_small_map()
    n = m.remove_unused_keypoints()
    assert n == 22  # 32 valid - 10 assigned
    assert int(np.asarray(m.state.kf_kpt_valid[0]).sum()) == 10


def test_export_ply_pcd(tmp_path):
    m, X = build_small_map()
    ply = str(tmp_path / "m.ply")
    pcd = str(tmp_path / "m.pcd")
    m.export_pointcloud(ply)
    m.export_pointcloud(pcd)
    txt = open(ply).read()
    assert txt.startswith("ply") and "element vertex 11" in txt  # 10 pts + 1 kf
    lines = open(pcd).read().splitlines()
    assert lines[0].startswith("# .PCD")
    assert any(l.startswith("POINTS 11") for l in lines)


def test_map_export_cli(tmp_path):
    import os
    import subprocess
    import sys

    from ucoslam_tpu.io.serialize import save_map

    m, _ = build_small_map()
    p = str(tmp_path / "m.slm")
    save_map(m, p)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-m", "ucoslam_tpu.apps.map_export", p,
         "--ply", str(tmp_path / "o.ply"), "--strip-unused", str(tmp_path / "s.slm")],
        env=env, capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr[-1500:]
    assert "10 points, 1 keyframes" in r.stdout
    assert (tmp_path / "o.ply").exists() and (tmp_path / "s.slm").exists()


def test_marker_map_export_yaml(tmp_path):
    """Map::saveToMarkerMap counterpart: aruco MarkerMap YAML, readable by
    cv2.FileStorage (the reference's serializer)."""
    import jax.numpy as jnp
    from ucoslam_tpu.config import Params
    from ucoslam_tpu.mapping import Map
    from ucoslam_tpu.io.exporters import export_marker_map

    m = Map(Params().replace(maxMapPoints=64, maxKeyFrames=4, maxKeyPointsPerFrame=32))
    st = m.state
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = [1.0, 2.0, 5.0]
    m.state = st._replace(
        mk_pose=st.mk_pose.at[0].set(jnp.asarray(pose)),
        mk_pose_valid=st.mk_pose_valid.at[0].set(True),
        mk_size=st.mk_size.at[0].set(0.4),
        mk_id=st.mk_id.at[0].set(123),
    )
    path = str(tmp_path / "mm.yml")
    n = export_marker_map(m, path)
    assert n == 1
    import cv2

    fs = cv2.FileStorage(path, cv2.FILE_STORAGE_READ)
    assert int(fs.getNode("aruco_bc_nmarkers").real()) == 1
    mk = fs.getNode("aruco_bc_markers").at(0)
    assert int(mk.getNode("id").real()) == 123
    c0 = mk.getNode("corners").at(0).mat().ravel()
    np.testing.assert_allclose(c0, [1.0 - 0.2, 2.0 + 0.2, 5.0], atol=1e-6)
    fs.release()


def test_pmvs_export(tmp_path):
    from ucoslam_tpu.geometry.camera import CameraParams
    from ucoslam_tpu.io.exporters import export_pmvs
    import jax.numpy as jnp
    from ucoslam_tpu.config import Params
    from ucoslam_tpu.mapping import Map
    from ucoslam_tpu.mapping.frame import empty_frame

    m = Map(Params().replace(maxMapPoints=64, maxKeyFrames=4, maxKeyPointsPerFrame=32))
    for k in range(2):
        T = np.eye(4, dtype=np.float32)
        T[0, 3] = 0.1 * k
        m.add_keyframe(empty_frame(32)._replace(fseq=jnp.int32(k), pose_f2g=jnp.asarray(T)))
    cam = CameraParams.create(500.0, 500.0, 320.0, 240.0)
    out = str(tmp_path / "pmvs")
    n = export_pmvs(m, cam, out)
    assert n == 2
    txt = open(f"{out}/txt/00000000.txt").read().splitlines()
    assert txt[0] == "CONTOUR"
    P = np.array([[float(x) for x in r.split()] for r in txt[1:4]])
    np.testing.assert_allclose(P[:, :3], np.asarray(cam.K), rtol=1e-5)
    assert open(f"{out}/vis.dat").read().startswith("VISDATA 2")
    assert "timages -1 0 2" in open(f"{out}/option.txt").read()
