"""Projection matcher (match_points_to_frame) against a brute-force NumPy
matcher: frustum, scale-band and viewing-angle gates, radius and octave
gates, best/second by Hamming distance (lowest column on ties), Lowe's
ratio test and one point per keypoint."""

import numpy as np
import jax
import jax.numpy as jnp
from jax.export import export

from ucoslam_tpu.geometry.camera import CameraParams
from ucoslam_tpu.geometry.se3 import se3_exp
from ucoslam_tpu.mapping.frame import empty_frame
from ucoslam_tpu.matching.projection import match_points_to_frame
from ucoslam_tpu.ops.hamming import INVALID_DIST, match_best2

CAM = CameraParams.create(500.0, 500.0, 320.0, 240.0, width=640, height=480)
SF = np.float32(1.2)


def hamming(a, b):
    """(L, 8) x (N, 8) uint32 -> (L, N) bit distances."""
    x = (a[:, None, :] ^ b[None, :, :]).view(np.uint8)
    return np.unpackbits(x, axis=-1).sum(-1).astype(np.int64)


def brute_best2(d, mask):
    """Row by row: (best column, best, second) over the unmasked entries;
    the lowest column wins a tie, and second is at another column."""
    L, N = d.shape
    idx = np.zeros(L, np.int64)
    best = np.full(L, INVALID_DIST, np.int64)
    second = np.full(L, INVALID_DIST, np.int64)
    for i in range(L):
        for j in range(N):
            v = d[i, j] if mask[i, j] else INVALID_DIST
            if v < best[i]:
                idx[i], best[i], second[i] = j, v, best[i]
            elif v < second[i]:
                second[i] = v
    return idx, best, second


def brute_force_match(kw):
    """NumPy counterpart of match_points_to_frame -> (kpt_idx, n_visible)."""
    X = np.asarray(kw["pt_pos"], np.float64)
    T = np.asarray(kw["pose_f2g"], np.float64)
    R, t = T[:3, :3], T[:3, 3]
    q = X @ R.T + t
    uv = np.stack([CAM.fx * q[:, 0] / q[:, 2] + CAM.cx,
                   CAM.fy * q[:, 1] / q[:, 2] + CAM.cy], -1)
    ray = X + R.T @ t
    dist = np.linalg.norm(ray, axis=1)
    normal = np.asarray(kw["pt_normal"], np.float64)
    has_normal = np.linalg.norm(normal, axis=1) > 0.5
    angle_ok = ~has_normal | ((ray * normal).sum(1) / dist > 0.5)
    in_img = (uv[:, 0] >= 0) & (uv[:, 0] < 640) & (uv[:, 1] >= 0) & (uv[:, 1] < 480)
    lo, hi = np.asarray(kw["pt_min_dist"]), np.asarray(kw["pt_max_dist"])
    visible = (np.asarray(kw["pt_valid"]) & in_img & (q[:, 2] > 0.05)
               & (dist > 0.8 * lo) & (dist < 1.2 * hi) & angle_ok)
    pred = np.clip(np.ceil(np.log(hi / dist) / np.log(1.2)), 0, 7)

    f = kw["frame"]
    xy, octave = np.asarray(f.und_xy, np.float64), np.asarray(f.octave)
    radius = float(kw["proj_dist_thr"]) * 1.2 ** octave
    d2 = ((uv[:, None, :] - xy[None, :, :]) ** 2).sum(-1)
    mask = ((d2 < radius[None, :] ** 2) & (np.abs(octave[None, :] - pred[:, None]) <= 1)
            & visible[:, None] & np.asarray(f.valid)[None, :])
    idx, best, second = brute_best2(hamming(np.asarray(kw["pt_desc"]), np.asarray(f.desc)), mask)
    accept = (best <= float(kw["max_desc_dist"])) & (best < 0.9 * second)
    # one point per keypoint: the smallest distance, then the lowest row
    owner = {}
    for i in np.nonzero(accept)[0]:
        j = idx[i]
        if j not in owner or best[i] < best[owner[j]]:
            owner[j] = i
    out = np.full(len(X), -1)
    for j, i in owner.items():
        out[i] = j
    return out, int(visible.sum())


def scene(L=512, N=256, seed=5, pose=None, n_shared=100):
    """Map points in front of the camera, n_shared of them re-observed as
    keypoints near their projection with the same descriptor."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-3, 3, (L, 3)).astype(np.float32)
    X[:, 2] = rng.uniform(2, 20, L)
    dist = np.linalg.norm(X, axis=1)
    pt_desc = rng.integers(0, 2**32, (L, 8), dtype=np.uint32)
    frame_desc = rng.integers(0, 2**32, (N, 8), dtype=np.uint32)
    xy = rng.uniform(0, 640, (N, 2)).astype(np.float32)
    sel = rng.choice(L, n_shared, replace=False)
    ksel = rng.choice(N, n_shared, replace=False)
    # a few flipped bits, so distances differ from point to point
    flip = rng.integers(0, 2**32, (n_shared, 8), dtype=np.uint32)
    frame_desc[ksel] = pt_desc[sel] ^ (flip & (flip >> 3) & (flip >> 7))
    pose = np.eye(4, dtype=np.float32) if pose is None else pose
    q = X @ pose[:3, :3].T + pose[:3, 3]
    uv = np.asarray(CAM.project(jnp.asarray(q)))
    xy[ksel] = uv[sel] + rng.normal(0, 2, (n_shared, 2))
    frame = empty_frame(N)._replace(
        und_xy=jnp.asarray(xy),
        desc=jnp.asarray(frame_desc),
        octave=jnp.asarray(rng.integers(0, 8, N, dtype=np.int32)),
        valid=jnp.asarray(rng.random(N) < 0.95),
    )
    return dict(
        pt_pos=jnp.asarray(X),
        pt_desc=jnp.asarray(pt_desc),
        pt_normal=jnp.asarray((X / dist[:, None]).astype(np.float32)),
        pt_min_dist=jnp.asarray((dist / 1.2**7).astype(np.float32)),
        pt_max_dist=jnp.asarray((dist * 1.3).astype(np.float32)),
        pt_valid=jnp.asarray(rng.random(L) < 0.9),
        frame=frame,
        cam=CAM,
        pose_f2g=jnp.asarray(pose),
        proj_dist_thr=jnp.float32(15.0),
        max_desc_dist=jnp.float32(60.0),
        scale_factor=jnp.float32(SF),
    )


def check(kw, min_matched=10):
    got = jax.tree.map(np.asarray, match_points_to_frame(**kw))
    ref_idx, ref_visible = brute_force_match(kw)
    np.testing.assert_array_equal(got.kpt_idx, ref_idx)
    np.testing.assert_array_equal(got.point_valid, ref_idx >= 0)
    assert int(got.n_visible) == ref_visible
    assert int(got.n_matched) == int((ref_idx >= 0).sum()) >= min_matched
    return got


def test_matches_reference():
    check(scene())


def test_pose_and_descriptor_gate():
    """A moved camera and a tight descriptor threshold."""
    pose = np.asarray(se3_exp(jnp.asarray([0.05, -0.02, 0.1, 0.02, -0.03, 0.01])),
                      np.float32)
    kw = scene(seed=8, pose=pose)
    # shared descriptors differ by ~32 bits, so this gate drops about a quarter
    kw["max_desc_dist"] = jnp.float32(36.0)
    got = check(kw, min_matched=20)
    assert int(got.n_matched) < int(check(scene(seed=8, pose=pose)).n_matched)


def test_all_masked_rows():
    kw = scene()
    kw["pt_valid"] = jnp.zeros(512, bool)
    got = check(kw, min_matched=0)
    assert int(got.n_visible) == 0 and (got.kpt_idx == -1).all()
    kw = scene()
    kw["frame"] = kw["frame"]._replace(valid=jnp.zeros(256, bool))
    got = check(kw, min_matched=0)
    assert (got.kpt_idx == -1).all()


def test_multi_tile_merge():
    """best/second/argbest over many columns with ties: the lowest column
    wins, and the runner-up at another column may equal the best."""
    rng = np.random.default_rng(3)
    d = rng.integers(0, 12, (64, 1024))
    mask = rng.random((64, 1024)) < 0.5
    mask[5] = False
    d[7, [40, 700, 1000]] = -1  # three-way tie far apart
    mask[7, [40, 700, 1000]] = True
    idx, best, second = (np.asarray(x) for x in match_best2(
        jnp.asarray(d, jnp.int32), extra_mask=jnp.asarray(mask)))
    r_idx, r_best, r_second = brute_best2(d, mask)
    np.testing.assert_array_equal(best, r_best)
    np.testing.assert_array_equal(second, r_second)
    np.testing.assert_array_equal(idx, r_idx)
    assert (idx[7], best[7], second[7]) == (40, -1, -1)
    assert best[5] == second[5] == INVALID_DIST


def test_one_point_per_keypoint():
    """Two points on one keypoint: the nearer descriptor keeps it; a tied
    pair keeps the lower row; a tie between two keypoints fails the ratio
    test."""
    kw = scene(L=64, N=32, seed=11, n_shared=0)
    X = np.asarray(kw["pt_pos"]).copy()
    X[:6] = [[0, 0, 5], [0.001, 0, 5], [1, 0, 5], [1.001, 0, 5], [-1, 0, 5], [-1, 0, 5.001]]
    kw["pt_pos"] = jnp.asarray(X)
    kw["pt_normal"] = jnp.asarray(X / np.linalg.norm(X, axis=1, keepdims=True))
    dist = np.linalg.norm(X, axis=1)
    kw["pt_min_dist"] = jnp.asarray(dist / 1.2**7)
    # predicted octave 1, so the octave-0 keypoints pass the octave gate
    kw["pt_max_dist"] = jnp.asarray(dist * 1.1)
    kw["pt_valid"] = jnp.ones(64, bool)
    f = kw["frame"]
    xy, desc = np.asarray(f.und_xy).copy(), np.asarray(f.desc).copy()
    pd = np.asarray(kw["pt_desc"]).copy()
    xy[:4] = [[320, 240], [420, 240], [220, 240], [222, 240]]
    desc[0] = pd[0]
    pd[1] = pd[0] ^ np.uint32(0xFF)  # 8 bits further from keypoint 0
    desc[1] = pd[2]
    pd[3] = pd[2]  # same distance as point 2: the lower row keeps it
    desc[2] = desc[3] = pd[4]  # point 4: tied between keypoints 2 and 3
    pd[5] = pd[4] ^ np.uint32(0xFFFF)
    kw["pt_desc"] = jnp.asarray(pd)
    kw["frame"] = f._replace(und_xy=jnp.asarray(xy), desc=jnp.asarray(desc),
                             octave=jnp.zeros(32, jnp.int32), valid=jnp.ones(32, bool))
    got = check(kw, min_matched=2)
    assert list(got.kpt_idx[:6]) == [0, -1, 1, -1, -1, -1]


def test_production_matcher_backend_equivalence():
    """The matcher compiled for CUDA is plain XLA: no custom kernel call."""
    kw = scene(L=256, N=128)
    fn = jax.jit(lambda *a: match_points_to_frame(*a))
    args = tuple(kw.values())
    text = export(fn, platforms=["cuda"])(*args).mlir_module()
    assert "custom_call" not in text
    got = jax.tree.map(np.asarray, fn(*args))
    np.testing.assert_array_equal(got.kpt_idx, brute_force_match(kw)[0])
