"""Map-point -> frame projection matching.

Counterpart of Map::matchFrameToMapPoints (map.cpp:651, used from the
tracker at system.cpp:5339): project candidate map points into the frame
under a pose prior, search keypoints within a pixel radius, gate by
descriptor distance / scale compatibility / viewing angle, and resolve
ambiguities. The reference's per-frame kd-tree radius query becomes a dense
(L, N) masked distance computation.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ucoslam_tpu.geometry.camera import CameraParams
from ucoslam_tpu.mapping.frame import Frame
from ucoslam_tpu.ops.hamming import (
    INVALID_DIST,
    filter_ambiguous_train_sized,
    hamming_matrix_mxu,
    match_best2,
)


class ProjectionMatches(NamedTuple):
    kpt_idx: jnp.ndarray  # (L,) int32 matched keypoint index per local point
    point_valid: jnp.ndarray  # (L,) bool match accepted
    n_visible: jnp.ndarray  # () int32 points that projected into the image
    n_matched: jnp.ndarray  # () int32 accepted matches


@jax.jit
def match_points_to_frame(
    pt_pos: jnp.ndarray,  # (L, 3) world positions of candidate points
    pt_desc: jnp.ndarray,  # (L, 8) uint32
    pt_normal: jnp.ndarray,  # (L, 3) mean viewing direction (unit)
    pt_min_dist: jnp.ndarray,  # (L,)
    pt_max_dist: jnp.ndarray,  # (L,)
    pt_valid: jnp.ndarray,  # (L,) bool
    frame: Frame,
    cam: CameraParams,
    pose_f2g: jnp.ndarray,  # (4, 4) prior pose
    proj_dist_thr: jnp.ndarray,  # () float32 search radius in pixels (level 0)
    max_desc_dist: jnp.ndarray,  # () float32
    scale_factor: jnp.ndarray = 1.2,
) -> ProjectionMatches:
    R = pose_f2g[:3, :3]
    t = pose_f2g[:3, 3]
    cam_pts = pt_pos @ R.T + t  # (L, 3)
    uv = cam.project(cam_pts)  # (L, 2)
    cam_center = -R.T @ t
    view_ray = pt_pos - cam_center
    dist = jnp.linalg.norm(view_ray, axis=-1)

    # Frustum + scale-band + viewing-angle gates (the reference's frustum
    # checks before the radius search; viewCos>0.5 as in pnpsolver.cpp:96).
    in_img = cam.in_image(uv)
    z_ok = cam_pts[:, 2] > 0.05
    band_ok = (dist > 0.8 * pt_min_dist) & (dist < 1.2 * pt_max_dist)
    view_cos = jnp.sum(view_ray * pt_normal, -1) / dist.clip(1e-9)
    # points with zero normal (not yet set) pass the angle gate
    has_normal = jnp.linalg.norm(pt_normal, axis=-1) > 0.5
    angle_ok = jnp.where(has_normal, view_cos > 0.5, True)
    visible = pt_valid & in_img & z_ok & band_ok & angle_ok

    # Predicted octave from distance (Frame::predictScale, frame.h:129).
    log_sf = jnp.log(scale_factor)
    pred_octave = jnp.clip(
        jnp.ceil(jnp.log(pt_max_dist.clip(1e-9) / dist.clip(1e-9)) / log_sf),
        0,
        7,
    ).astype(jnp.int32)

    # Spatial radius per keypoint octave (reference scales search radius by
    # the keypoint's octave scale).
    kp_scale = jnp.exp(frame.octave.astype(jnp.float32) * log_sf)
    radius = proj_dist_thr * kp_scale  # (N,)

    d2 = jnp.sum((uv[:, None, :] - frame.und_xy[None, :, :]) ** 2, -1)
    in_radius = d2 < (radius[None, :] ** 2)
    octave_ok = jnp.abs(frame.octave[None, :] - pred_octave[:, None]) <= 1
    dmat = hamming_matrix_mxu(pt_desc, frame.desc)  # (L, N)
    mask = in_radius & octave_ok & visible[:, None] & frame.valid[None, :]
    kpt_idx, best, second = match_best2(dmat, extra_mask=mask)
    accept = (best <= max_desc_dist) & (best.astype(jnp.float32) < 0.9 * second)
    # one point per keypoint: keep the best-scoring claimant
    keep = filter_ambiguous_train_sized(kpt_idx, jnp.where(accept, best, INVALID_DIST), frame.n)
    accept = accept & keep
    return ProjectionMatches(
        kpt_idx=jnp.where(accept, kpt_idx, -1),
        point_valid=accept,
        n_visible=jnp.sum(visible),
        n_matched=jnp.sum(accept),
    )
