"""Per-frame record: fixed-capacity SoA keypoint + marker tensors.

Counterpart of the reference `Frame` (src/map_types/frame.h:48-236): raw and
undistorted keypoints, descriptors, per-keypoint map-point ids, depths,
markers with IPPE pose pairs, pose_f2g, and scale-prediction helpers. The
reference's per-frame kd-tree (frame.h:124) has no equivalent here —
radius queries are dense masked distance computations at device batch sizes.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from ucoslam_tpu.geometry.camera import CameraParams

MAX_MARKERS_PER_FRAME = 16


class FrameMarkers(NamedTuple):
    """ArUco observations of one frame (padded to MAX_MARKERS_PER_FRAME).

    Counterpart of MarkerObservation + MarkerPosesIPPE (marker.h:57-104):
    two candidate rigid transforms from the IPPE homography decomposition
    plus their reprojection-error ratio.
    """

    id: jnp.ndarray  # (M,) int32 aruco id, -1 = empty slot
    corners: jnp.ndarray  # (M, 4, 2) float32 raw pixel corners
    und_corners: jnp.ndarray  # (M, 4, 2) float32 undistorted corners
    pose1: jnp.ndarray  # (M, 4, 4) float32 best IPPE pose (marker->camera)
    pose2: jnp.ndarray  # (M, 4, 4) float32 second IPPE pose
    err_ratio: jnp.ndarray  # (M,) float32 err2/err1 (>=1; large = unambiguous)
    valid: jnp.ndarray  # (M,) bool


class Frame(NamedTuple):
    """One processed input frame (all arrays fixed-capacity, mask `valid`)."""

    fseq: jnp.ndarray  # () int32 frame sequence index
    xy: jnp.ndarray  # (N, 2) float32 raw keypoint pixels (level-0)
    und_xy: jnp.ndarray  # (N, 2) float32 undistorted pixels
    octave: jnp.ndarray  # (N,) int32
    angle: jnp.ndarray  # (N,) float32
    response: jnp.ndarray  # (N,) float32
    desc: jnp.ndarray  # (N, 8) uint32
    depth: jnp.ndarray  # (N,) float32; 0 = no depth (mono)
    valid: jnp.ndarray  # (N,) bool
    ids: jnp.ndarray  # (N,) int32 map-point slot or -1 (frame.h 'ids')
    pose_f2g: jnp.ndarray  # (4, 4) float32 global->camera (ref convention)
    markers: FrameMarkers

    @property
    def n(self) -> int:
        return self.xy.shape[0]

    def project(self, cam: CameraParams, points_w: jnp.ndarray) -> jnp.ndarray:
        """World points -> undistorted pixels under this frame's pose
        (counterpart of the inlined Frame::project, frame.h:140)."""
        R = self.pose_f2g[:3, :3]
        t = self.pose_f2g[:3, 3]
        cam_pts = points_w @ R.T + t
        return cam.project(cam_pts)

    def get3d_stereo_point(self, cam: CameraParams, idx: jnp.ndarray) -> jnp.ndarray:
        """Back-project keypoint idx using its depth, in camera frame
        (counterpart of Frame::get3dStereoPoint, frame.h:160)."""
        return cam.unproject(self.und_xy[idx], self.depth[idx])


def empty_markers(m: int = MAX_MARKERS_PER_FRAME) -> FrameMarkers:
    return FrameMarkers(
        id=jnp.full((m,), -1, jnp.int32),
        corners=jnp.zeros((m, 4, 2), jnp.float32),
        und_corners=jnp.zeros((m, 4, 2), jnp.float32),
        pose1=jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (m, 4, 4)),
        pose2=jnp.broadcast_to(jnp.eye(4, dtype=jnp.float32), (m, 4, 4)),
        err_ratio=jnp.zeros((m,), jnp.float32),
        valid=jnp.zeros((m,), bool),
    )


_EMPTY_MARKERS_DEV = None


def strip_markers(frame: Frame) -> Frame:
    """Replace the markers with a cached DEVICE empty constant.

    Frames carry host-numpy marker leaves (host control flow reads them
    every frame); jitted programs that ignore markers would still upload
    all seven numpy arrays on every call. The cached device constant
    transfers once per process."""
    global _EMPTY_MARKERS_DEV
    if _EMPTY_MARKERS_DEV is None:
        _EMPTY_MARKERS_DEV = jax.device_put(empty_markers())
    return frame._replace(markers=_EMPTY_MARKERS_DEV)


def empty_frame(n: int, m: int = MAX_MARKERS_PER_FRAME) -> Frame:
    return Frame(
        fseq=jnp.int32(-1),
        xy=jnp.zeros((n, 2), jnp.float32),
        und_xy=jnp.zeros((n, 2), jnp.float32),
        octave=jnp.zeros((n,), jnp.int32),
        angle=jnp.zeros((n,), jnp.float32),
        response=jnp.zeros((n,), jnp.float32),
        desc=jnp.zeros((n, 8), jnp.uint32),
        depth=jnp.zeros((n,), jnp.float32),
        valid=jnp.zeros((n,), bool),
        ids=jnp.full((n,), -1, jnp.int32),
        pose_f2g=jnp.eye(4, dtype=jnp.float32),
        markers=empty_markers(m),
    )
