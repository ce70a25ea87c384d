"""ArUco marker detection producing FrameMarkers.

Counterpart of the reference's vendored aruco detector
(3rdparty/aruco/aruco/markerdetector.h:88,276) configured by
aruco_Dictionary / aruco_DetectionMode / aruco_CornerRefimentMethod
(ucoslamtypes.h:120-122). Per SURVEY.md §2.2, a host-side detector is the
v1 design (image-morphology heavy, small cost); corner refinement comes
from the detector and pose pairs come from our batched JAX IPPE.

Backend: OpenCV's aruco module when available (it ships the reference's
default ARUCO_MIP_36h12 dictionary); otherwise detection is disabled and
the SLAM pipeline runs keypoints-only (the reference behaves the same with
detectMarkers=false).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ucoslam_tpu.geometry.camera import CameraParams
from ucoslam_tpu.mapping.frame import MAX_MARKERS_PER_FRAME, FrameMarkers
from ucoslam_tpu.markers.ippe import ippe_square_poses


def empty_markers() -> FrameMarkers:
    """Host-numpy empty markers: the no-detection path runs every frame
    and downstream control flow reads .valid on host."""
    from ucoslam_tpu.features.frame_extractor import _empty_markers_host

    return _empty_markers_host()

_DICT_MAP = {
    "ARUCO_MIP_36h12": "DICT_ARUCO_MIP_36h12",
    "ARUCO": "DICT_ARUCO_ORIGINAL",
    "ARUCO_ORIGINAL": "DICT_ARUCO_ORIGINAL",
    "TAG36h11": "DICT_APRILTAG_36h11",
    "4X4_250": "DICT_4X4_250",
    "6X6_250": "DICT_6X6_250",
}


class ArucoDetector:
    """Marker detector facade: native C++ backend first, cv2 fallback.

    backend: "native" (native/aruco_detector.cpp — only ARUCO_MIP_36h12),
    "cv2", or "auto".
    """

    #: dictionaries with native codeword tables (native/ headers)
    NATIVE_DICTS = ("ARUCO_MIP_36h12", "ARUCO_MIP_16h3")

    def __init__(self, dictionary: str = "ARUCO_MIP_36h12", marker_size: float = 1.0,
                 corner_refine: str = "CORNER_SUBPIX", backend: str = "auto",
                 detection_mode: str = "DM_NORMAL", min_marker_size: float = 0.0):
        self.marker_size = float(marker_size)
        self.dictionary = dictionary
        # detection mode (reference markerdetector.h setDetectionMode /
        # getDetectionModeFromString): DM_NORMAL = full-accuracy search;
        # DM_FAST / DM_VIDEO_FAST = cheaper search that only admits larger
        # quads (min perimeter raised) and skips the most expensive decode
        # retries. min_marker_size is the reference's aruco_minMarkerSize:
        # a fraction of the larger image dimension below which candidates
        # are rejected (markerdetector.h:88 region).
        self.detection_mode = detection_mode
        self.min_marker_size = float(min_marker_size)
        self._detector = None
        self._native = False
        if backend in ("auto", "native") and dictionary in self.NATIVE_DICTS:
            from ucoslam_tpu.markers.native import native_available

            if native_available():
                self._native = True
                self._detector = "native"
        if self._detector is None and backend != "native":
            try:
                import cv2
                import cv2.aruco as aruco
            except ImportError:  # keypoints-only operation
                return
            name = _DICT_MAP.get(dictionary, dictionary)
            dict_obj = aruco.getPredefinedDictionary(getattr(aruco, name))
            params = aruco.DetectorParameters()
            if corner_refine == "CORNER_SUBPIX":
                params.cornerRefinementMethod = aruco.CORNER_REFINE_SUBPIX
            elif corner_refine == "CORNER_LINES":
                params.cornerRefinementMethod = aruco.CORNER_REFINE_CONTOUR
            if self.min_marker_size > 0:
                params.minMarkerPerimeterRate = 4.0 * self.min_marker_size
            if self.detection_mode in ("DM_FAST", "DM_VIDEO_FAST"):
                # one adaptive-threshold scale instead of the full sweep
                params.adaptiveThreshWinSizeMin = 15
                params.adaptiveThreshWinSizeMax = 15
            self._cv2 = cv2
            self._detector = aruco.ArucoDetector(dict_obj, params)

    @property
    def available(self) -> bool:
        return self._detector is not None

    @property
    def backend(self) -> str | None:
        """"native", "cv2", or None when no backend could be loaded."""
        if self._detector is None:
            return None
        return "native" if self._native else "cv2"

    def _detect_raw(self, gray: np.ndarray):
        """-> (ids list, corners (n, 4, 2))."""
        if self._native:
            from ucoslam_tpu.markers.native import detect_markers_native

            min_perim = 40
            if self.min_marker_size > 0:
                min_perim = max(
                    min_perim,
                    int(4.0 * self.min_marker_size * max(gray.shape)),
                )
            if self.detection_mode in ("DM_FAST", "DM_VIDEO_FAST"):
                # fast mode: single threshold window (encoded as negative
                # max_correction), larger min size, no bit-error correction
                min_perim = max(min_perim, 60)
                max_corr = -1
            else:
                max_corr = 1
            ids, corners = detect_markers_native(
                gray, dictionary=self.dictionary,
                min_perimeter=min_perim, max_correction=max_corr,
            )
            return list(ids), corners
        corners, ids, _ = self._detector.detectMarkers(gray)
        if ids is None or len(ids) == 0:
            return [], np.zeros((0, 4, 2), np.float32)
        return [int(i) for i in ids.ravel()], np.stack(
            [c.reshape(4, 2) for c in corners]
        )

    def detect(self, img: np.ndarray, cam: CameraParams) -> FrameMarkers:
        """Detect markers; fill corners, undistorted corners, IPPE poses."""
        if self._detector is None:
            return empty_markers()
        gray = img
        if gray.ndim == 3:
            gray = (
                0.114 * gray[..., 0] + 0.587 * gray[..., 1] + 0.299 * gray[..., 2]
            )
        gray = np.clip(gray, 0, 255).astype(np.uint8)
        ids_l, corners_l = self._detect_raw(gray)
        out = empty_markers()
        if not ids_l:
            return out
        n = min(len(ids_l), MAX_MARKERS_PER_FRAME)
        corner_arr = np.zeros((MAX_MARKERS_PER_FRAME, 4, 2), np.float32)
        id_arr = np.full(MAX_MARKERS_PER_FRAME, -1, np.int32)
        for i in range(n):
            corner_arr[i] = corners_l[i]
            id_arr[i] = ids_l[i]
        valid = np.arange(MAX_MARKERS_PER_FRAME) < n

        und = cam.undistort_points(jnp.asarray(corner_arr)) if cam.has_distortion() \
            else jnp.asarray(corner_arr)
        sizes = jnp.full((MAX_MARKERS_PER_FRAME,), self.marker_size, jnp.float32)
        p1, p2, e1, e2 = ippe_square_poses(und, sizes, cam)
        # host-numpy leaves: every consumer of FrameMarkers (tracker marker
        # rows, markermap bookkeeping, keyframe policy) reads these on host;
        # one bundled fetch here beats a round trip per np.asarray later
        und, p1, p2, e1, e2 = jax.device_get((und, p1, p2, e1, e2))
        err_ratio = np.where(valid, e2 / np.clip(e1, 1e-9, None), 0.0).astype(
            np.float32
        )
        return FrameMarkers(
            id=id_arr,
            corners=corner_arr,
            und_corners=und,
            pose1=p1,
            pose2=p2,
            err_ratio=err_ratio,
            valid=valid,
        )


class SyntheticMarkerDetector:
    """Oracle detector for tests: projects known marker poses to corners."""

    def __init__(self, marker_poses_g2m: dict[int, np.ndarray], marker_size: float):
        self.poses = marker_poses_g2m  # id -> (4, 4) marker->global
        self.size = marker_size

    def detect_at_pose(self, pose_f2g: np.ndarray, cam: CameraParams,
                       noise: float = 0.0, rng=None) -> FrameMarkers:
        from ucoslam_tpu.markers.ippe import marker_object_points

        out = empty_markers()
        corner_arr = np.zeros((MAX_MARKERS_PER_FRAME, 4, 2), np.float32)
        id_arr = np.full(MAX_MARKERS_PER_FRAME, -1, np.int32)
        obj = np.asarray(marker_object_points(jnp.float32(self.size)))
        k = 0
        for mid, g2m in sorted(self.poses.items()):
            if k >= MAX_MARKERS_PER_FRAME:
                break
            T = pose_f2g @ g2m  # marker -> camera
            pts_c = obj @ T[:3, :3].T + T[:3, 3]
            if (pts_c[:, 2] <= 0.1).any():
                continue
            uv = np.asarray(cam.project(jnp.asarray(pts_c)))
            if (
                (uv[:, 0] < 0).any() or (uv[:, 0] >= cam.width).any()
                or (uv[:, 1] < 0).any() or (uv[:, 1] >= cam.height).any()
            ):
                continue
            if noise > 0 and rng is not None:
                uv = uv + rng.normal(0, noise, uv.shape)
            corner_arr[k] = uv
            id_arr[k] = mid
            k += 1
        if k == 0:
            return out
        valid = np.arange(MAX_MARKERS_PER_FRAME) < k
        sizes = jnp.full((MAX_MARKERS_PER_FRAME,), self.size, jnp.float32)
        p1, p2, e1, e2 = ippe_square_poses(jnp.asarray(corner_arr), sizes, cam)
        p1, p2, e1, e2 = jax.device_get((p1, p2, e1, e2))
        return FrameMarkers(
            id=id_arr,
            corners=corner_arr,
            und_corners=corner_arr.copy(),
            pose1=p1,
            pose2=p2,
            err_ratio=np.where(
                valid, e2 / np.clip(e1, 1e-9, None), 0.0
            ).astype(np.float32),
            valid=valid,
        )
