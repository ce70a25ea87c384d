"""Frame ingestion: raw image(s) -> fully-populated Frame.

Counterpart of the reference FrameExtractor (frameextractor.{h,cpp},
obfuscated; behavior per SURVEY.md §2): BGR->gray, optional resize by
kptImageScaleFactor, keypoint detect+describe, keypoint undistortion,
ArUco marker detection + IPPE (plug-in detector), stereo row matching ->
per-keypoint depth (frameextractor.cpp:1456-2595), RGB-D depth ingestion
scaled by rgb_depthscale (:2688-2815).
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp

from ucoslam_tpu.config import Params
from ucoslam_tpu.features.orb import ORBExtractor
from ucoslam_tpu.geometry.camera import CameraParams
from ucoslam_tpu.mapping.frame import Frame, empty_frame, empty_markers
from ucoslam_tpu.ops.hamming import (
    INVALID_DIST,
    hamming_matrix,
    match_best2,
    mutual_best,
)
from ucoslam_tpu.ops.image import rgb_to_gray, bilinear_sample


class FrameExtractor:
    def __init__(self, params: Params, cam: CameraParams, marker_detector=None):
        from ucoslam_tpu.config import DescriptorType

        self.params = params
        self.cam = cam
        native = {
            DescriptorType.ORB: "orb",
            DescriptorType.FREAK: "freak",
            DescriptorType.SURF: "surf",
        }
        if params.kpDescriptorType in native:
            # the detector budget is maxFeatures (ucoslamtypes.h:98),
            # bounded by the frame's padded keypoint capacity
            self.orb = ORBExtractor(
                max_features=min(params.maxFeatures, params.maxKeyPointsPerFrame),
                n_levels=params.nOctaveLevels,
                scale_factor=params.scaleFactor,
                # KPNonMaximaSuppresion thins the keypoint field -> smaller
                # maps (reference semantics): one keypoint per coarse cell
                cell=64 if params.KPNonMaximaSuppresion else 32,
                k_per_cell=1 if params.KPNonMaximaSuppresion else 4,
                descriptor=native[params.kpDescriptorType],
            )
        else:
            # Feature2DSerializable::create plug point: AKAZE/BRISK route
            # through the cv2-backed GridExtractor (gridextractor.cpp:36-39)
            from ucoslam_tpu.features.grid_extractor import GridExtractor

            self.orb = GridExtractor(params)
        self.marker_detector = marker_detector
        self._sensitivity_boost = 0.0  # autoAdjustKpSensitivity state
        self._ingest_cache = {}  # img shape -> jitted ingest program
        self._pending_fill = None  # device scalar from the previous frame
        self._prefetched = None  # (id(img), device buffer)

    def prefetch(self, img: np.ndarray) -> None:
        """Start the host->device copy of the NEXT frame's image early.

        The image upload is a serial step at the head of every frame;
        harness loops that know the next image can overlap it with the
        current frame's host work.
        """
        import jax

        self._prefetched = (id(img), jax.device_put(img))

    def _take_prefetched(self, img: np.ndarray):
        if self._prefetched is not None and self._prefetched[0] == id(img):
            buf = self._prefetched[1]
            self._prefetched = None
            return buf
        return img

    def _base_frame(self, img: np.ndarray, fseq: int) -> Frame:
        from ucoslam_tpu.utils import timers

        with timers.stage("extract"):
            return self._base_frame_impl(img, fseq)

    def _make_ingest(self, shape):
        """One jitted program: gray -> (resize) -> detect+describe ->
        undistort -> pad-to-capacity. A single dispatch per frame instead
        of a dozen eager ops, each of which costs a dispatch."""
        cap = self.params.maxKeyPointsPerFrame
        cam = self.cam
        has_dist = cam.has_distortion()
        orb = self.orb
        # optional detector-resolution reduction (kptImageScaleFactor,
        # ucoslamtypes.h:131; the reference resizes the gray image before
        # detection and keeps all downstream coordinates full-resolution).
        # targetFocus (ucoslamtypes.h:152) normalizes detector resolution
        # across cameras: scale so the focal length matches the focus the
        # keypoint parameters were tuned for.
        ksf = float(self.params.kptImageScaleFactor)
        if self.params.targetFocus > 0:
            ksf *= min(1.0, float(self.params.targetFocus) / float(cam.fx))

        def fit(a, fill=0):
            """Pad the detector's maxFeatures rows to the frame capacity."""
            n = a.shape[0]
            if n == cap:
                return a
            pad = [(0, cap - n)] + [(0, 0)] * (a.ndim - 1)
            return jnp.pad(a, pad, constant_values=fill)

        def ingest(img, threshold, fseq):
            gray = rgb_to_gray(img)
            if ksf != 1.0:
                H, W = gray.shape
                small = (max(8, int(round(H * ksf))), max(8, int(round(W * ksf))))
                gray_det = jax.image.resize(gray, small, method="linear")
                kps = orb._detect_and_compute(gray_det, threshold)
                kps = kps._replace(xy=kps.xy / jnp.float32(ksf))
            else:
                kps = orb._detect_and_compute(gray, threshold)
            und = cam.undistort_points(kps.xy) if has_dist else kps.xy
            fill_frac = kps.valid.astype(jnp.float32).mean()
            f = empty_frame(cap)
            f = f._replace(
                fseq=fseq,
                xy=fit(kps.xy),
                und_xy=fit(und),
                octave=fit(kps.octave),
                angle=fit(kps.angle),
                response=fit(kps.response),
                desc=fit(kps.desc),
                valid=fit(kps.valid, fill=False),
            )
            return f, fill_frac

        return jax.jit(ingest)

    def _base_frame_impl(self, img: np.ndarray, fseq: int) -> Frame:
        if self.params.autoAdjustKpSensitivity and self._pending_fill is not None:
            # low-texture adaptation (ORBextractor::setSensitivity,
            # ORBextractor.h:113): when the detector underfills its budget,
            # lower the FAST threshold for subsequent frames; restore
            # slowly. Uses the PREVIOUS frame's fill so the current frame
            # needs no blocking device fetch.
            fill = float(jax.device_get(self._pending_fill))
            if fill < 0.5 and getattr(self.orb, "fast_threshold", None):
                self.orb.fast_threshold = max(3.0, self.orb.fast_threshold - 1.0)
            elif fill > 0.9 and getattr(self.orb, "fast_threshold", 0) < 7.0:
                self.orb.fast_threshold = min(7.0, self.orb.fast_threshold + 1.0)
        if hasattr(self.orb, "_detect_and_compute"):
            key = img.shape
            prog = self._ingest_cache.get(key)
            if prog is None:
                prog = self._ingest_cache[key] = self._make_ingest(key)
            dev_img = self._take_prefetched(img)
            f, fill_frac = prog(
                dev_img, jnp.float32(self.orb.fast_threshold), np.int32(fseq)
            )
            if self.params.autoAdjustKpSensitivity:
                self._pending_fill = fill_frac
            # host-scalar fseq and host empty markers: control flow reads
            # them every frame (int(frame.fseq), markers.valid.any()) and
            # neither may cost a device fetch
            f = f._replace(fseq=np.int32(fseq), markers=_empty_markers_host())
        else:
            # cv2-backed GridExtractor path (host detector): keep the
            # eager composition — the detector itself runs on host anyway
            f = self._base_frame_grid(img, fseq)
        if self.params.detectMarkers and self.marker_detector is not None:
            f = f._replace(markers=self.marker_detector.detect(np.asarray(img), self.cam))
            if self.params.removeKeyPointsIntoMarkers:
                # drop keypoints inside detected marker quads
                # (Params::removeKeyPointsIntoMarkers, ucoslamtypes.h:157):
                # marker interiors are texture the map must not depend on —
                # their points die when the marker leaves the view
                inside = _points_in_quads(
                    f.xy, f.markers.corners, f.markers.valid
                )
                f = f._replace(valid=f.valid & ~inside)
        return f

    def _base_frame_grid(self, img: np.ndarray, fseq: int) -> Frame:
        """Eager ingest for host (cv2) detectors — GridExtractor has no
        jittable detect, so the composition stays on host."""
        gray = rgb_to_gray(jnp.asarray(img))
        ksf = float(self.params.kptImageScaleFactor)
        if self.params.targetFocus > 0:
            ksf *= min(1.0, float(self.params.targetFocus) / float(self.cam.fx))
        if ksf != 1.0:
            H, W = gray.shape
            small = (max(8, int(round(H * ksf))), max(8, int(round(W * ksf))))
            gray_det = jax.image.resize(gray, small, method="linear")
            kps = self.orb.detect_and_compute(gray_det)
            kps = kps._replace(xy=kps.xy / jnp.float32(ksf))
        else:
            kps = self.orb.detect_and_compute(gray)
        und = self.cam.undistort_points(kps.xy) if self.cam.has_distortion() else kps.xy
        cap = self.params.maxKeyPointsPerFrame

        def fit(a, fill=0):
            n = a.shape[0]
            if n == cap:
                return a
            pad = [(0, cap - n)] + [(0, 0)] * (a.ndim - 1)
            return jnp.pad(a, pad, constant_values=fill)

        f = empty_frame(cap)
        return f._replace(
            fseq=jnp.int32(fseq),
            xy=fit(kps.xy),
            und_xy=fit(und),
            octave=fit(kps.octave),
            angle=fit(kps.angle),
            response=fit(kps.response),
            desc=fit(kps.desc),
            valid=fit(kps.valid, fill=False),
        )

    # -- monocular ------------------------------------------------------
    def process(self, img: np.ndarray, fseq: int = 0) -> Frame:
        return self._base_frame(img, fseq)

    # -- RGB-D ----------------------------------------------------------
    def process_rgbd(self, img: np.ndarray, depth: np.ndarray, fseq: int = 0) -> Frame:
        """depth: (H, W) raw depth image; meters = raw * rgb_depthscale."""
        f = self._base_frame(img, fseq)
        d = bilinear_sample(jnp.asarray(depth, jnp.float32), f.xy, mode="nearest")
        d = d * self.cam.rgb_depthscale
        d = jnp.where(f.valid & (d > 0), d, 0.0)
        return f._replace(depth=d)

    # -- stereo ---------------------------------------------------------
    def process_stereo(self, left: np.ndarray, right: np.ndarray, fseq: int = 0) -> Frame:
        """Rectified stereo: match left keypoints along right rows -> depth.

        The reference matches L/R along rectified rows, refines the match
        to subpixel with a SAD parabola along the row, and stores depth =
        bl * fx / disparity (frameextractor.cpp:1456-2595).
        """
        f = self._base_frame(left, fseq)
        gray_l = rgb_to_gray(jnp.asarray(left))
        gray_r = rgb_to_gray(jnp.asarray(right))
        kr = self.orb.detect_and_compute(gray_r)
        # disparity window from camera geometry: z >= baseline =>
        # disparity <= bf / bl = fx (not a hardcoded pixel constant)
        max_disp = self.cam.bf / self.cam.bl if self.cam.bl > 0 else float(self.cam.fx)
        depth = _stereo_depth(
            f, gray_l, gray_r, kr.xy, kr.desc, kr.octave, kr.valid,
            jnp.float32(self.cam.bf),
            jnp.float32(max_disp),
            jnp.float32(self.params.maxDescDistance),
        )
        return f._replace(depth=depth)


_EMPTY_MARKERS_NP = None


def _empty_markers_host():
    """Host-numpy FrameMarkers (module-level constant)."""
    global _EMPTY_MARKERS_NP
    if _EMPTY_MARKERS_NP is None:
        from ucoslam_tpu.mapping.frame import FrameMarkers, MAX_MARKERS_PER_FRAME

        m = MAX_MARKERS_PER_FRAME
        _EMPTY_MARKERS_NP = FrameMarkers(
            id=np.full((m,), -1, np.int32),
            corners=np.zeros((m, 4, 2), np.float32),
            und_corners=np.zeros((m, 4, 2), np.float32),
            pose1=np.broadcast_to(np.eye(4, dtype=np.float32), (m, 4, 4)),
            pose2=np.broadcast_to(np.eye(4, dtype=np.float32), (m, 4, 4)),
            err_ratio=np.zeros((m,), np.float32),
            valid=np.zeros((m,), bool),
        )
    return _EMPTY_MARKERS_NP


@jax.jit
def _points_in_quads(xy: jnp.ndarray, quads: jnp.ndarray, quad_valid: jnp.ndarray):
    """(N, 2) points x (M, 4, 2) convex quads -> (N,) bool inside-any.

    A point is inside a convex quad when it lies on the same side of all
    four (cyclic) edges. Marker corners come in a consistent winding from
    the detector; test both signs to be winding-agnostic.
    """
    a = quads  # (M, 4, 2)
    b = jnp.roll(quads, -1, axis=1)  # next corner
    e = b - a  # (M, 4, 2) edge vectors
    r = xy[:, None, None, :] - a[None, :, :, :]  # (N, M, 4, 2)
    cross = e[None, ..., 0] * r[..., 1] - e[None, ..., 1] * r[..., 0]  # (N, M, 4)
    inside = jnp.all(cross >= 0, -1) | jnp.all(cross <= 0, -1)  # (N, M)
    return jnp.any(inside & quad_valid[None, :], -1)


@jax.jit
def _stereo_depth(
    f: Frame, gray_l, gray_r, xy_r, desc_r, octave_r, valid_r, bf, max_disp,
    max_desc_dist,
):
    d = hamming_matrix(f.desc, desc_r)
    row_ok = jnp.abs(f.xy[:, None, 1] - xy_r[None, :, 1]) <= 2.0
    disp = f.xy[:, None, 0] - xy_r[None, :, 0]
    disp_ok = (disp > 0.0) & (disp < max_disp)
    oct_ok = jnp.abs(f.octave[:, None] - octave_r[None, :]) <= 1
    mask = row_ok & disp_ok & oct_ok & valid_r[None, :] & f.valid[:, None]
    idx, best, second = match_best2(d, valid_rows=f.valid, extra_mask=mask)
    # mutual nearest neighbours only: repetitive structure along a
    # rectified row aliases badly, and a one-way best match silently
    # yields a wrong (often huge) disparity error
    dm = jnp.where(mask, d, INVALID_DIST)
    mut = mutual_best(dm)
    ok = (best <= max_desc_dist) & (mut == idx)

    # ---- subpixel refinement along the rectified row ------------------
    # SAD of an 11x11 patch over +/-4 px of the matched column, parabola
    # fit around the minimum (the reference refines before bf/disp,
    # frameextractor.cpp:1456-2595). Descriptor match coordinates are
    # keypoint-grid quantized; this recovers the fractional disparity that
    # dominates depth error at small disparity.
    W, R = 5, 4
    du = jnp.arange(-W, W + 1, dtype=jnp.float32)
    grid = jnp.stack(
        jnp.meshgrid(du, du, indexing="xy"), -1
    ).reshape(-1, 2)  # (121, 2) patch offsets
    ptsL = f.xy[:, None, :] + grid[None, :, :]  # (N, 121, 2)
    patchL = bilinear_sample(gray_l, ptsL, mode="bilinear")  # (N, 121)
    x_r0 = xy_r[idx, 0]
    y_r = xy_r[idx, 1]
    offs = jnp.arange(-R, R + 1, dtype=jnp.float32)  # (9,)
    base = jnp.stack([x_r0, y_r], -1)  # (N, 2)
    ptsR = (
        base[:, None, None, :]
        + grid[None, None, :, :]
        + jnp.pad(offs[None, :, None, None], ((0, 0),) * 3 + ((0, 1),))
    )  # (N, 9, 121, 2) — offset only displaces x
    patchR = bilinear_sample(gray_r, ptsR, mode="bilinear")  # (N, 9, 121)
    sad = jnp.sum(jnp.abs(patchR - patchL[:, None, :]), -1)  # (N, 9)
    j = jnp.argmin(sad, -1)
    jc = jnp.clip(j, 1, 2 * R - 1)  # interior for the vertex fit
    rows = jnp.arange(sad.shape[0])
    s0 = sad[rows, jc - 1]
    s1 = sad[rows, jc]
    s2 = sad[rows, jc + 1]
    # equiangular (V-shape) vertex fit: SAD of a step edge is piecewise
    # LINEAR in the offset, so the parabola fit is biased — the two-slope
    # line fit recovers the fractional offset exactly for a V profile
    hi = jnp.maximum(s0, s2)
    delta = jnp.where(hi > s1 + 1e-6, 0.5 * (s0 - s2) / (hi - s1), 0.0)
    delta = jnp.clip(delta, -1.0, 1.0)
    x_r = x_r0 + (jc.astype(jnp.float32) - R) + delta
    # reject refinements that ran to the search border (no clear minimum)
    refine_ok = (j >= 1) & (j <= 2 * R - 1)

    disparity = f.xy[:, 0] - x_r
    depth = bf / disparity.clip(1e-3)
    good = ok & f.valid & refine_ok & (disparity > 0.0) & (disparity < max_disp)
    return jnp.where(good, depth, 0.0)
